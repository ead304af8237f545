"""Feature extraction and matching (torch)."""

from . import fast, lines, matching, orb, pyramid  # noqa: F401
