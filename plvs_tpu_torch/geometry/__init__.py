"""Lie groups and camera models (torch)."""

from . import cameras, lie  # noqa: F401
