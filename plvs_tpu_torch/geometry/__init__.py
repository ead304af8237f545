"""Lie groups, camera models and triangulation (torch)."""

from . import cameras, lie, triangulation  # noqa: F401
