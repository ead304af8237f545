"""Robust kernels and the pose-only solver (torch)."""

from . import pose_opt, robust  # noqa: F401
