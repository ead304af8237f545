"""Robust kernels, the pose-only solver and bundle adjustment (torch)."""

from . import ba, pose_opt, robust  # noqa: F401
