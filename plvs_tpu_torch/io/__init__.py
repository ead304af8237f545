"""Synthetic RGB-D data and trajectory evaluation (numpy)."""

from . import evaluation, synthetic  # noqa: F401
