"""Depth-image processing: edge-preserving filtering and back-projection.

Counterpart of plvs_tpu/dense/processing.py's ``filter_depth`` and
``backproject_image``. The geometric segmentation (``segment_depth``) waits
for the segmentation item of ROADMAP.md queue 1.
"""

from __future__ import annotations

import torch

from ..geometry import cameras as cam_mod


def filter_depth(depth: torch.Tensor, ksize: int = 3,
                 sigma_r: float = 0.05) -> torch.Tensor:
    """Edge-preserving depth smoothing (bilateral in range, box in space;
    wrap-around neighbours as in JAX). Depth <= 0 is invalid."""
    r = ksize // 2
    num = torch.zeros_like(depth)
    den = torch.zeros_like(depth)
    valid = depth > 0
    two_s2 = torch.tensor(2 * sigma_r ** 2, dtype=depth.dtype,
                          device=depth.device)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            d = torch.roll(depth, (dy, dx), (0, 1))
            v = torch.roll(valid, (dy, dx), (0, 1))
            wr = torch.exp(-((d - depth) ** 2) / two_s2)
            w = torch.where(v & valid, wr, torch.zeros_like(wr))
            num = num + w * d
            den = den + w
    return torch.where(den > 0, num / torch.clamp(den, min=1e-9),
                       torch.zeros_like(num))


def backproject_image(cam: cam_mod.Camera, depth: torch.Tensor) -> torch.Tensor:
    """Depth image [H, W] -> camera-frame point image [H, W, 3]."""
    h, w = depth.shape
    ys, xs = torch.meshgrid(torch.arange(h, device=depth.device),
                            torch.arange(w, device=depth.device),
                            indexing="ij")
    uv = torch.stack([xs, ys], -1).to(torch.float32).reshape(-1, 2)
    rays = cam_mod.unproject(cam, uv).reshape(h, w, 3)
    return rays * depth[..., None]
