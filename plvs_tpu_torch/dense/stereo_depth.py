"""Dense rectified-stereo disparity: census cost, box aggregation, WTA.

Counterpart of plvs_tpu/dense/stereo_depth.py for the box method:
``census_transform`` (5x5 census, wrap-around at the borders as in JAX),
the fused cost-aggregation + winner-take-all step (kernel K3,
``ops/stereo.py``: the CUDA kernel for CUDA tensors, its plain version for
CPU tensors) and the 3x3 median post-filter, which stays plain PyTorch as
the JAX package keeps it outside its kernel.

K3 has the TPU kernel's border semantics, not those of the JAX package's
jnp volume path (which the JAX package runs on the CPU): a sparse set of
image-border pixels can flip validity between the two (ROADMAP.md queue 3,
"Stereo borders").
"""

from __future__ import annotations

import torch

from ..ops import stereo as stereo_ops


def census_transform(img: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Census bit-string per pixel, packed into int32 words (the bit
    patterns of the JAX package's uint32); window=2 -> 5x5 -> 24 bits."""
    out = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    i = 0
    for dy in range(-window, window + 1):
        for dx in range(-window, window + 1):
            if (dy == 0 and dx == 0) or i >= 32:
                continue
            shifted = torch.roll(img, (-dy, -dx), (0, 1))
            out = out | ((shifted < img).to(torch.int32) << i)
            i += 1
    return out


def _median3(disp: torch.Tensor) -> torch.Tensor:
    """3x3 median (wrap-around neighbours) applied to valid pixels only."""
    neigh = torch.stack([torch.roll(disp, (dy, dx), (0, 1))
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    med = neigh.median(dim=0).values   # 9 values: the exact middle one
    return torch.where(disp > 0, med, disp)


def disparity(left: torch.Tensor, right: torch.Tensor, max_disp: int = 64,
              census_window: int = 2, agg_radius: int = 3,
              lr_thresh: float = 1.5, uniqueness: float = 0.95,
              method: str = "box", p1: float = 7.0,
              p2: float = 100.0) -> torch.Tensor:
    """Rectified pair [H, W] float32 -> float disparity map (<= 0 invalid)."""
    if method == "sgm":
        raise NotImplementedError(
            "method='sgm' (semi-global aggregation) is not in the ported "
            "slice; ROADMAP.md queue 1 item 6 ports it")
    if method != "box":
        raise ValueError(f"unknown disparity method {method!r}")
    cl = census_transform(left, census_window)
    cr = census_transform(right, census_window)
    disp = stereo_ops.disparity_wta(cl, cr, max_disp=max_disp,
                                    agg_radius=agg_radius,
                                    uniqueness=uniqueness,
                                    lr_thresh=lr_thresh)
    return _median3(disp)


def disparity_to_depth(disp: torch.Tensor, bf: float) -> torch.Tensor:
    """depth = bf / disparity where the disparity is positive, else 0
    (a float32 division, as in JAX; ``float / tensor`` in PyTorch would
    multiply by a rounded reciprocal)."""
    bf_t = torch.full_like(disp, bf)
    return torch.where(disp > 0, bf_t / torch.clamp(disp, min=1e-6),
                       torch.zeros_like(disp))
