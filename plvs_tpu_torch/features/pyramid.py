"""Image pyramid + separable Gaussian blur (batched, static shapes).

Counterpart of plvs_tpu/features/pyramid.py. The JAX package builds each
level with ``jax.image.resize(method="linear", antialias=True)``, which is
not the resampler of ``F.interpolate(..., antialias=True)``. The port
rebuilds the same per-axis [out, in] weight matrices on the host with numpy
— JAX's ``scale_and_translate`` triangle-kernel formula, copied in
:func:`_resize_weights` — and applies them as two matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def level_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static [H_l, W_l] for each pyramid level."""
    shapes = []
    for lv in range(n_levels):
        s = scale ** lv
        shapes.append((max(16, int(round(height / s))),
                       max(16, int(round(width / s)))))
    return shapes


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 resampling matrix of a linear (triangle) kernel
    with antialiasing, in float32 as JAX's compute_weight_mat evaluates it
    (scale = n_out / n_in, translation 0)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))  # Python-float scale, as in JAX
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.5)).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    return np.ascontiguousarray(w.T)


def resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """[H, W] -> shape with JAX's linear antialiased resampler."""
    h, w = img.shape
    oh, ow = shape
    out = img
    if oh != h:
        wy = torch.from_numpy(_resize_weights(h, oh)).to(img.device)
        out = wy @ out
    if ow != w:
        wx = torch.from_numpy(_resize_weights(w, ow)).to(img.device)
        out = out @ wx.T
    return out


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale: float = 1.2):
    """[H, W] float32 image -> list of n_levels tensors (cascaded, like the
    reference: each level resamples the previous one)."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = [img]
    for lv in range(1, n_levels):
        levels.append(resize_linear(levels[-1], shapes[lv]))
    return levels


def build_pyramid_stack(img: torch.Tensor, n_levels: int = 8,
                        scale: float = 1.2) -> torch.Tensor:
    """Pyramid as one [L, H, W] tensor, levels edge-padded to level-0 size
    (the pad region is masked out by detection)."""
    levels = build_pyramid(img, n_levels, scale)
    h0, w0 = levels[0].shape
    padded = [
        lv if lv.shape == (h0, w0)
        else F.pad(lv[None, None], (0, w0 - lv.shape[1], 0, h0 - lv.shape[0]),
                   mode="replicate")[0, 0]
        for lv in levels
    ]
    return torch.stack(padded)


def _blur_axis(x: torch.Tensor, k, axis: int, radius: int) -> torch.Tensor:
    """1-D blur along ``axis`` as weighted shifted slices of a reflect-padded
    copy (the JAX package's summation order)."""
    n = x.shape[axis]
    idx = torch.arange(-radius, n + radius, device=x.device).abs()
    idx = torch.where(idx >= n, 2 * (n - 1) - idx, idx)  # reflect
    xp = x.index_select(axis, idx)
    acc = k[0] * xp.narrow(axis, 0, n)
    for i in range(1, 2 * radius + 1):
        acc = acc + k[i] * xp.narrow(axis, i, n)
    return acc


def gaussian_blur_batched(stack: torch.Tensor, sigma: float = 2.0,
                          radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur on an [L, H, W] stack (reflect padding)."""
    k = [float(v) for v in gaussian_kernel1d(sigma, radius)]
    return _blur_axis(_blur_axis(stack, k, 1, radius), k, 2, radius)
