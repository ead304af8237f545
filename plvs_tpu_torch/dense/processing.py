"""Depth-image processing: filtering, normals, geometric segmentation.

Counterpart of plvs_tpu/dense/processing.py. Every stage is a dense image
operation with the JAX package's wrap-around neighbours. The segmentation
cuts 4-neighbour edges where the surface is concave or has a depth gap,
then labels the components with a min-label flood fill run for a fixed
``h + w`` iterations, as the JAX package runs it (not to convergence: the
result is the JAX package's, capped fill included). The fill is plain
PyTorch on every device, as its JAX counterpart is plain ``jnp``: twelve
elementwise launches an iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import cameras as cam_mod
from ..utils import depth_model

UNLABELED = 1 << 30  # init label of invalid pixels (never propagated)


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


def normals_from_points(pts: torch.Tensor, step: int = 1) -> torch.Tensor:
    """Cross-product normals from grid neighbours: points [H, W, 3] -> unit
    normals [H, W, 3] oriented toward the camera (n . p < 0)."""
    dx = torch.roll(pts, -step, 1) - torch.roll(pts, step, 1)
    dy = torch.roll(pts, -step, 0) - torch.roll(pts, step, 0)
    n = torch.linalg.cross(dy, dx, dim=-1)
    nn = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)
    flip = (nn * pts).sum(-1, keepdim=True) > 0
    return torch.where(flip, -nn, nn)


def _propagate_labels(labels: torch.Tensor, connect: torch.Tensor,
                      n_iters: int) -> torch.Tensor:
    """Min-label flood fill for exactly ``n_iters`` iterations: labels
    [H, W] int32, connect [4, H, W] bool links to the (up, down, left,
    right) neighbour."""
    lab = labels
    for _ in range(n_iters):
        up = torch.roll(lab, 1, 0)
        dn = torch.roll(lab, -1, 0)
        lf = torch.roll(lab, 1, 1)
        rt = torch.roll(lab, -1, 1)
        m = lab
        m = torch.minimum(m, torch.where(connect[0], up, m))
        m = torch.minimum(m, torch.where(connect[1], dn, m))
        m = torch.minimum(m, torch.where(connect[2], lf, m))
        m = torch.minimum(m, torch.where(connect[3], rt, m))
        lab = m
    return lab


def segment_connectivity(cam: cam_mod.Camera, depth: torch.Tensor,
                         min_convexity: float = -0.02, max_gap: float = 0.03,
                         use_sigma_z: bool = True):
    """The edge stage of :func:`segment_depth`: (connect [4, H, W] bool with
    the image borders severed, normals [H, W, 3], valid [H, W])."""
    h, w = depth.shape
    pts = backproject_image(cam, depth)
    nrm = normals_from_points(pts)
    valid = depth > 0
    if use_sigma_z:
        # range-adaptive gap tolerance: depth noise grows with z
        weight = torch.clamp(depth_model.sigma_z_min_over_sigma_z(depth),
                             min=0.2)
        gap_tol = torch.full_like(depth, max_gap) / weight
    else:
        gap_tol = torch.full_like(depth, max_gap)

    def edge_ok(sy, sx):
        p2 = torch.roll(pts, (sy, sx), (0, 1))
        n2 = torch.roll(nrm, (sy, sx), (0, 1))
        v2 = torch.roll(valid, (sy, sx), (0, 1))
        dp = p2 - pts
        gap = torch.linalg.norm(dp, dim=-1)
        dirn = dp / (gap[..., None] + 1e-12)
        fi = (nrm * dirn).sum(-1)
        smooth = (nrm * n2).sum(-1) > 0.92
        return valid & v2 & (gap < gap_tol) & ((fi > min_convexity) | smooth)

    connect = torch.stack([edge_ok(1, 0), edge_ok(-1, 0), edge_ok(0, 1),
                           edge_ok(0, -1)])
    # roll wraps around: sever the image borders
    connect[0, 0, :] = False
    connect[1, h - 1, :] = False
    connect[2, :, 0] = False
    connect[3, :, w - 1] = False
    return connect, nrm, valid


def label_components(connect: torch.Tensor, valid: torch.Tensor,
                     n_iters: int | None = None,
                     min_area: int = 50) -> torch.Tensor:
    """The labelling stage of :func:`segment_depth`: the capped min-label
    fill from each valid pixel's 1-based index, then the area threshold.
    int32 labels [H, W], 0 = invalid or too small."""
    h, w = valid.shape
    if n_iters is None:
        n_iters = h + w
    dev = valid.device
    init = torch.arange(h * w, dtype=torch.int32, device=dev).reshape(h, w) + 1
    init = torch.where(valid, init, torch.full_like(init, UNLABELED))
    labels = _propagate_labels(init, connect, n_iters)
    labels = torch.where(valid, labels, torch.zeros_like(labels))
    flat = torch.clamp(labels.reshape(-1), 0, h * w).to(torch.int64)
    counts = torch.zeros(h * w + 1, dtype=torch.int32, device=dev)
    counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    big = (counts[flat] >= min_area).reshape(h, w)
    return torch.where(big & (labels > 0), labels, torch.zeros_like(labels))


def segment_depth(cam: cam_mod.Camera, depth: torch.Tensor,
                  min_convexity: float = -0.02, max_gap: float = 0.03,
                  n_iters: int | None = None, min_area: int = 50,
                  use_sigma_z: bool = True):
    """Geometric segmentation of a depth image into smooth / convex regions:
    (int32 labels [H, W], 0 = invalid or too small, normals [H, W, 3])."""
    connect, nrm, valid = segment_connectivity(cam, depth, min_convexity,
                                               max_gap, use_sigma_z)
    return label_components(connect, valid, n_iters, min_area), nrm


def relabel_compact(labels: np.ndarray):
    """Host side: sparse label ids -> 1..L in increasing order (0 stays
    0); returns (labels, L)."""
    uniq = np.unique(labels)
    uniq = uniq[uniq > 0]
    out = np.where(labels > 0, np.searchsorted(uniq, labels) + 1, 0)
    return out.astype(labels.dtype), len(uniq)
