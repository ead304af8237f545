"""Batched binary-descriptor matching (Hamming) with geometric gating.

Counterpart of plvs_tpu/features/matching.py. Every matcher reduces to one
masked [Q, K] Hamming matrix (kernel K1, ``ops/hamming.py``) followed by
argmin reductions. ``torch.argmin`` returns the first minimum like
``jnp.argmin``; the rotation histogram's top-3 uses the stable-sort rule of
``fast.top_k``.
"""

from __future__ import annotations

import math

import torch

from ..ops import hamming as hamming_ops
from .fast import top_k

TH_HIGH = 100  # max Hamming distance for a usable match (reference value)
TH_LOW = 50    # strict threshold (reference value)
HISTO_BINS = 30
INF = 10_000


def hamming(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[Q, 8] x [K, 8] int32 words -> [Q, K] int32 Hamming distances."""
    return hamming_ops.hamming_matrix(d1, d2)


def hamming_pairs(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """Row-wise distance of aligned pairs [N, 8] x [N, 8] -> [N]."""
    x = (d1.to(torch.int64) ^ d2.to(torch.int64)) & 0xFFFFFFFF
    pop = hamming_ops._POP8.to(d1.device)
    out = torch.zeros(d1.shape[0], dtype=torch.int32, device=d1.device)
    for s in (0, 8, 16, 24):
        out += pop[(x >> s) & 0xFF].sum(-1, dtype=torch.int32)
    return out


def _masked_best2(dist: torch.Tensor, valid: torch.Tensor):
    """Best and second-best distance + best index along axis 1."""
    d = torch.where(valid, dist, INF)
    best_idx = torch.argmin(d, dim=1)
    rows = torch.arange(d.shape[0], device=d.device)
    best = d[rows, best_idx]
    d2 = d.clone()
    d2[rows, best_idx] = INF
    second = d2.amin(dim=1)
    return best, second, best_idx


def rotation_consistency(dtheta: torch.Tensor, match_ok: torch.Tensor,
                         n_bins: int = HISTO_BINS, keep: int = 3) -> torch.Tensor:
    """Keep matches whose orientation difference falls in the ``keep`` most
    populated histogram bins (bins under 10% of the best are dropped)."""
    two_pi = 2.0 * math.pi
    frac = torch.remainder(dtheta, two_pi) / two_pi
    bins = torch.clamp((frac * n_bins).to(torch.int64), 0, n_bins - 1)
    hist = torch.zeros(n_bins, dtype=torch.int32, device=dtheta.device)
    hist.index_add_(0, bins, match_ok.to(torch.int32))
    top_vals, top_idx = top_k(hist, keep)
    ok_bin = torch.zeros(n_bins, dtype=torch.bool, device=dtheta.device)
    ok_bin[top_idx] = top_vals > torch.div(top_vals[0], 10,
                                           rounding_mode="floor")
    return match_ok & ok_bin[bins]


def match_nn_ratio(desc_q, desc_k, mask_q, mask_k, max_dist: int = TH_LOW,
                   ratio: float = 0.75, cand_mask=None, mutual: bool = True):
    """Nearest-neighbour matching with Lowe ratio + optional mutual check.
    Returns (match_idx [Q] int64 (-1 = none), match_dist [Q])."""
    dist = hamming(desc_q, desc_k)
    valid = mask_q[:, None] & mask_k[None, :]
    if cand_mask is not None:
        valid = valid & cand_mask
    best, second, idx = _masked_best2(dist, valid)
    ok = (best <= max_dist) & (best.float() <= ratio * second.float())
    if mutual:
        _, _, idxT = _masked_best2(dist.T, valid.T)
        ok = ok & (idxT[idx] == torch.arange(desc_q.shape[0],
                                             device=idx.device))
    return torch.where(ok, idx, -1), best


def search_by_projection(proj_uv, proj_valid, map_desc, map_octave, kp_xy,
                         kp_desc, kp_octave, kp_mask, radius,
                         max_dist: int = TH_HIGH, ratio: float = 0.9,
                         octave_tol: int = 1, kp_angle=None, map_angle=None,
                         check_rotation: bool = False):
    """Guided search: match projected map features to frame keypoints inside
    a pixel window with compatible octaves. ``radius`` is a scalar or [Q].
    Returns (match_idx [Q] (-1 = none), match_dist [Q])."""
    d2 = ((proj_uv[:, None, :] - kp_xy[None, :, :]) ** 2).sum(-1)
    r = torch.as_tensor(radius, dtype=torch.float32, device=proj_uv.device)
    r = r.expand(proj_uv.shape[:1])
    window = d2 <= (r[:, None] ** 2)
    oct_ok = (kp_octave[None, :] - map_octave[:, None]).abs() <= octave_tol
    cand = window & oct_ok & proj_valid[:, None] & kp_mask[None, :]

    dist = hamming(map_desc, kp_desc)
    best, second, idx = _masked_best2(dist, cand)
    ok = (best <= max_dist) & (best.float() <= ratio * second.float())
    ok = ok & _unique_target(idx, best, ok, kp_xy.shape[0])
    if check_rotation and kp_angle is not None and map_angle is not None:
        ok = rotation_consistency(map_angle - kp_angle[idx], ok)
    return torch.where(ok, idx, -1), best


def _unique_target(idx, dist, ok, n_targets: int):
    """Among queries matched to the same target keep the smallest distance,
    ties to the first query."""
    dev = idx.device
    d = torch.where(ok, dist, INF)
    best_per_tgt = torch.full((n_targets,), INF, dtype=d.dtype, device=dev)
    best_per_tgt.scatter_reduce_(0, idx, d, reduce="amin")
    is_best = d <= best_per_tgt[idx]
    q = torch.arange(idx.shape[0], device=dev)
    big = 1 << 30
    qq = torch.where(is_best & ok, q, big)
    first_q = torch.full((n_targets,), big, dtype=q.dtype, device=dev)
    first_q.scatter_reduce_(0, idx, qq, reduce="amin")
    return ok & is_best & (first_q[idx] == q)
