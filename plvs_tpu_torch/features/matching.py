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

from ..geometry import lie
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
    """Best and second-best distance + best index along the last axis
    (any leading batch axes)."""
    d = torch.where(valid, dist, INF)
    best_idx = torch.argmin(d, dim=-1)
    best = d.gather(-1, best_idx[..., None])[..., 0]
    second = d.scatter(-1, best_idx[..., None], INF).amin(dim=-1)
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
    return match_nn_ratio_dist(hamming(desc_q, desc_k), mask_q, mask_k,
                               max_dist, ratio, cand_mask, mutual)


def match_nn_ratio_dist(dist, mask_q, mask_k, max_dist: int = TH_LOW,
                        ratio: float = 0.75, cand_mask=None,
                        mutual: bool = True):
    """:func:`match_nn_ratio` on a given [..., Q, K] distance matrix (any
    leading batch axes; masks [..., Q] and [..., K])."""
    valid = mask_q[..., :, None] & mask_k[..., None, :]
    if cand_mask is not None:
        valid = valid & cand_mask
    best, second, idx = _masked_best2(dist, valid)
    ok = (best <= max_dist) & (best.float() <= ratio * second.float())
    if mutual:
        _, _, idxT = _masked_best2(dist.transpose(-1, -2),
                                   valid.transpose(-1, -2))
        ok = ok & (idxT.gather(-1, idx) == torch.arange(
            dist.shape[-2], device=idx.device))
    return torch.where(ok, idx, -1), best


def search_by_projection(proj_uv, proj_valid, map_desc, map_octave, kp_xy,
                         kp_desc, kp_octave, kp_mask, radius,
                         max_dist: int = TH_HIGH, ratio: float = 0.9,
                         octave_tol: int = 1, kp_angle=None, map_angle=None,
                         check_rotation: bool = False):
    """Guided search: match projected map features to frame keypoints inside
    a pixel window with compatible octaves. ``radius`` is a scalar or [Q].
    Returns (match_idx [Q] (-1 = none), match_dist [Q])."""
    return search_by_projection_dist(
        hamming(map_desc, kp_desc), proj_uv, proj_valid, map_octave, kp_xy,
        kp_octave, kp_mask, radius, max_dist, ratio, octave_tol, kp_angle,
        map_angle, check_rotation)


def search_by_projection_dist(dist, proj_uv, proj_valid, map_octave, kp_xy,
                              kp_octave, kp_mask, radius,
                              max_dist: int = TH_HIGH, ratio: float = 0.9,
                              octave_tol: int = 1, kp_angle=None,
                              map_angle=None, check_rotation: bool = False):
    """:func:`search_by_projection` on a given [..., Q, K] descriptor
    distance matrix (any leading batch axes on every per-query and
    per-keypoint argument)."""
    d2 = ((proj_uv[..., :, None, :] - kp_xy[..., None, :, :]) ** 2).sum(-1)
    r = torch.as_tensor(radius, dtype=torch.float32, device=proj_uv.device)
    r = r.expand(proj_uv.shape[:-1])
    window = d2 <= (r[..., None] ** 2)
    oct_ok = (kp_octave[..., None, :]
              - map_octave[..., :, None]).abs() <= octave_tol
    cand = (window & oct_ok & proj_valid[..., :, None]
            & kp_mask[..., None, :])
    best, second, idx = _masked_best2(dist, cand)
    ok = (best <= max_dist) & (best.float() <= ratio * second.float())
    ok = ok & _unique_target(idx, best, ok, kp_xy.shape[-2])
    if check_rotation and kp_angle is not None and map_angle is not None:
        ok = rotation_consistency(map_angle - kp_angle[idx], ok)
    return torch.where(ok, idx, -1), best


def _unique_target(idx, dist, ok, n_targets: int):
    """Among queries matched to the same target keep the smallest distance,
    ties to the first query (per batch row when idx has leading axes)."""
    dev = idx.device
    shape = idx.shape
    if idx.dim() > 1:
        # disjoint target ranges per batch row; queries keep their order
        off = torch.arange(idx[..., 0].numel(), device=dev) * n_targets
        idx = (idx + off.reshape(shape[:-1] + (1,))).reshape(-1)
        dist, ok = dist.reshape(-1), ok.reshape(-1)
        n_targets = n_targets * off.numel()
    d = torch.where(ok, dist, INF)
    best_per_tgt = torch.full((n_targets,), INF, dtype=d.dtype, device=dev)
    best_per_tgt.scatter_reduce_(0, idx, d, reduce="amin")
    is_best = d <= best_per_tgt[idx]
    q = torch.arange(idx.shape[0], device=dev)
    big = 1 << 30
    qq = torch.where(is_best & ok, q, big)
    first_q = torch.full((n_targets,), big, dtype=q.dtype, device=dev)
    first_q.scatter_reduce_(0, idx, qq, reduce="amin")
    return (ok & is_best & (first_q[idx] == q)).reshape(shape)


def search_for_initialization(kp0_xy, kp0_desc, kp0_mask, kp1_xy, kp1_desc,
                              kp1_mask, window: float = 100.0,
                              max_dist: int = TH_LOW, ratio: float = 0.9):
    """Wide-window matching between the first two monocular frames: a
    match must lie within ``window`` px of the keypoint's position."""
    d2 = ((kp0_xy[:, None, :] - kp1_xy[None, :, :]) ** 2).sum(-1)
    cand = d2 <= window * window
    return match_nn_ratio(kp0_desc, kp1_desc, kp0_mask, kp1_mask, max_dist,
                          ratio, cand_mask=cand)


def search_for_triangulation(desc1, mask1, rays1, desc2, mask2, rays2, R12,
                             t12, epi_thresh: float = 2e-3,
                             max_dist: int = TH_LOW, ratio: float = 0.85):
    """Epipolar-gated matching between two keyframes for new points: rays
    [N, 3] unit-depth bearings, x1 = R12 x2 + t12; a pair passes when ray1
    lies within ``epi_thresh`` of ray2's epipolar line."""
    E = lie.hat(t12) @ R12
    l1 = rays2 @ E.T                                   # [N2, 3]
    num = (rays1 @ l1.T).abs()                         # [N1, N2]
    den = torch.sqrt(l1[:, 0] ** 2 + l1[:, 1] ** 2)[None, :] + 1e-12
    epi_ok = (num / den) < epi_thresh
    return match_nn_ratio(desc1, desc2, mask1, mask2, max_dist, ratio,
                          cand_mask=epi_ok)
