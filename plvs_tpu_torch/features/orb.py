"""Batched ORB: IC-angle orientation + steered-BRIEF binary descriptors.

Counterpart of plvs_tpu/features/orb.py. The sampling pattern and angle
weights are regenerated here with numpy from the same seeds, so descriptor
bits agree with the JAX package's on equal patches. Descriptors are
``[N, 8]`` int32 tensors holding the uint32 bit patterns.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import fast as fast_mod
from . import pyramid as pyr_mod

PATCH = 41          # gathered patch size (odd); holds the rotated pattern
HALF = PATCH // 2
ANGLE_RADIUS = 15   # IC-angle circular window radius
N_BITS = 256
N_ANGLE_BINS = 30   # steering quantized to 2*pi/30, the ORB construction


def _make_pattern() -> np.ndarray:
    """[256, 2, 2] (pair, endpoint, (dx, dy)) seeded Gaussian BRIEF pattern."""
    rs = np.random.RandomState(8)
    pts = rs.normal(0.0, 31 / 5.0, size=(N_BITS, 2, 2))
    return np.clip(pts, -13, 13).astype(np.float32)


PATTERN = _make_pattern()


def _angle_weights():
    """Circular mask and coordinate grids for the IC-angle moments."""
    ys, xs = np.mgrid[-HALF: HALF + 1, -HALF: HALF + 1]
    mask = (xs ** 2 + ys ** 2) <= ANGLE_RADIUS ** 2
    return (mask.astype(np.float32), xs.astype(np.float32),
            ys.astype(np.float32))


_MASK, _XS, _YS = _angle_weights()


def _make_sampling_matrix() -> np.ndarray:
    """[PATCH*PATCH, N_ANGLE_BINS * 2*N_BITS] bilinear sampling matrix:
    column (b, k) holds the 4 bilinear weights of the k-th rotated pattern
    endpoint at steering bin b."""
    n_cols = N_ANGLE_BINS * 2 * N_BITS
    S = np.zeros((PATCH * PATCH, n_cols), np.float32)
    pat = PATTERN.reshape(-1, 2)
    for b in range(N_ANGLE_BINS):
        a = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = np.clip(ca * pat[:, 0] - sa * pat[:, 1] + HALF, 0.0, PATCH - 1.001)
        ry = np.clip(sa * pat[:, 0] + ca * pat[:, 1] + HALF, 0.0, PATCH - 1.001)
        x0 = np.floor(rx).astype(np.int64)
        y0 = np.floor(ry).astype(np.int64)
        fx = (rx - x0).astype(np.float32)
        fy = (ry - y0).astype(np.float32)
        col = b * 2 * N_BITS + np.arange(2 * N_BITS)
        S[y0 * PATCH + x0, col] += (1 - fx) * (1 - fy)
        S[y0 * PATCH + x0 + 1, col] += fx * (1 - fy)
        S[(y0 + 1) * PATCH + x0, col] += (1 - fx) * fy
        S[(y0 + 1) * PATCH + x0 + 1, col] += fx * fy
    return S


@functools.lru_cache(maxsize=None)
def _sampling(device: torch.device):
    """(rows, S) on ``device``: the sampling matrix with the patch pixels no
    steering bin touches pruned away (built once per device)."""
    S = _make_sampling_matrix()
    rows = np.nonzero(S.any(axis=1))[0]
    return (torch.from_numpy(rows).to(device),
            torch.from_numpy(np.ascontiguousarray(S[rows])).to(device))


@functools.lru_cache(maxsize=None)
def _angle_tensors(device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in (_MASK, _XS, _YS))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] bool -> [..., 8] int32 words (bit j of word w is
    bits[32 w + j]), the uint32 packing of the JAX package."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int64)
             << shifts).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def extract_patches_stack(stack: torch.Tensor, lvl: torch.Tensor,
                          xy: torch.Tensor, patch: int = PATCH) -> torch.Tensor:
    """Gather [N, patch, patch] windows centred at the integer part of xy
    from an edge-padded [L, H, W] stack; ``lvl`` picks the level."""
    half = patch // 2
    padded = F.pad(stack[None], (half, half, half, half), mode="replicate")[0]
    x0 = torch.clamp(xy[:, 0].to(torch.int64), 0, stack.shape[2] - 1)
    y0 = torch.clamp(xy[:, 1].to(torch.int64), 0, stack.shape[1] - 1)
    off = torch.arange(patch, device=stack.device)
    ys = (y0[:, None] + off)[:, :, None]
    xs = (x0[:, None] + off)[:, None, :]
    return padded[lvl.to(torch.int64)[:, None, None], ys, xs]


def ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation per patch: atan2(m01, m10)."""
    mask, xs, ys = _angle_tensors(patches.device)
    m10 = (patches * xs * mask).sum((-2, -1))
    m01 = (patches * ys * mask).sum((-2, -1))
    return torch.atan2(m01, m10)


def descriptors(patches_blurred: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """[N, P, P] blurred patches + [N] angles -> [N, 8] int32 words: all 30
    steering bins sampled by one float32 matmul, then each keypoint's bin
    selected."""
    n = patches_blurred.shape[0]
    rows, S = _sampling(patches_blurred.device)
    flat = patches_blurred.reshape(n, -1)[:, rows]
    v = (flat @ S).reshape(n, N_ANGLE_BINS, N_BITS, 2)
    bits_all = v[..., 0] < v[..., 1]                       # [N, 30, 256]
    step = 2.0 * np.pi / N_ANGLE_BINS
    bin_idx = torch.remainder(torch.round(angles / step),
                              N_ANGLE_BINS).to(torch.int64)
    bits = torch.gather(
        bits_all, 1, bin_idx[:, None, None].expand(n, 1, N_BITS))[:, 0]
    return pack_bits(bits)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set for one frame (SoA, padded + masked)."""

    xy: torch.Tensor        # [N, 2] pixel coords at level-0 scale (x, y)
    response: torch.Tensor  # [N]
    angle: torch.Tensor     # [N] radians
    octave: torch.Tensor    # [N] int32 pyramid level
    desc: torch.Tensor      # [N, 8] int32 (uint32 bit patterns)
    mask: torch.Tensor      # [N] bool


def features_per_level(num_features: int, n_levels: int, scale: float):
    """Geometric allocation of the feature budget over levels."""
    inv = 1.0 / scale
    first = num_features * (1 - inv) / (1 - inv ** n_levels)
    per = [int(round(first * inv ** lv)) for lv in range(n_levels)]
    per[-1] = max(0, num_features - sum(per[:-1]))
    return per


def extract(img: torch.Tensor, num_features: int = 1024, n_levels: int = 8,
            scale: float = 1.2, threshold_hi: float = 20.0,
            threshold_lo: float = 7.0, cell: int = 16) -> Keypoints:
    """Multi-scale ORB extraction on a [H, W] float32 image, all levels
    batched on an edge-padded [L, H, W] stack."""
    per = features_per_level(num_features, n_levels, scale)
    shapes = pyr_mod.level_shapes(img.shape[0], img.shape[1], n_levels, scale)
    cells = [max(8, min(cell, int(np.sqrt(h_l * w_l / max(n_l, 1)))))
             for (h_l, w_l), n_l in zip(shapes, per)]
    active = [lv for lv in range(n_levels) if per[lv] > 0]
    if not active or len({cells[lv] for lv in active}) != 1:
        raise NotImplementedError(
            "per-level uniformity cells differ for this image size / budget: "
            "the JAX package's per-level extraction path is not ported")
    return _extract_batched(img, per, shapes, n_levels, scale, threshold_hi,
                            threshold_lo, cells[active[0]])


def _extract_batched(img, per, shapes, n_levels, scale, threshold_hi,
                     threshold_lo, cell):
    dev = img.device
    stack = pyr_mod.build_pyramid_stack(img, n_levels, scale)
    xyL, scoreL, validL = fast_mod.detect_batched(
        stack, shapes, [max(n, 1) for n in per], threshold_hi, threshold_lo,
        border=HALF + 1, cell=cell)
    xy_l, sc_l, va_l, lv_l, s_l = [], [], [], [], []
    for lv in range(n_levels):
        n_l = per[lv]
        if n_l <= 0:
            continue
        xy_l.append(xyL[lv, :n_l])
        sc_l.append(scoreL[lv, :n_l])
        va_l.append(validL[lv, :n_l])
        lv_l.append(np.full((n_l,), lv, np.int32))
        s_l.append(np.full((n_l,), scale ** lv, np.float32))
    xy = torch.cat(xy_l)
    lvl = torch.from_numpy(np.concatenate(lv_l)).to(dev)
    blurred = pyr_mod.gaussian_blur_batched(stack)
    bpatches = extract_patches_stack(blurred, lvl, xy)
    # IC angle from the blurred patch (one gather feeds both, as in JAX)
    ang = ic_angle(bpatches)
    d = descriptors(bpatches, ang)
    s = torch.from_numpy(np.concatenate(s_l)).to(dev)
    return Keypoints(xy=xy * s[:, None], response=torch.cat(sc_l), angle=ang,
                     octave=lvl, desc=d, mask=torch.cat(va_l))


def inv_scale_sigma2(octave: torch.Tensor, scale: float = 1.2) -> torch.Tensor:
    return scale ** (-2.0 * octave.to(torch.float32))
