"""Dense FAST-16 corner scoring + NMS + grid-uniform selection.

Counterpart of plvs_tpu/features/fast.py. The segment test runs for every
pixel at once (16 rolled copies), NMS is a max-pool compare, and spatial
uniformity comes from a per-cell argmax and a global top-k over cells.

:func:`detect` takes one pyramid level, :func:`detect_batched` every
level of an edge-padded stack at once.

``lax.top_k`` breaks ties toward the lower index and FAST scores tie
often; ``torch.topk`` promises no tie order, so the port ranks with a
stable descending sort and takes the first k (:func:`top_k`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# FAST-16 Bresenham circle offsets (dy, dx), radius 3, clockwise from top.
CIRCLE = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    dtype=np.int32)

ARC_LEN = 9  # FAST-9/16 segment test


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    ties broken toward the lower index (``lax.top_k``'s order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _arc16(bits: torch.Tensor) -> torch.Tensor:
    """True where the 16-bit circle mask (int32) has >= ARC_LEN consecutive
    set bits, cyclically (the mask is duplicated into the high half; the
    values stay below 2^32, so int64 shifts are exact)."""
    mm = bits.to(torch.int64)
    mm = mm | (mm << 16)
    r = mm
    for i in range(1, ARC_LEN):
        r = r & (mm >> i)
    return (r & 0xFFFF) != 0


def fast_score2(img: torch.Tensor, t_lo: float, t_hi: float):
    """FAST-9/16 scores at both thresholds in one pass over the circle, on
    [..., H, W] (rolls over the last two axes). Returns (s_lo, s_hi)."""
    acc_b = torch.zeros_like(img)
    acc_d = torch.zeros_like(img)
    zero = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    b_lo, d_lo, b_hi, d_hi = zero, zero, zero, zero
    for i, (dy, dx) in enumerate(CIRCLE):
        d = torch.roll(img, (-int(dy), -int(dx)), (-2, -1)) - img
        acc_b = acc_b + torch.clamp(d - t_lo, min=0.0)
        acc_d = acc_d + torch.clamp(-d - t_lo, min=0.0)
        b_lo = b_lo | ((d > t_lo).to(torch.int32) << i)
        d_lo = d_lo | ((d < -t_lo).to(torch.int32) << i)
        b_hi = b_hi | ((d > t_hi).to(torch.int32) << i)
        d_hi = d_hi | ((d < -t_hi).to(torch.int32) << i)
    score = torch.maximum(acc_b, acc_d)
    corner_lo = _arc16(b_lo) | _arc16(d_lo)
    corner_hi = _arc16(b_hi) | _arc16(d_hi)
    s_lo = torch.where(corner_lo, score, 0.0)
    return s_lo, torch.where(corner_hi, s_lo, 0.0)


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression over the last two axes (keep local maxima;
    the window pads with -inf like reduce_window SAME)."""
    shp = score.shape
    x = score.reshape(-1, 1, shp[-2], shp[-1])
    m = F.max_pool2d(x, 3, stride=1, padding=1).reshape(shp)
    return torch.where(score >= m, score, 0.0)


def _cell_max_mask(score: torch.Tensor, cell: int) -> torch.Tensor:
    """Keep only the per-cell maximum of an [H, W] score (cell grid)."""
    h, w = score.shape
    x = F.pad(score[None, None], (0, (-w) % cell, 0, (-h) % cell),
              value=-float("inf"))
    m = F.max_pool2d(x, cell, stride=cell)[0, 0]
    up = m.repeat_interleave(cell, 0).repeat_interleave(cell, 1)[:h, :w]
    return torch.where((score >= up) & (score > 0), score, 0.0)


def _select_cells(sel: torch.Tensor, cell: int, kmax: int):
    """Per-cell winner of an [L, H, W] rank map, then the ``kmax`` best
    cells per level. Returns (xy [L, k, 2], top [L, k]), k <= kmax."""
    L, H, W = sel.shape
    selp = F.pad(sel, (0, (-W) % cell, 0, (-H) % cell))
    hc, wc = selp.shape[1] // cell, selp.shape[2] // cell
    cells = selp.reshape(L, hc, cell, wc, cell).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(L, hc * wc, cell * cell)
    cell_best = cells.amax(dim=-1)
    cell_arg = torch.argmax(cells, dim=-1)  # first maximum, as jnp.argmax
    k = min(kmax, cell_best.shape[1])
    top, cidx = top_k(cell_best, k)
    off = torch.gather(cell_arg, 1, cidx)
    cy = torch.div(cidx, wc, rounding_mode="floor")
    cx = cidx % wc
    yy = (cy * cell + torch.div(off, cell, rounding_mode="floor")).float()
    xx = (cx * cell + off % cell).float()
    return torch.stack([xx, yy], -1), top


def _finish(xy, top, kmax: int, big: float):
    """(xy, score, valid) padded to ``kmax`` rows per level."""
    L, k = top.shape
    valid = top > 0
    score = torch.where(top > big / 2, top - big, top)
    if k < kmax:
        pad = kmax - k
        xy = torch.cat([xy, xy.new_zeros((L, pad, 2))], 1)
        score = torch.cat([score, score.new_zeros((L, pad))], 1)
        valid = torch.cat([valid, valid.new_zeros((L, pad))], 1)
    return xy, score, valid


def detect(img: torch.Tensor, num_features: int, threshold_hi: float = 20.0,
           threshold_lo: float = 7.0, border: int = 16, cell: int = 16):
    """Up to ``num_features`` uniformly spread corners of one [H, W] level:
    hi-threshold corners win their cell, cells without one fall back to
    lo-threshold corners (ranked below every hi one). Returns (xy [N, 2]
    (x, y), score [N], valid [N])."""
    h, w = img.shape
    s_lo, s_hi = fast_score2(img, threshold_lo, threshold_hi)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    inb = (ys >= border) & (ys < h - border) & (xs >= border) \
        & (xs < w - border)
    s_hi = torch.where(inb, nms3(s_hi), 0.0)
    s_lo = torch.where(inb, nms3(s_lo), 0.0)
    BIG = 1e6
    sel = torch.where(s_hi > 0, s_hi + BIG, s_lo)
    xy, top = _select_cells(sel[None], cell, num_features)
    xy, score, valid = _finish(xy, top, num_features, BIG)
    return xy[0], score[0], valid[0]


def detect_batched(stack: torch.Tensor, shapes, num_features,
                   threshold_hi: float = 20.0, threshold_lo: float = 7.0,
                   border: int = 16, cell: int = 16):
    """All pyramid levels at once on an edge-padded [L, H, W] stack.
    Returns (xy [L, K, 2], score [L, K], valid [L, K]), K = max budget."""
    L, H, W = stack.shape
    dev = stack.device
    s_lo, s_hi = fast_score2(stack, threshold_lo, threshold_hi)

    inb = np.zeros((L, H, W), bool)
    for lv, (h_l, w_l) in enumerate(shapes):
        inb[lv, border:h_l - border, border:w_l - border] = True
    inb = torch.from_numpy(inb).to(dev)
    s_hi = torch.where(inb, nms3(s_hi), 0.0)
    s_lo = torch.where(inb, nms3(s_lo), 0.0)

    BIG = 1e6
    sel = torch.where(s_hi > 0, s_hi + BIG, s_lo)
    kmax = max(int(n) for n in num_features)
    xy, top = _select_cells(sel, cell, kmax)
    return _finish(xy, top, kmax, BIG)
