"""Batched line-segment detection + binary line-band descriptors (LBD).

Counterpart of plvs_tpu/features/lines.py: Sobel gradients -> edge mask ->
orientation-gated connected components on a half-resolution cell grid
(kernel K2, ``ops/cc_labels.py``) -> per-component moments -> PCA line fit
+ straightness filter, then collinear merging and LBD descriptors packed
into the same [L, 8] int32 words the Hamming matchers take.

Segment reductions become ``index_add_`` / ``scatter_reduce_``; the
top-``max_lines`` ranking of components by support count (ties are the
rule there) uses the stable-sort rule of ``fast.top_k``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import cc_labels as cc_ops
from .fast import top_k
from .orb import pack_bits

N_BANDS = 9
N_SAMPLES = 15
BAND_WIDTH = 7  # perpendicular offsets: -3..3


class KeyLines(NamedTuple):
    """Fixed-capacity line set (SoA, padded + masked)."""

    sp: torch.Tensor        # [L, 2] start point (x, y), level-0 scale
    ep: torch.Tensor        # [L, 2] end point
    angle: torch.Tensor     # [L] direction angle in [-pi/2, pi/2)
    response: torch.Tensor  # [L] support-pixel count
    octave: torch.Tensor    # [L] int32
    desc: torch.Tensor      # [L, 8] int32 (uint32 bit patterns)
    mask: torch.Tensor      # [L] bool


def round_to_index(x: torch.Tensor) -> torch.Tensor:
    """round(x) as int64 with XLA's float->int conversion (NaN -> 0,
    saturating), so padded lines with non-finite endpoints index like the
    JAX package's."""
    x = torch.nan_to_num(torch.round(x), nan=0.0, posinf=2.0 ** 31 - 1,
                         neginf=-2.0 ** 31)
    return x.clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(torch.int64)


def _sobel(img):
    r = torch.roll
    gx = (r(img, (-1, -1), (0, 1)) + 2 * r(img, (0, -1), (0, 1))
          + r(img, (1, -1), (0, 1))
          - r(img, (-1, 1), (0, 1)) - 2 * r(img, (0, 1), (0, 1))
          - r(img, (1, 1), (0, 1)))
    gy = (r(img, (-1, -1), (0, 1)) + 2 * r(img, (-1, 0), (0, 1))
          + r(img, (-1, 1), (0, 1))
          - r(img, (1, -1), (0, 1)) - 2 * r(img, (1, 0), (0, 1))
          - r(img, (1, 1), (0, 1)))
    return gx, gy


def _angle_diff_mod_pi(a, b):
    d = torch.remainder((a - b).abs(), math.pi)
    return torch.minimum(d, math.pi - d)


def connectivity_grid(img: torch.Tensor, grad_thresh: float = 40.0,
                      ori_tol: float = math.pi / 8):
    """The detector's half-resolution cell grid: (mag, edge, init, conn_bits)
    where ``init`` [H/2, W/2] int32 labels edge cells by index (others hold
    the sentinel H*W/4) and bit ci of ``conn_bits`` links a cell to its
    ``SHIFTS[ci]`` neighbour when both are coherent edge cells of similar
    orientation — the input of kernel K2."""
    h, w = img.shape
    dev = img.device
    gx, gy = _sobel(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    edge = mag > grad_thresh
    if h % 2 or w % 2:
        raise ValueError("line detector expects even dims")
    h2, w2 = h // 2, w // 2

    def pool(a):
        return a.reshape(h2, 2, w2, 2).sum((1, 3))

    # orientation pooling in double-angle space (orientations live mod pi)
    phi2 = 2.0 * torch.atan2(gy, gx)
    o2x = pool(mag * torch.cos(phi2))
    o2y = pool(mag * torch.sin(phi2))
    mag_h = pool(mag)
    edge_h = edge.reshape(h2, 2, w2, 2).any(3).any(1)
    ori_h = torch.remainder(0.5 * torch.atan2(o2y, o2x) + math.pi / 2, math.pi)
    # orientation coherence drops cells where two lines cross
    coh = torch.sqrt(o2x * o2x + o2y * o2y) / torch.clamp(mag_h, min=1e-6)
    edge_h = edge_h & (coh > 0.7)

    def conn(sy, sx):
        e2 = torch.roll(edge_h, (sy, sx), (0, 1))
        o2 = torch.roll(ori_h, (sy, sx), (0, 1))
        return edge_h & e2 & (_angle_diff_mod_pi(ori_h, o2) < 2.0 * ori_tol)

    connect = torch.stack([conn(sy, sx) for sy, sx in cc_ops.SHIFTS])
    connect[0, 0, :] = False
    connect[1, h2 - 1, :] = False
    connect[2, :, 0] = False
    connect[3, :, w2 - 1] = False
    connect[4, 0, :] = False
    connect[4, :, 0] = False
    connect[5, h2 - 1, :] = False
    connect[5, :, w2 - 1] = False
    connect[6, 0, :] = False
    connect[6, :, w2 - 1] = False
    connect[7, h2 - 1, :] = False
    connect[7, :, 0] = False

    n_cell = h2 * w2
    init = torch.where(
        edge_h, torch.arange(n_cell, dtype=torch.int32,
                             device=dev).reshape(h2, w2), n_cell)
    bit = torch.tensor([1 << ci for ci in range(8)], dtype=torch.int32,
                       device=dev)
    conn_bits = (connect.to(torch.int32) * bit[:, None, None]).sum(
        0, dtype=torch.int32)
    return mag, edge, init, conn_bits


def detect_lines(img: torch.Tensor, max_lines: int = 128,
                 grad_thresh: float = 40.0, min_length: float = 15.0,
                 ori_tol: float = math.pi / 8, straightness: float = 0.02,
                 n_iters: int | None = None) -> KeyLines:
    """Detect up to ``max_lines`` segments in a [H, W] grayscale image.

    Connectivity is decided on 2x2 cells (kernel K2 on CUDA tensors, its
    plain version with the reference's iteration cap on CPU tensors); the
    moments are pooled from the full-resolution support pixels."""
    h, w = img.shape
    dev = img.device
    mag, edge, init, conn_bits = connectivity_grid(img, grad_thresh, ori_tol)
    h2, w2 = h // 2, w // 2
    n_cell = h2 * w2
    if n_iters is None:
        n_iters = (h2 + w2) // 3
    labels_h = cc_ops.cc_min_labels(init, conn_bits,
                                    ref_max_chunks=-(-n_iters // 8))
    lab_c = labels_h.reshape(-1).to(torch.int64)

    def pool(a):
        return a.reshape(h2, 2, w2, 2).sum((1, 3))

    ys, xs = torch.meshgrid(torch.arange(h, device=dev, dtype=torch.float32),
                            torch.arange(w, device=dev, dtype=torch.float32),
                            indexing="ij")
    n_seg = n_cell + 1
    ones = edge.to(torch.float32)
    wgt = ones * mag

    def pool_sum(a):
        return pool(a).reshape(-1)

    cnt_all = torch.zeros(n_seg, dtype=torch.float32, device=dev)
    cnt_all.index_add_(0, lab_c, pool_sum(ones))
    top_cnt, top_lab = top_k(cnt_all[:n_cell], max_lines)

    eq = lab_c[None, :] == top_lab[:, None]               # [K, n_cell]
    payload = torch.stack(
        [pool_sum(wgt), pool_sum(xs * wgt), pool_sum(ys * wgt),
         pool_sum(xs * xs * wgt), pool_sum(ys * ys * wgt),
         pool_sum(xs * ys * wgt)], -1)
    sums = eq.to(torch.float32) @ payload                 # [K, 6]
    wsum, sx_, sy_, sxx, syy, sxy = sums.unbind(-1)
    c = torch.clamp(wsum, min=1e-6)
    cx = sx_ / c
    cy = sy_ / c
    vxx = sxx / c - cx * cx
    vyy = syy / c - cy * cy
    vxy = sxy / c - cx * cy
    theta = 0.5 * torch.atan2(2 * vxy, vxx - vyy)
    dx, dy = torch.cos(theta), torch.sin(theta)
    tr = vxx + vyy
    det = vxx * vyy - vxy * vxy
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    l1 = tr / 2 + disc
    l2 = tr / 2 - disc

    # endpoints: min/max projection of the support pixels on the direction
    cellv = (eq.T.to(torch.float32) @ torch.stack([dx, dy, cx, cy], -1)
             ).reshape(h2, w2, 4)
    pv = cellv.repeat_interleave(2, 0).repeat_interleave(2, 1)
    t = (xs - pv[..., 2]) * pv[..., 0] + (ys - pv[..., 3]) * pv[..., 1]
    inf = float("inf")
    t_lo = torch.where(edge, t, inf).reshape(h2, 2, w2, 2).amin((1, 3)).reshape(-1)
    t_hi = torch.where(edge, t, -inf).reshape(h2, 2, w2, 2).amax((1, 3)).reshape(-1)
    t0 = torch.where(eq, t_lo[None, :], inf).amin(1)
    t1 = torch.where(eq, t_hi[None, :], -inf).amax(1)
    sp = torch.stack([cx + t0 * dx, cy + t0 * dy], -1)
    epn = torch.stack([cx + t1 * dx, cy + t1 * dy], -1)
    length = t1 - t0

    valid = ((top_cnt >= min_length * 0.8) & (length >= min_length)
             & (l2 < straightness * l1 + 2.0))
    return KeyLines(
        sp=sp, ep=epn,
        angle=torch.remainder(theta + math.pi / 2, math.pi) - math.pi / 2,
        response=top_cnt,
        octave=torch.zeros(max_lines, dtype=torch.int32, device=dev),
        desc=torch.zeros((max_lines, 8), dtype=torch.int32, device=dev),
        mask=valid)


def _lbd_pairs() -> np.ndarray:
    rs = np.random.RandomState(17)
    n_stats = N_BANDS * 4
    pairs = rs.randint(0, n_stats, size=(256, 2))
    fix = pairs[:, 0] == pairs[:, 1]
    pairs[fix, 1] = (pairs[fix, 1] + 1) % n_stats
    return pairs.astype(np.int32)


_LBD_PAIRS = _lbd_pairs()


def lbd_descriptors(img: torch.Tensor, lines: KeyLines) -> torch.Tensor:
    """Binary line-band descriptors [L, 8] int32: gradients sampled on an
    (N_SAMPLES x BAND_WIDTH) grid along each segment, rotated into the line
    frame, averaged per band and compared through the seeded pair pattern."""
    dev = img.device
    gx, gy = _sobel(img)
    h, w = img.shape
    L = lines.sp.shape[0]
    d = lines.ep - lines.sp
    length = torch.linalg.norm(d, dim=-1, keepdim=True) + 1e-6
    dirv = d / length
    nrm = torch.stack([-dirv[:, 1], dirv[:, 0]], -1)

    ts = torch.linspace(0.05, 0.95, N_SAMPLES, device=dev)
    os_ = torch.arange(BAND_WIDTH, dtype=torch.float32,
                       device=dev) - (BAND_WIDTH - 1) / 2
    base = lines.sp[:, None, :] + ts[None, :, None] * d[:, None, :]
    pos = base[:, :, None, :] + os_[None, None, :, None] * nrm[:, None, None, :]
    xi = torch.clamp(round_to_index(pos[..., 0]), 0, w - 1)
    yi = torch.clamp(round_to_index(pos[..., 1]), 0, h - 1)
    gxs = gx[yi, xi]
    gys = gy[yi, xi]
    g_par = gxs * dirv[:, None, None, 0] + gys * dirv[:, None, None, 1]
    g_prp = gxs * nrm[:, None, None, 0] + gys * nrm[:, None, None, 1]

    def band_stats(g):
        gb = g.reshape(L, N_SAMPLES, BAND_WIDTH)
        pad = (-N_SAMPLES) % N_BANDS
        gb = torch.cat([gb, gb.new_zeros((L, pad, BAND_WIDTH))], 1)
        gb = gb.reshape(L, N_BANDS, -1)
        return torch.clamp(gb, min=0).mean(-1), torch.clamp(-gb, min=0).mean(-1)

    pp, pn = band_stats(g_par)
    qp, qn = band_stats(g_prp)
    stats = torch.cat([pp, pn, qp, qn], -1)               # [L, 4*N_BANDS]
    pairs = torch.from_numpy(_LBD_PAIRS).to(dev).long()
    bits = stats[:, pairs[:, 0]] > stats[:, pairs[:, 1]]
    return pack_bits(bits)


def merge_collinear(kl: KeyLines, angle_tol: float = 0.06,
                    dist_tol: float = 4.0, gap_tol: float = 10.0) -> KeyLines:
    """Merge near-collinear overlapping segments: [L, L] collinearity
    adjacency, 16 rounds of min-label propagation, and each group rebuilt
    by min/max projection along its leader's direction."""
    dev = kl.sp.device
    L = kl.sp.shape[0]
    theta, _ = line_theta_d(kl.sp, kl.ep)
    dth = (theta[:, None] - theta[None, :]).abs()
    dth = torch.minimum(dth, math.pi - dth)
    seg_len = torch.linalg.norm(kl.ep - kl.sp, dim=-1)
    tol_pair = angle_tol + 1.5 / torch.clamp(
        torch.minimum(seg_len[:, None], seg_len[None, :]), min=1.0)
    dirv = kl.ep - kl.sp
    dirv = dirv / (torch.linalg.norm(dirv, dim=-1, keepdim=True) + 1e-9)
    n_i = torch.stack([-dirv[:, 1], dirv[:, 0]], -1)
    mid = 0.5 * (kl.sp + kl.ep)
    off_i = (n_i * mid).sum(-1)[:, None]
    db_s = (n_i @ kl.sp.T - off_i).abs()
    db_e = (n_i @ kl.ep.T - off_i).abs()
    dist_lm = torch.maximum(db_s, db_e)
    dist_ok = torch.minimum(dist_lm, dist_lm.T) < dist_tol
    t_s = dirv @ kl.sp.T
    t_e = dirv @ kl.ep.T
    lo = torch.minimum(t_s, t_e)
    hi = torch.maximum(t_s, t_e)
    my_lo = torch.diagonal(lo)[:, None]
    my_hi = torch.diagonal(hi)[:, None]
    overlap = (lo <= my_hi + gap_tol) & (hi >= my_lo - gap_tol)
    adj = ((dth < tol_pair) & dist_ok & overlap
           & kl.mask[:, None] & kl.mask[None, :])

    ar = torch.arange(L, device=dev)
    lab = torch.where(kl.mask, ar, L)
    for _ in range(16):
        nb = torch.where(adj, lab[None, :], L)
        lab = torch.minimum(lab, nb.amin(1))

    n_seg = L + 1
    inf = float("inf")

    def seg_reduce(vals, reduce, fill):
        out = torch.full((n_seg,), fill, dtype=vals.dtype, device=dev)
        return out.scatter_reduce_(0, lab, vals, reduce=reduce)

    resp = torch.where(kl.mask, kl.response, -1.0)
    best_resp = seg_reduce(resp, "amax", -inf)
    is_leader = (resp >= best_resp[lab]) & kl.mask
    idxs = torch.where(is_leader, ar, L)
    leader = seg_reduce(idxs, "amin", np.iinfo(np.int32).max)

    ld = dirv[torch.clamp(leader[lab], 0, L - 1)]
    proj_s = (ld * kl.sp).sum(-1)
    proj_e = (ld * kl.ep).sum(-1)
    pmin = torch.minimum(proj_s, proj_e)
    pmax = torch.maximum(proj_s, proj_e)
    gmin = seg_reduce(torch.where(kl.mask, pmin, inf), "amin", inf)
    gmax = seg_reduce(torch.where(kl.mask, pmax, -inf), "amax", -inf)
    gresp = torch.zeros(n_seg, dtype=kl.response.dtype, device=dev)
    gresp.index_add_(0, lab, torch.where(kl.mask, kl.response, 0.0))

    keep = is_leader & (leader[lab] == ar)
    off = mid - (ld * mid).sum(-1, keepdim=True) * ld
    sp_new = off + gmin[lab][:, None] * ld
    ep_new = off + gmax[lab][:, None] * ld
    return kl._replace(
        sp=torch.where(keep[:, None], sp_new, kl.sp),
        ep=torch.where(keep[:, None], ep_new, kl.ep),
        response=torch.where(keep, gresp[lab], kl.response),
        mask=keep)


def extract_lines(img: torch.Tensor, max_lines: int = 128, **kw) -> KeyLines:
    """Detection + merging + descriptors in one call."""
    kl = detect_lines(img, max_lines=max_lines, **kw)
    kl = merge_collinear(kl)
    return kl._replace(desc=lbd_descriptors(img, kl))


def line_theta_d(sp: torch.Tensor, ep: torch.Tensor):
    """(theta, d) of the infinite line through sp-ep: normal angle theta in
    [-pi/2, pi/2), signed distance d."""
    dvec = ep - sp
    n = torch.stack([-dvec[..., 1], dvec[..., 0]], -1)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)
    d = (n * sp).sum(-1)
    theta = torch.atan2(n[..., 1], n[..., 0])
    flip = (theta >= math.pi / 2) | (theta < -math.pi / 2)
    theta = torch.where(flip, torch.atan2(-n[..., 1], -n[..., 0]), theta)
    return theta, torch.where(flip, -d, d)


def line_nld(sp: torch.Tensor, ep: torch.Tensor) -> torch.Tensor:
    """Normalized image line (nx, ny, d), ||n|| = 1, through sp-ep."""
    dvec = ep - sp
    n = torch.stack([-dvec[..., 1], dvec[..., 0]], -1)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)
    return torch.cat([n, -(n * sp).sum(-1, keepdim=True)], -1)
