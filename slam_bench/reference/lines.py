"""The line detector's plain reference: a frozen copy in plain PyTorch
float32, run on the host, with its connectivity step (kernel K2 in the
program) computed by ``kernels.cc_min_labels`` to its true fixpoint.

Copied from plvs_tpu_torch/features/lines.py so that a later change to the
program cannot move it: ``_sobel`` (:52-62), ``_angle_diff_mod_pi``
(:65-67), ``connectivity_grid`` (:70-127), ``detect_lines`` (:130-210),
``merge_collinear`` (:265-334) and ``line_theta_d`` (:344-354); ``top_k``
from plvs_tpu_torch/features/fast.py:30-34. The descriptors are not
copied: the check compares the segments.

``compare`` holds the program's segments of one image against this
reference's, slot by slot: which slots hold a segment, and how far apart
the endpoints of the segments both hold lie.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import kernels

SHIFTS = kernels.SHIFTS


def top_k(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
    h, w = img.shape
    gx, gy = _sobel(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    edge = mag > grad_thresh
    h2, w2 = h // 2, w // 2

    def pool(a):
        return a.reshape(h2, 2, w2, 2).sum((1, 3))

    phi2 = 2.0 * torch.atan2(gy, gx)
    o2x = pool(mag * torch.cos(phi2))
    o2y = pool(mag * torch.sin(phi2))
    mag_h = pool(mag)
    edge_h = edge.reshape(h2, 2, w2, 2).any(3).any(1)
    ori_h = torch.remainder(0.5 * torch.atan2(o2y, o2x) + math.pi / 2, math.pi)
    coh = torch.sqrt(o2x * o2x + o2y * o2y) / torch.clamp(mag_h, min=1e-6)
    edge_h = edge_h & (coh > 0.7)

    def conn(sy, sx):
        e2 = torch.roll(edge_h, (sy, sx), (0, 1))
        o2 = torch.roll(ori_h, (sy, sx), (0, 1))
        return edge_h & e2 & (_angle_diff_mod_pi(ori_h, o2) < 2.0 * ori_tol)

    connect = torch.stack([conn(sy, sx) for sy, sx in SHIFTS])
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
        edge_h, torch.arange(n_cell, dtype=torch.int32).reshape(h2, w2),
        n_cell)
    bit = torch.tensor([1 << ci for ci in range(8)], dtype=torch.int32)
    conn_bits = (connect.to(torch.int32) * bit[:, None, None]).sum(
        0, dtype=torch.int32)
    return mag, edge, init, conn_bits


def detect_lines(img: torch.Tensor, max_lines: int = 128,
                 grad_thresh: float = 40.0, min_length: float = 15.0,
                 ori_tol: float = math.pi / 8, straightness: float = 0.02):
    """(sp [L, 2], ep [L, 2], response [L], mask [L]) of a [H, W] image."""
    h, w = img.shape
    mag, edge, init, conn_bits = connectivity_grid(img, grad_thresh, ori_tol)
    h2, w2 = h // 2, w // 2
    n_cell = h2 * w2
    labels_h = torch.from_numpy(
        kernels.cc_min_labels(init.numpy(), conn_bits.numpy()))
    lab_c = labels_h.reshape(-1).to(torch.int64)

    def pool(a):
        return a.reshape(h2, 2, w2, 2).sum((1, 3))

    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32),
                            indexing="ij")
    n_seg = n_cell + 1
    ones = edge.to(torch.float32)
    wgt = ones * mag

    def pool_sum(a):
        return pool(a).reshape(-1)

    cnt_all = torch.zeros(n_seg, dtype=torch.float32)
    cnt_all.index_add_(0, lab_c, pool_sum(ones))
    top_cnt, top_lab = top_k(cnt_all[:n_cell], max_lines)

    eq = lab_c[None, :] == top_lab[:, None]
    payload = torch.stack(
        [pool_sum(wgt), pool_sum(xs * wgt), pool_sum(ys * wgt),
         pool_sum(xs * xs * wgt), pool_sum(ys * ys * wgt),
         pool_sum(xs * ys * wgt)], -1)
    sums = eq.to(torch.float32) @ payload
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
    return sp, epn, top_cnt, valid


def line_theta_d(sp: torch.Tensor, ep: torch.Tensor):
    dvec = ep - sp
    n = torch.stack([-dvec[..., 1], dvec[..., 0]], -1)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-9)
    d = (n * sp).sum(-1)
    theta = torch.atan2(n[..., 1], n[..., 0])
    flip = (theta >= math.pi / 2) | (theta < -math.pi / 2)
    theta = torch.where(flip, torch.atan2(-n[..., 1], -n[..., 0]), theta)
    return theta, torch.where(flip, -d, d)


def merge_collinear(sp, ep, response, mask, angle_tol: float = 0.06,
                    dist_tol: float = 4.0, gap_tol: float = 10.0):
    """(sp, ep, mask) after merging near-collinear overlapping segments."""
    L = sp.shape[0]
    theta, _ = line_theta_d(sp, ep)
    dth = (theta[:, None] - theta[None, :]).abs()
    dth = torch.minimum(dth, math.pi - dth)
    seg_len = torch.linalg.norm(ep - sp, dim=-1)
    tol_pair = angle_tol + 1.5 / torch.clamp(
        torch.minimum(seg_len[:, None], seg_len[None, :]), min=1.0)
    dirv = ep - sp
    dirv = dirv / (torch.linalg.norm(dirv, dim=-1, keepdim=True) + 1e-9)
    n_i = torch.stack([-dirv[:, 1], dirv[:, 0]], -1)
    mid = 0.5 * (sp + ep)
    off_i = (n_i * mid).sum(-1)[:, None]
    db_s = (n_i @ sp.T - off_i).abs()
    db_e = (n_i @ ep.T - off_i).abs()
    dist_lm = torch.maximum(db_s, db_e)
    dist_ok = torch.minimum(dist_lm, dist_lm.T) < dist_tol
    t_s = dirv @ sp.T
    t_e = dirv @ ep.T
    lo = torch.minimum(t_s, t_e)
    hi = torch.maximum(t_s, t_e)
    my_lo = torch.diagonal(lo)[:, None]
    my_hi = torch.diagonal(hi)[:, None]
    overlap = (lo <= my_hi + gap_tol) & (hi >= my_lo - gap_tol)
    adj = ((dth < tol_pair) & dist_ok & overlap
           & mask[:, None] & mask[None, :])

    ar = torch.arange(L)
    lab = torch.where(mask, ar, L)
    for _ in range(16):
        nb = torch.where(adj, lab[None, :], L)
        lab = torch.minimum(lab, nb.amin(1))

    n_seg = L + 1
    inf = float("inf")

    def seg_reduce(vals, reduce, fill):
        out = torch.full((n_seg,), fill, dtype=vals.dtype)
        return out.scatter_reduce_(0, lab, vals, reduce=reduce)

    resp = torch.where(mask, response, -1.0)
    best_resp = seg_reduce(resp, "amax", -inf)
    is_leader = (resp >= best_resp[lab]) & mask
    idxs = torch.where(is_leader, ar, L)
    leader = seg_reduce(idxs, "amin", np.iinfo(np.int32).max)

    ld = dirv[torch.clamp(leader[lab], 0, L - 1)]
    proj_s = (ld * sp).sum(-1)
    proj_e = (ld * ep).sum(-1)
    pmin = torch.minimum(proj_s, proj_e)
    pmax = torch.maximum(proj_s, proj_e)
    gmin = seg_reduce(torch.where(mask, pmin, inf), "amin", inf)
    gmax = seg_reduce(torch.where(mask, pmax, -inf), "amax", -inf)
    keep = is_leader & (leader[lab] == ar)
    off = mid - (ld * mid).sum(-1, keepdim=True) * ld
    sp_new = off + gmin[lab][:, None] * ld
    ep_new = off + gmax[lab][:, None] * ld
    return (torch.where(keep[:, None], sp_new, sp),
            torch.where(keep[:, None], ep_new, ep), keep)


def extract(img: torch.Tensor, max_lines: int):
    """(sp, ep, mask) of the reference's segments of a host image."""
    sp, ep, resp, mask = detect_lines(img.to(torch.float32), max_lines)
    return merge_collinear(sp, ep, resp, mask)


def compare(img, max_lines: int, sp, ep, mask):
    """(endpoint gaps in px [M] of the M segments both keep, segments kept
    by one side only) between the program's segments (sp, ep, mask) of
    ``img`` and the reference's, slot by slot. A segment's two endpoints
    are taken in either order: the fitted direction of a segment along an
    image axis has no sign, and the last rounding can flip it."""
    with torch.no_grad():
        r_sp, r_ep, r_mask = extract(img.detach().cpu(), max_lines)
    sp, ep, mask = sp.detach().cpu(), ep.detach().cpu(), mask.detach().cpu()
    both = mask & r_mask
    same = torch.maximum((sp - r_sp).norm(dim=-1), (ep - r_ep).norm(dim=-1))
    swap = torch.maximum((sp - r_ep).norm(dim=-1), (ep - r_sp).norm(dim=-1))
    gap = torch.minimum(same, swap)
    return gap[both].numpy().astype(np.float64), int((mask != r_mask).sum())
