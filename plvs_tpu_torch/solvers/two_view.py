"""Monocular two-view reconstruction: batched H / F RANSAC, model
selection, motion recovery and the initial triangulation.

Counterpart of plvs_tpu/solvers/two_view.py. Every hypothesis is solved by
one batched SVD and scored against every correspondence in one [Hyp, N]
pass; the best F and H are refit four times on their inlier sets; the
model is chosen by S_H / (S_H + S_F) > 0.40 on the refit scores; the four
poses of the essential matrix and the eight of the Faugeras homography
decomposition are scored together (triangulation, cheirality, reprojection
and parallax), and the first with the most good points wins if the second
best has under 0.9 of its count. Inputs are normalized image coordinates.

The sampling is split out, as in ``sim3_solver``:
``reconstruct_from_samples`` scores given [n_hyp, 8] (F) and [n_hyp, 4]
(H) index samples; ``reconstruct`` draws them from an explicit
``torch.Generator``, with replacement, weights ``valid + 1e-6``.

The minimal 8x9 systems take ``full_matrices=True`` (the 9th right
singular vector is the null space). Singular vectors are defined up to
sign, and the E decomposition's pair (R1, R2) up to order, so results of
two SVD libraries agree in inliers, R and t, not in matrix entries.
Nothing here reads back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lie, triangulation


def _hartley_normalize(p, w=None):
    """Zero mean, mean distance sqrt(2): p [..., N, 2], weights w [..., N].
    Returns (pn, T [..., 3, 3])."""
    if w is None:
        w = torch.ones(p.shape[:-1], dtype=p.dtype, device=p.device)
    wsum = w.sum(-1, keepdim=True) + 1e-9
    mu = (p * w[..., None]).sum(-2) / wsum
    d = torch.sqrt(((p - mu[..., None, :]) ** 2).sum(-1)) * w
    mean_d = d.sum(-1) / wsum[..., 0] + 1e-12
    s = (2.0 ** 0.5) / mean_d
    pn = (p - mu[..., None, :]) * s[..., None, None]
    z = torch.zeros_like(s)
    o = torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, z, -s * mu[..., 0]], -1),
        torch.stack([z, s, -s * mu[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    return pn, T


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """Right singular vector of the smallest singular value of [..., M, 9]
    (full matrices when M < 9, so that it exists)."""
    _, _, Vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < A.shape[-1])
    return Vt[..., -1, :]


def _rank2(F: torch.Tensor) -> torch.Tensor:
    U, D, Vt = torch.linalg.svd(F)
    D = torch.cat([D[..., :2], torch.zeros_like(D[..., 2:])], -1)
    return U @ (D[..., None] * Vt)


def _f_rows(a, b):
    """8-point rows of x2^T F x1 = 0 (a: image 1, b: image 2)."""
    xa, ya = a[..., 0], a[..., 1]
    xb, yb = b[..., 0], b[..., 1]
    return torch.stack([xb * xa, xb * ya, xb, yb * xa, yb * ya, yb, xa, ya,
                        torch.ones_like(xa)], -1)


def _h_rows(a, b):
    """Two DLT rows per correspondence of x2 ~ H x1, as (r1, r2)."""
    xa, ya = a[..., 0], a[..., 1]
    xb, yb = b[..., 0], b[..., 1]
    z = torch.zeros_like(xa)
    o = torch.ones_like(xa)
    r1 = torch.stack([xa, ya, o, z, z, z, -xb * xa, -xb * ya, -xb], -1)
    r2 = torch.stack([z, z, z, xa, ya, o, -yb * xa, -yb * ya, -yb], -1)
    return r1, r2


def _dlt_fundamental(p1, p2):
    """Batched normalized 8-point: [H, 8, 2] x 2 -> F [H, 3, 3]."""
    p1, T1 = _hartley_normalize(p1)
    p2, T2 = _hartley_normalize(p2)
    f = _null_vector(_f_rows(p1, p2))
    F = _rank2(f.reshape(f.shape[:-1] + (3, 3)))
    return T2.transpose(-1, -2) @ F @ T1


def _dlt_homography(p1, p2):
    """Batched normalized 4-point DLT: [H, 4, 2] x 2 -> H [H, 3, 3]."""
    p1, T1 = _hartley_normalize(p1)
    p2, T2 = _hartley_normalize(p2)
    r1, r2 = _h_rows(p1, p2)
    h = _null_vector(torch.cat([r1, r2], -2))
    return torch.linalg.inv(T2) @ h.reshape(h.shape[:-1] + (3, 3)) @ T1


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _sym_epipolar_chi2(F, p1, p2):
    """Squared distances to the epipolar lines in both images, [Hyp, N]."""
    x1, x2 = _homog(p1), _homog(p2)
    l2 = torch.einsum("hij,nj->hni", F, x1)
    l1 = torch.einsum("hji,nj->hni", F, x2)
    num = torch.einsum("ni,hni->hn", x2, l2) ** 2
    d2_2 = num / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d2_1 = num / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    return d2_1, d2_2


def _homography_chi2(Hm, p1, p2):
    """Transfer errors in both images, [Hyp, N]."""
    x1, x2 = _homog(p1), _homog(p2)
    Hx1 = torch.einsum("hij,nj->hni", Hm, x1)
    Hx2 = torch.einsum("hij,nj->hni", torch.linalg.inv(Hm), x2)
    p2h = Hx1[..., :2] / (Hx1[..., 2:3] + 1e-12)
    p1h = Hx2[..., :2] / (Hx2[..., 2:3] + 1e-12)
    return ((p1h - p1[None]) ** 2).sum(-1), ((p2h - p2[None]) ** 2).sum(-1)


class TwoViewResult(NamedTuple):
    success: torch.Tensor
    used_homography: torch.Tensor
    R21: torch.Tensor       # x2 = R21 x1 + t21
    t21: torch.Tensor       # unit norm
    points3d: torch.Tensor  # [N, 3] in frame 1
    inliers: torch.Tensor   # [N] bool (triangulated, cheirality passed)
    n_good: torch.Tensor


def _candidate_poses_from_E(E):
    """The 4 (R, t) of an essential matrix, as [4, 3, 3], [4, 3]."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _candidate_poses_from_H(Hm):
    """The 8 (R, t) of a Euclidean homography (Faugeras' SVD
    decomposition, two families of four), as [8, 3, 3], [8, 3]."""
    U, D, Vt = torch.linalg.svd(Hm)
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1, d2, d3 = D[0], D[1], D[2]
    eps = 1e-9
    den13 = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / den13, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / den13, min=0.0))
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3),
                                  min=0.0))
    sin_t = root / torch.clamp((d1 + d3) * d2, min=eps)
    cos_t = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=eps)
    sin_p = root / torch.clamp((d1 - d3) * d2, min=eps)
    cos_p = (d1 * d3 - d2 * d2) / torch.clamp((d1 - d3) * d2, min=eps)
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)
    Rs, ts = [], []
    for second in (False, True):
        for e1 in (1.0, -1.0):
            for e3 in (1.0, -1.0):
                if not second:
                    Rp = torch.stack([
                        torch.stack([cos_t, zero, -e1 * e3 * sin_t]),
                        torch.stack([zero, one, zero]),
                        torch.stack([e1 * e3 * sin_t, zero, cos_t])])
                    tp = (d1 - d3) * torch.stack([e1 * x1, 0.0 * d1,
                                                  -e3 * x3])
                else:
                    Rp = torch.stack([
                        torch.stack([cos_p, zero, e1 * e3 * sin_p]),
                        torch.stack([zero, -one, zero]),
                        torch.stack([e1 * e3 * sin_p, zero, -cos_p])])
                    tp = (d1 + d3) * torch.stack([e1 * x1, 0.0 * d1,
                                                  e3 * x3])
                t = U @ tp
                Rs.append(s * U @ Rp @ Vt)
                ts.append(t / (torch.linalg.norm(t) + eps))
    return torch.stack(Rs), torch.stack(ts)


def _score_pose(R21, t21, p1, p2, valid, chi2_mask, thresh=4e-6):
    """Triangulate every correspondence under each candidate pose
    (R21 [C, 3, 3], t21 [C, 3]) and flag the good points: triangulated,
    in front of both cameras, reprojecting within ``thresh`` in both
    images, with parallax. Returns (good [C, N], X1 [C, N, 3])."""
    C, N = R21.shape[0], p1.shape[0]
    rays1 = _homog(p1).expand(C, N, 3)
    rays2 = _homog(p2).expand(C, N, 3)
    R12, t12 = lie.se3_inverse(R21, t21)
    R12n = R12[:, None].expand(C, N, 3, 3)
    X1, tri_ok = triangulation.triangulate_dlt(
        rays1, rays2, R12n, t12[:, None].expand(C, N, 3))
    z1 = X1[..., 2]
    X2 = X1 @ R21.transpose(-1, -2) + t21[:, None]
    z2 = X2[..., 2]
    r1 = X1[..., :2] / torch.where(z1[..., None].abs() < 1e-9, 1e-9,
                                   z1[..., None])
    r2 = X2[..., :2] / torch.where(z2[..., None].abs() < 1e-9, 1e-9,
                                   z2[..., None])
    e1 = ((r1 - p1) ** 2).sum(-1)
    e2 = ((r2 - p2) ** 2).sum(-1)
    cosp = triangulation.parallax_cos(rays1, rays2, R12n)
    good = (valid & chi2_mask & tri_ok & (z1 > 0) & (z2 > 0)
            & (e1 < thresh) & (e2 < thresh) & (cosp < 0.99998))
    return good, X1


def _refit_F(p1, p2, inl):
    w = inl.to(p1.dtype)
    p1n, T1n = _hartley_normalize(p1, w)
    p2n, T2n = _hartley_normalize(p2, w)
    f = _null_vector(_f_rows(p1n, p2n) * w[:, None])
    return T2n.T @ _rank2(f.reshape(3, 3)) @ T1n


def _refit_H(p1, p2, inl):
    w = inl.to(p1.dtype)
    q1n, S1n = _hartley_normalize(p1, w)
    q2n, S2n = _hartley_normalize(p2, w)
    r1, r2 = _h_rows(q1n, q2n)
    h = _null_vector(torch.cat([r1 * w[:, None], r2 * w[:, None]], 0))
    return torch.linalg.inv(S2n) @ h.reshape(3, 3) @ S1n


def reconstruct_from_samples(p1: torch.Tensor, p2: torch.Tensor,
                             valid: torch.Tensor, sF: torch.Tensor,
                             sH: torch.Tensor, sigma: float = 1.0 / 500.0,
                             min_good: int = 50,
                             min_parallax_good: float = 0.9) -> TwoViewResult:
    """Two-view reconstruction of [N, 2] normalized correspondences from
    given F samples sF [n_hyp, 8] and H samples sH [n_hyp, 4]."""
    n = p1.shape[0]
    th_f = 3.84 * sigma * sigma
    th_h = 5.99 * sigma * sigma
    sF, sH = sF.long(), sH.long()

    # F: score on the common 5.99 sigma^2 scale so S_H and S_F compare
    F = _dlt_fundamental(p1[sF], p2[sF])
    d1, d2 = _sym_epipolar_chi2(F, p1, p2)
    inlF = (d1 < th_f) & (d2 < th_f) & valid[None]
    scoreF = torch.where(inlF, (th_h - d1) + (th_h - d2), 0.0).sum(-1)
    inl_it = inlF[torch.argmax(scoreF)]
    for _ in range(4):
        F_best = _refit_F(p1, p2, inl_it)
        dd1, dd2 = _sym_epipolar_chi2(F_best[None], p1, p2)
        inl_it = (dd1[0] < th_f) & (dd2[0] < th_f) & valid
    inlF_best = inl_it
    SF_ref = torch.where(inl_it, (th_h - dd1[0]) + (th_h - dd2[0]), 0.0).sum()
    # equal singular values: the essential matrix
    Ue, De, Vte = torch.linalg.svd(F_best)
    se = 0.5 * (De[0] + De[1])
    E = Ue @ torch.diag(torch.stack([se, se, torch.zeros_like(se)])) @ Vte

    Hm = _dlt_homography(p1[sH], p2[sH])
    h1, h2 = _homography_chi2(Hm, p1, p2)
    inlH = (h1 < th_h) & (h2 < th_h) & valid[None]
    scoreH = torch.where(inlH, (th_h - h1) + (th_h - h2), 0.0).sum(-1)
    inl_it_h = inlH[torch.argmax(scoreH)]
    for _ in range(4):
        H_best = _refit_H(p1, p2, inl_it_h)
        hh1, hh2 = _homography_chi2(H_best[None], p1, p2)
        inl_it_h = (hh1[0] < th_h) & (hh2[0] < th_h) & valid
    inlH_best = inl_it_h
    SH_ref = torch.where(inl_it_h, (th_h - hh1[0]) + (th_h - hh2[0]),
                         0.0).sum()
    use_H = SH_ref / torch.clamp(SH_ref + SF_ref, min=1e-9) > 0.40

    # motion recovery: 4 poses of E, then 8 of H, scored at once; the
    # first with the most good points wins (strict > over that order)
    RE, tE = _candidate_poses_from_E(E)
    RH, tH = _candidate_poses_from_H(H_best)
    chi_E = inlF_best & ~use_H
    chi_H = inlH_best & use_H
    chi = torch.cat([chi_E[None].expand(4, n), chi_H[None].expand(8, n)])
    good, X1 = _score_pose(torch.cat([RE, RH]), torch.cat([tE, tH]), p1, p2,
                           valid, chi, 4.0 * sigma * sigma)
    counts = good.sum(-1)
    best = torch.argmax(counts)
    best_good = counts[best]
    second = torch.sort(counts).values[-2]
    success = (best_good >= min_good) & (
        second.float() < min_parallax_good * best_good.float())
    return TwoViewResult(success, use_H, torch.cat([RE, RH])[best],
                         torch.cat([tE, tH])[best], X1[best], good[best],
                         best_good)


def draw_samples(valid: torch.Tensor, generator: torch.Generator,
                 n_hyp: int = 256):
    """(sF [n_hyp, 8], sH [n_hyp, 4]) drawn with replacement, weights
    valid + 1e-6 (the JAX package's probabilities)."""
    probs = valid.to(torch.float32) + 1e-6
    probs = probs / probs.sum()
    sF = torch.multinomial(probs, n_hyp * 8, replacement=True,
                           generator=generator).reshape(n_hyp, 8)
    sH = torch.multinomial(probs, n_hyp * 4, replacement=True,
                           generator=generator).reshape(n_hyp, 4)
    return sF, sH


def reconstruct(p1: torch.Tensor, p2: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator, n_hyp: int = 256,
                sigma: float = 1.0 / 500.0, min_good: int = 50,
                min_parallax_good: float = 0.9) -> TwoViewResult:
    """Two-view reconstruction with samples from ``generator`` (on the
    tensors' device)."""
    sF, sH = draw_samples(valid, generator, n_hyp)
    return reconstruct_from_samples(p1, p2, valid, sF, sH, sigma=sigma,
                                    min_good=min_good,
                                    min_parallax_good=min_parallax_good)
