"""Batched PnP RANSAC: camera pose from 2D-3D correspondences on bearing
vectors (normalized image coordinates), so any camera that unprojects
works.

Counterpart of plvs_tpu/solvers/pnp.py: every hypothesis is a 6-point DLT
(one batched SVD), every hypothesis is scored against every correspondence
at once, and the best one is polished on its inliers by a fixed 8 steps of
Gauss-Newton, kept only if it loses no inlier. The polish has a fixed trip
count and reads nothing back: each step's Jacobian comes from one
forward-mode dual pass over the 6 tangent directions (what ``jacfwd``
gives), and its solve does not check for errors. (The hypotheses' SVDs
do: ``torch.linalg.svd`` reads its status back on the card.)

The sampling is split out: ``pnp_ransac_from_samples`` scores given
[n_hyp, 6] index samples; ``pnp_ransac`` draws them from an explicit
``torch.Generator``, 6 distinct indices per hypothesis, weights
``valid + 1e-9``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import lie
from .autodiff import jacobian


class PnPResult(NamedTuple):
    R: torch.Tensor          # [3, 3] world-to-camera
    t: torch.Tensor          # [3]
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor


def _dlt_pose(X: torch.Tensor, uv: torch.Tensor, w: torch.Tensor):
    """Weighted DLT of P = [R | t] from >= 6 points per batch row (X
    [..., n, 3] world, uv [..., n, 2] normalized, w [..., n]); R by SVD
    orthonormalization, the scale from the singular values."""
    ones = torch.ones_like(X[..., :1])
    Xh = torch.cat([X, ones], -1)                              # [..., n, 4]
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -uv[..., :1] * Xh], -1)             # [..., n, 12]
    r2 = torch.cat([z, Xh, -uv[..., 1:2] * Xh], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)
    _, _, vt = torch.linalg.svd(A, full_matrices=A.shape[-2] < 12)
    P = vt[..., -1, :].reshape(vt.shape[:-2] + (3, 4))
    # the sign that puts the points in front of the camera
    depths = (Xh * P[..., None, 2, :]).sum(-1)
    sign = torch.where((torch.sign(depths) * w).sum(-1) < 0, -1.0, 1.0)
    M = sign[..., None, None] * P[..., :3]
    t_raw = sign[..., None] * P[..., 3]
    u, s, vth = torch.linalg.svd(M)
    det = torch.linalg.det(u @ vth)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = (u * D[..., None, :]) @ vth
    scale = s.mean(-1) * det
    t = t_raw / torch.where(scale.abs() > 1e-12, scale, 1e-12)[..., None]
    return R, t


def _reproj_err2(R, t, X, uv):
    """Squared normalized reprojection errors (inf behind the camera) of
    poses R [..., 3, 3], t [..., 3] over X [N, 3]: [..., N]."""
    Xc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = Xc[..., 2]
    zs = torch.where(z.abs() > 1e-9, z, 1e-9)
    err2 = ((Xc[..., :2] / zs[..., None] - uv) ** 2).sum(-1)
    return torch.where(z > 1e-6, err2, torch.inf)


def _polish(R0, t0, X, uv, w, iters: int):
    """Gauss-Newton over a left-multiplied SE3 tangent, ``iters`` steps."""
    dev, dt_ = X.device, X.dtype
    eye6 = torch.eye(6, dtype=dt_, device=dev)

    def residuals(xi):                      # xi [B, 6] -> [B, 2N]
        dR, dt = lie.se3_exp(xi)
        R = dR @ R0
        t = (dR @ t0[:, None])[..., 0] + dt
        Xc = X @ R.transpose(-1, -2) + t[:, None, :]
        z = torch.clamp(Xc[..., 2], min=1e-6)
        r = (Xc[..., :2] / z[..., None] - uv) * w[:, None]
        return r.reshape(r.shape[0], -1)

    xi = torch.zeros(6, dtype=dt_, device=dev)
    for _ in range(iters):
        J = jacobian(residuals, xi)                       # [2N, 6]
        r = residuals(xi[None])[0]
        H = J.T @ J + 1e-8 * eye6
        # solve_ex: no error check, so no host read (a singular system
        # gives a non-finite step, as jnp.linalg.solve does)
        xi = xi - torch.linalg.solve_ex(H, J.T @ r)[0]
    return xi


def pnp_ransac_from_samples(X: torch.Tensor, uv: torch.Tensor,
                            valid: torch.Tensor, samples: torch.Tensor,
                            inlier_thresh: float = 0.01,
                            refine_iters: int = 8) -> PnPResult:
    """Score the 6-point hypotheses of ``samples`` [n_hyp, 6] over the
    correspondences X [N, 3] (world) -> uv [N, 2] (normalized), polish the
    best. ``inlier_thresh`` is in normalized units."""
    samples = samples.long()
    th2 = float(np.float32(inlier_thresh) ** 2)  # float32, as in JAX
    Rs, ts = _dlt_pose(X[samples], uv[samples],
                       torch.ones(samples.shape, dtype=X.dtype,
                                  device=X.device))
    err2 = _reproj_err2(Rs, ts, X, uv)                     # [H, N]
    inl = (err2 < th2) & valid[None]
    best = torch.argmax(inl.sum(-1))
    R0, t0, inl0 = Rs[best], ts[best], inl[best]
    xi = _polish(R0, t0, X, uv, inl0.to(X.dtype), refine_iters)
    dR, dt = lie.se3_exp(xi)
    R = dR @ R0
    t = dR @ t0 + dt
    inl_f = (_reproj_err2(R, t, X, uv) < th2) & valid
    better = inl_f.sum() >= inl0.sum()
    R = torch.where(better, R, R0)
    t = torch.where(better, t, t0)
    inl_f = torch.where(better, inl_f, inl0)
    return PnPResult(R, t, inl_f, inl_f.sum())


def draw_samples(valid: torch.Tensor, generator: torch.Generator,
                 n_hyp: int = 256) -> torch.Tensor:
    """[n_hyp, 6] indices, distinct within a row, weights valid + 1e-9."""
    probs = valid.to(torch.float32) + 1e-9
    probs = (probs / probs.sum()).expand(n_hyp, -1)
    return torch.multinomial(probs, 6, replacement=False, generator=generator)


def pnp_ransac(X: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               generator: torch.Generator, n_hyp: int = 256,
               inlier_thresh: float = 0.01,
               refine_iters: int = 8) -> PnPResult:
    """PnP RANSAC with samples from ``generator`` (on the tensors'
    device)."""
    return pnp_ransac_from_samples(X, uv, valid,
                                   draw_samples(valid, generator, n_hyp),
                                   inlier_thresh, refine_iters)
