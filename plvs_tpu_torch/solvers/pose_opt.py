"""Pose-only optimization (motion-only bundle adjustment).

Counterpart of plvs_tpu/solvers/pose_opt.py: 4 rounds of robust
Gauss-Newton with point (mono / stereo uR) and line (point-to-infinite-
line) unary terms, analytic Jacobians (``cameras.project_jac``), chi2
in/outlier re-classification between rounds, the Huber kernel dropped in
the last round, and an optional SE3 prior. The JAX ``while_loop`` over
Gauss-Newton iterations becomes a Python loop that stops, as it does, once
the step is negligible — one host read of the step norm per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import cameras as cam_mod
from ..geometry import lie
from . import robust


class PoseObs(NamedTuple):
    """Fixed-capacity observation block for one frame."""

    Xw: torch.Tensor          # [N, 3] world points
    uvr: torch.Tensor         # [N, 3] (u, v, uR); uR < 0 => mono
    inv_sigma2: torch.Tensor  # [N] information scale (per pyramid octave)
    mask: torch.Tensor        # [N] valid observation
    line_Xs: torch.Tensor     # [L, 3]
    line_Xe: torch.Tensor     # [L, 3]
    line_nld: torch.Tensor    # [L, 3] normalized 2D line (nx, ny, d)
    line_inv_sigma2: torch.Tensor  # [L]
    line_mask: torch.Tensor   # [L]


def make_pose_obs(Xw, uvr, inv_sigma2, mask, line_Xs=None, line_Xe=None,
                  line_nld=None, line_inv_sigma2=None,
                  line_mask=None) -> PoseObs:
    if line_Xs is None:
        z3 = Xw.new_zeros((0, 3))
        line_Xs, line_Xe, line_nld = z3, z3, z3
        line_inv_sigma2 = Xw.new_zeros((0,))
        line_mask = torch.zeros(0, dtype=torch.bool, device=Xw.device)
    return PoseObs(Xw, uvr, inv_sigma2, mask, line_Xs, line_Xe, line_nld,
                   line_inv_sigma2, line_mask)


def _dX_dxi(Xc: torch.Tensor) -> torch.Tensor:
    """d Xc / d(rho, theta) for the left update exp(dx) * T: [N, 3, 6]."""
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        *Xc.shape[:-1], 3, 3)
    return torch.cat([eye, -lie.hat(Xc)], -1)


def _point_residual_jac(cam: cam_mod.Camera, R, t, obs: PoseObs):
    """Residual [N, 3] and Jacobian [N, 3, 6] of the point observations
    (third row: stereo uR, zeroed for mono entries)."""
    Xc = lie.se3_apply(R, t, obs.Xw)
    uv = cam_mod.project(cam, Xc)
    z = Xc[..., 2]
    z_safe = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    uR = uv[..., 0] - cam.bf / z_safe
    res = obs.uvr - torch.cat([uv, uR[..., None]], -1)
    is_stereo = obs.uvr[..., 2] >= 0
    res = torch.cat([res[..., :2],
                     torch.where(is_stereo, res[..., 2], 0.0)[..., None]], -1)
    Jproj = cam_mod.project_jac(cam, Xc)
    JX = _dX_dxi(Xc)
    Juv = Jproj @ JX
    zr = torch.zeros_like(z)
    duR = Jproj[..., 0, :] + torch.stack([zr, zr, cam.bf / (z_safe * z_safe)], -1)
    JuR = (duR[..., None, :] @ JX)
    J = torch.cat([Juv, JuR], -2)
    ok = obs.mask & (z > 0.05)
    return res, J, ok, is_stereo


def _line_residual_jac(cam: cam_mod.Camera, R, t, obs: PoseObs):
    """Residual [L, 2] and Jacobian [L, 2, 6] of the line observations:
    r_k = n . project(X_k) + d for both endpoints, with the Jacobian negated
    to the point convention (J = d(pred)/dx, r = obs - pred)."""
    n = obs.line_nld[..., :2]
    d = obs.line_nld[..., 2]

    def one(Xw):
        Xc = lie.se3_apply(R, t, Xw)
        uv = cam_mod.project(cam, Xc)
        r = (n * uv).sum(-1) + d
        Juv = cam_mod.project_jac(cam, Xc) @ _dX_dxi(Xc)
        Jr = -(n[..., None, :] @ Juv)[..., 0, :]
        return r, Jr, Xc[..., 2] > 0.05

    rs, Js, oks = one(obs.line_Xs)
    re, Je, oke = one(obs.line_Xe)
    return (torch.stack([rs, re], -1), torch.stack([Js, Je], -2),
            obs.line_mask & oks & oke)


def _normal_eq(J, w, res):
    """H = sum_n w_n J_n^T J_n, b = sum_n w_n J_n^T r_n over [N, r, 6]."""
    Jw = J * w[:, None, None]
    H = torch.einsum("nri,nrj->ij", Jw, J)
    b = torch.einsum("nri,nr->i", Jw, res)
    return H, b


def pose_optimize(cam: cam_mod.Camera, R0: torch.Tensor, t0: torch.Tensor,
                  obs: PoseObs, rounds: int = 4, iters_per_round: int = 10,
                  line_weight: float = 1.0, prior_R=None, prior_t=None,
                  prior_info=None):
    """Motion-only BA with chi2 outlier rounds.

    ``prior_R/t/info``: optional SE3 prior, residual log(T * T_prior^-1)
    weighted by the [6, 6] information (the per-frame inertial term of the
    JAX package; unused by the RGB-D slice, which passes None).

    Returns (R, t, point_inlier_mask, line_inlier_mask, num_inliers)."""
    has_prior = prior_info is not None
    has_lines = obs.line_Xs.shape[0] > 0
    eye6 = torch.eye(6, dtype=R0.dtype, device=R0.device)
    R, t = R0, t0
    in_pts = obs.mask
    in_lines = obs.line_mask
    for round_idx in range(rounds):
        use_robust = round_idx < rounds - 1
        for _ in range(iters_per_round):
            res, J, ok, is_stereo = _point_residual_jac(cam, R, t, obs)
            w = obs.inv_sigma2 * (ok & in_pts)
            if use_robust:
                chi2 = (res * res).sum(-1) * obs.inv_sigma2
                delta2 = torch.where(is_stereo, robust.CHI2_3D, robust.CHI2_2D)
                w = w * robust.huber_weight(chi2, delta2)
            H, b = _normal_eq(J, w, res)
            if has_lines:
                lres, lJ, lok = _line_residual_jac(cam, R, t, obs)
                lw = obs.line_inv_sigma2 * (lok & in_lines) * line_weight
                if use_robust:
                    lchi2 = (lres * lres).sum(-1) * obs.line_inv_sigma2
                    lw = lw * robust.huber_weight(lchi2, robust.CHI2_2D)
                lH, lb = _normal_eq(lJ, lw, lres)
                H = H + lH
                b = b + lb
            if has_prior:
                Rp_inv, tp_inv = lie.se3_inverse(prior_R, prior_t)
                Re, te = lie.se3_compose(R, t, Rp_inv, tp_inv)
                H = H + prior_info
                b = b - prior_info @ lie.se3_log(Re, te)
            # solve_ex: no error check, as jnp.linalg.solve — a frame
            # without features gives a NaN step (then too few inliers)
            # instead of raising on the card
            dx = torch.linalg.solve_ex(H + 1e-6 * eye6, b)[0]
            dR, dt = lie.se3_exp(dx)
            Rn, t = lie.se3_compose(dR, dt, R, t)
            R = lie.normalize_rotation(Rn)
            if float((dx * dx).sum()) < 1e-16:
                break
        # re-classify in/outliers for the next round (outliers may return)
        res, _, ok, is_stereo = _point_residual_jac(cam, R, t, obs)
        chi2 = (res * res).sum(-1) * obs.inv_sigma2
        thr = torch.where(is_stereo, robust.CHI2_3D, robust.CHI2_2D)
        in_pts = ok & (chi2 <= thr)
        if has_lines:
            lres, _, lok = _line_residual_jac(cam, R, t, obs)
            lchi2 = (lres * lres).sum(-1) * obs.line_inv_sigma2
            in_lines = lok & (lchi2 <= robust.CHI2_2D)
    return R, t, in_pts, in_lines, in_pts.sum() + in_lines.sum()
