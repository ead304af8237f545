"""Visual-inertial local bundle adjustment.

Counterpart of plvs_tpu/solvers/vi_ba.py (the reference's LocalInertialBA):
per keyframe a body state (R_wb, p_wb), a velocity and the two biases, a
15-dim tangent; 3D points as landmarks; reprojection terms chained to the
body tangent through Ad(T_cb), optional pose-only line terms, the 9D
preintegration factors between consecutive keyframes (Jacobians by
forward-mode autodiff) and the bias random walk. The normal equations are
applied matrix-free and solved by block-Jacobi PCG inside an LM loop, the
layout of the visual BA.

As in ``solvers/ba.py`` both JAX ``while_loop``s run their full trip counts
with a device-side active flag, so a solve reads nothing back to the host;
``info`` carries the LM and CG iterations that were active. The inertial
Jacobians come from one dual-number pass over the edges stacked once per
tangent coordinate of the two endpoints (30), what ``jacfwd`` under
``vmap`` gives in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from ..geometry import cameras as cam_mod
from ..geometry import lie
from ..imu import preintegration as pre
from . import robust
from .ba import (_JTv, _JTWJ, _dXc_dxi, _lm_loop, _mv, _onehot_seg_reduce,
                 _pcg, _safe_z, _sorted_seg_reduce, _vm)


class VIProblem(NamedTuple):
    """A padded VI-BA problem (tensors on one device; index columns int64).
    The line fields are None when the window has no line observations."""

    R_wb: torch.Tensor       # [K, 3, 3] body-to-world
    p_wb: torch.Tensor       # [K, 3]
    v_w: torch.Tensor        # [K, 3]
    bg: torch.Tensor         # [K, 3]
    ba: torch.Tensor         # [K, 3]
    fixed: torch.Tensor      # [K] bool
    kf_mask: torch.Tensor    # [K] bool
    R_cb: torch.Tensor       # [3, 3] camera-from-body (fixed)
    t_cb: torch.Tensor       # [3]
    points: torch.Tensor     # [P, 3]
    point_mask: torch.Tensor  # [P] bool
    obs_kf: torch.Tensor     # [M]
    obs_pt: torch.Tensor     # [M]
    obs_uvr: torch.Tensor    # [M, 3]
    obs_inv_sigma2: torch.Tensor  # [M]
    obs_mask: torch.Tensor   # [M] bool
    pre_stack: pre.Preintegrated  # fields with a leading [K-1]
    pre_mask: torch.Tensor   # [K-1] bool
    gravity: torch.Tensor    # [3]
    lobs_kf: torch.Tensor | None = None       # [Ml]
    lobs_Xs: torch.Tensor | None = None       # [Ml, 3] world endpoints
    lobs_Xe: torch.Tensor | None = None
    lobs_nld: torch.Tensor | None = None      # [Ml, 3]
    lobs_inv_sigma2: torch.Tensor | None = None
    lobs_mask: torch.Tensor | None = None


def _body_to_cam(prob: VIProblem, R_wb, p_wb):
    """T_cw = T_cb T_bw."""
    R_bw = R_wb.transpose(-1, -2)
    t_bw = -_mv(R_bw, p_wb)
    return prob.R_cb @ R_bw, _mv(prob.R_cb, t_bw) + prob.t_cb


def _edge_fn(prob: VIProblem):
    """Residual of inertial edges at perturbed endpoint states: the state
    tangent is [dtheta(3), dp(3), dv(3), dbg(3), dba(3)] per endpoint, the
    rotation perturbed on the left."""
    def f(di, dj, p_e, Ri0, pi0, vi0, bgi0, bai0, Rj0, pj0, vj0):
        Ri = lie.so3_exp(di[..., 0:3]) @ Ri0
        Rj = lie.so3_exp(dj[..., 0:3]) @ Rj0
        return pre.inertial_residual(
            p_e, Ri, pi0 + di[..., 3:6], vi0 + di[..., 6:9], Rj,
            pj0 + dj[..., 3:6], vj0 + dj[..., 6:9], bgi0 + di[..., 9:12],
            bai0 + di[..., 12:15], gravity=prob.gravity)
    return f


def _inertial_linearize(prob: VIProblem, R_wb, p_wb, v_w, bg, ba):
    """Residuals [E, 9] and Jacobians [E, 9, 30] of the K-1 inertial edges
    with respect to both endpoint tangents."""
    E = R_wb.shape[0] - 1
    dev, f32 = R_wb.device, R_wb.dtype
    args = (prob.pre_stack, R_wb[:-1], p_wb[:-1], v_w[:-1], bg[:-1],
            ba[:-1], R_wb[1:], p_wb[1:], v_w[1:])
    f = _edge_fn(prob)
    z = torch.zeros((E, 15), dtype=f32, device=dev)
    r = f(z, z, *args)

    def rep(a):
        return a.repeat((30,) + (1,) * (a.dim() - 1))

    reps = (pre.Preintegrated(*(rep(x) for x in prob.pre_stack)),
            *(rep(a) for a in args[1:]))
    basis = torch.eye(30, dtype=f32, device=dev).repeat_interleave(E, 0)
    zz = torch.zeros((30 * E, 15), dtype=f32, device=dev)
    with fwAD.dual_level():
        out = f(fwAD.make_dual(zz, basis[:, :15]),
                fwAD.make_dual(zz, basis[:, 15:]), *reps)
        tangent = fwAD.unpack_dual(out).tangent
    J = tangent.reshape(30, E, 9).permute(1, 2, 0)
    return r, J


def vi_bundle_adjust(cam: cam_mod.Camera, prob: VIProblem,
                     num_iters: int = 8, cg_iters: int = 40,
                     lam0: float = 1e-3, inertial_weight: float = 1.0,
                     bias_walk_info: float = 1e4):
    """Run the VI local BA; returns (R_wb, p_wb, v_w, bg, ba, points, info)
    with info = dict(cost0, cost, lam, lm_iters, cg_iters), all device
    tensors."""
    K = prob.R_wb.shape[0]
    P = prob.points.shape[0]
    E = K - 1
    D = 15
    dev, f32 = prob.R_wb.device, prob.R_wb.dtype
    free = ((~prob.fixed) & prob.kf_mask).to(f32)[:, None]
    pt_m = prob.point_mask.to(f32)[:, None]
    AdTcb = lie.se3_adjoint(prob.R_cb, prob.t_cb)  # body tangent -> camera
    has_lines = prob.lobs_kf is not None and prob.lobs_kf.shape[0] > 0
    seg_c = _onehot_seg_reduce(prob.obs_kf, K)
    seg_p = _sorted_seg_reduce(prob.obs_pt, P)
    if has_lines:
        seg_lc = _onehot_seg_reduce(prob.lobs_kf, K)
    pm = prob.pre_mask.to(f32)[:, None]                       # [E, 1]
    zrow = torch.zeros((1, D), dtype=f32, device=dev)
    bw = bias_walk_info
    eye_b = torch.eye(3, dtype=f32, device=dev) * bw
    eyeD = torch.eye(D, dtype=f32, device=dev)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    w_in = (1.0 / torch.sqrt(torch.diagonal(
        prob.pre_stack.cov[:, :9, :9], dim1=-2, dim2=-1) + 1e-9)
        * inertial_weight ** 0.5) * pm                        # [E, 9]

    def visual_terms(R_wb, p_wb, points):
        R_cw, t_cw = _body_to_cam(prob, R_wb, p_wb)
        Rm = R_cw[prob.obs_kf]
        Xc = _mv(Rm, points[prob.obs_pt]) + t_cw[prob.obs_kf]
        uv = cam_mod.project(cam, Xc)
        z = Xc[..., 2]
        z_safe = _safe_z(z)
        uR = uv[..., 0] - cam.bf / z_safe
        res = prob.obs_uvr - torch.cat([uv, uR[..., None]], -1)
        is_stereo = prob.obs_uvr[..., 2] >= 0
        res = torch.cat([res[..., :2], torch.where(
            is_stereo, res[..., 2], 0.0)[..., None]], -1)
        Jproj = cam_mod.project_jac(cam, Xc)
        zr = torch.zeros_like(z)
        duR = Jproj[..., 0, :] + torch.stack(
            [zr, zr, cam.bf / (z_safe * z_safe)], -1)
        Jrows = torch.cat([Jproj, duR[..., None, :]], -2)
        Jc_body = -(Jrows @ _dXc_dxi(Xc)) @ AdTcb              # [M, 3, 6]
        Jp = -(Jrows @ Rm)
        one = torch.ones_like(z)
        row_w = torch.stack([one, one, is_stereo.to(f32)], -1)
        ok = prob.obs_mask & (z > 0.05)
        return res, Jc_body, Jp, ok, row_w, is_stereo

    def line_terms(R_wb, p_wb):
        R_cw, t_cw = _body_to_cam(prob, R_wb, p_wb)
        Rm = R_cw[prob.lobs_kf]
        tm = t_cw[prob.lobs_kf]
        n = prob.lobs_nld[..., :2]
        d = prob.lobs_nld[..., 2]

        def endpoint(Xw):
            Xc = _mv(Rm, Xw) + tm
            uv = cam_mod.project(cam, Xc)
            r = (n * uv).sum(-1) + d
            dr_dXc = _vm(n, cam_mod.project_jac(cam, Xc))
            return r, _vm(dr_dXc, _dXc_dxi(Xc)) @ AdTcb, Xc[..., 2] > 0.05

        rs, Js, oks = endpoint(prob.lobs_Xs)
        re, Je, oke = endpoint(prob.lobs_Xe)
        return (torch.stack([rs, re], -1), torch.stack([Js, Je], -2),
                prob.lobs_mask & oks & oke)

    def inertial_terms(R_wb, p_wb, v_w, bg, ba):
        r, J = _inertial_linearize(prob, R_wb, p_wb, v_w, bg, ba)
        return r * w_in, J * w_in[..., None]

    def chi2_thr(is_st):
        return torch.where(is_st, robust.CHI2_3D, robust.CHI2_2D)

    def cost_fn(R_wb, p_wb, v_w, bg, ba, points):
        res, _, _, ok, row_w, is_st = visual_terms(R_wb, p_wb, points)
        chi2 = (res * res * row_w).sum(-1) * prob.obs_inv_sigma2
        c = (torch.minimum(chi2, 2 * chi2_thr(is_st)) * ok).sum()
        if has_lines:
            lres, _, lok = line_terms(R_wb, p_wb)
            lchi2 = (lres * lres).sum(-1) * prob.lobs_inv_sigma2
            c = c + (torch.minimum(lchi2, torch.full_like(
                lchi2, 2 * robust.CHI2_2D)) * lok).sum()
        ri, _ = inertial_terms(R_wb, p_wb, v_w, bg, ba)
        c = c + (ri * ri).sum()
        dbg = (bg[1:] - bg[:-1]) * pm
        dba = (ba[1:] - ba[:-1]) * pm
        return c + bw * ((dbg * dbg).sum() + (dba * dba).sum())

    def to_i(v):      # [E, ...] onto keyframes 0..K-2
        return torch.cat([v, torch.zeros_like(v[:1])], 0)

    def to_j(v):      # [E, ...] onto keyframes 1..K-1
        return torch.cat([torch.zeros_like(v[:1]), v], 0)

    def lm_step(R_wb, p_wb, v_w, bg, ba, points, lam, cost_prev):
        res, Jb, Jp, ok, row_w, is_st = visual_terms(R_wb, p_wb, points)
        chi2 = (res * res * row_w).sum(-1) * prob.obs_inv_sigma2
        rw = robust.huber_weight(chi2, chi2_thr(is_st))
        wr = (prob.obs_inv_sigma2 * rw * ok)[:, None] * row_w
        if has_lines:
            lres, lJ, lok = line_terms(R_wb, p_wb)
            lchi2 = (lres * lres).sum(-1) * prob.lobs_inv_sigma2
            lw = (prob.lobs_inv_sigma2 * robust.huber_weight(
                lchi2, robust.CHI2_2D) * lok)
            lwr = lw[:, None].expand(-1, 2)

        # inertial Jacobians wrt [dtheta_wb, dp_wb, ...] chained to the
        # pose's xi on T_bw: dtheta = -R_wb xi_theta, dp = -R_wb xi_rho
        ri, Ji = inertial_terms(R_wb, p_wb, v_w, bg, ba)
        A = -R_wb

        def chain(Je, As):
            return torch.cat([Je[..., 3:6] @ As, Je[..., 0:3] @ As,
                              Je[..., 6:15]], -1)

        Ji_i = chain(Ji[..., :15], A[:-1])                     # [E, 9, 15]
        Ji_j = chain(Ji[..., 15:], A[1:])

        # gradient b = -J^T W r
        bc_vis = -seg_c(_JTv(Jb, wr * res))
        if has_lines:
            bc_vis = bc_vis - seg_lc(_JTv(lJ, lwr * lres))
        bp = -seg_p(_JTv(Jp, wr * res)) * pt_m
        bc = torch.cat([bc_vis, torch.zeros((K, D - 6), dtype=f32,
                                            device=dev)], -1)
        bc = bc + to_i(-_JTv(Ji_i, ri)) + to_j(-_JTv(Ji_j, ri))
        dbg = (bg[1:] - bg[:-1]) * pm
        dba = (ba[1:] - ba[:-1]) * pm
        zw = torch.zeros((E, 9), dtype=f32, device=dev)
        gw = torch.cat([zw, bw * dbg, bw * dba], -1)
        bc = (bc + to_i(gw) - to_j(gw)) * free

        # block diagonals
        Hv = seg_c(_JTWJ(Jb, wr))
        if has_lines:
            Hv = Hv + seg_lc(_JTWJ(lJ, lwr))
        Hcc = torch.nn.functional.pad(Hv, (0, D - 6, 0, D - 6))
        Hcc = (Hcc + to_i(Ji_i.transpose(-1, -2) @ Ji_i)
               + to_j(Ji_j.transpose(-1, -2) @ Ji_j))
        Hb = torch.block_diag(torch.zeros((9, 9), dtype=f32, device=dev),
                              eye_b, eye_b)[None] * pm[..., None]
        Hcc = Hcc + to_i(Hb) + to_j(Hb)
        Hpp = seg_p(_JTWJ(Jp, wr))

        lam_c = lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-6
        lam_p = lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-6
        Mc = torch.linalg.inv_ex(Hcc + lam_c[..., None] * eyeD)[0]
        Mp = torch.linalg.inv_ex(Hpp + lam_p[..., None] * eye3
                                 + 1e-8 * eye3)[0]

        def matvec(xc, xp):
            xc = xc * free
            xp = xp * pt_m
            u = (_mv(Jb, xc[prob.obs_kf, 0:6])
                 + _mv(Jp, xp[prob.obs_pt])) * wr
            yv = seg_c(_JTv(Jb, u))
            if has_lines:
                ul = _mv(lJ, xc[prob.lobs_kf, 0:6]) * lwr
                yv = yv + seg_lc(_JTv(lJ, ul))
            yp = seg_p(_JTv(Jp, u))
            yc = torch.cat([yv, torch.zeros((K, D - 6), dtype=f32,
                                            device=dev)], -1)
            ui = _mv(Ji_i, xc[:-1]) + _mv(Ji_j, xc[1:])
            yc = yc + to_i(_JTv(Ji_i, ui)) + to_j(_JTv(Ji_j, ui))
            dxw = (xc[1:] - xc[:-1]) * pm
            gx = torch.cat([zw, bw * dxw[:, 9:15]], -1)
            yc = yc - to_i(gx) + to_j(gx)
            return (yc + lam_c * xc) * free, (yp + lam_p * xp) * pt_m

        def precond(rc, rp):
            return _mv(Mc, rc) * free, _mv(Mp, rp) * pt_m

        (dxc, dxp), n_cg = _pcg(matvec, precond, (bc, bp), cg_iters)

        # state update: xi on T_bw for the pose, additive for the rest
        xi = dxc[:, 0:6]
        R_n = lie.normalize_rotation(R_wb @ lie.so3_exp(-xi[:, 3:6]))
        p_n = p_wb - _mv(R_wb, xi[:, 0:3])
        v_n = v_w + dxc[:, 6:9]
        bg_n = bg + dxc[:, 9:12]
        ba_n = ba + dxc[:, 12:15]
        pts_n = points + dxp
        cost_new = cost_fn(R_n, p_n, v_n, bg_n, ba_n, pts_n)
        accept = cost_new < cost_prev
        out = [torch.where(accept, a, b) for a, b in (
            (R_n, R_wb), (p_n, p_wb), (v_n, v_w), (bg_n, bg), (ba_n, ba),
            (pts_n, points))]
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e4))
        done = accept & (cost_prev - cost_new < 1e-6 * cost_prev)
        cost_prev = torch.where(accept, cost_new, cost_prev)
        return (*out, lam, cost_prev), done, n_cg

    cost0 = cost_fn(prob.R_wb, prob.p_wb, prob.v_w, prob.bg, prob.ba,
                    prob.points)
    state = (prob.R_wb, prob.p_wb, prob.v_w, prob.bg, prob.ba, prob.points,
             torch.full((), lam0, dtype=f32, device=dev), cost0)
    state, lm_n, cg_n = _lm_loop(lm_step, state, num_iters)
    R_wb, p_wb, v_w, bg, ba, points, lam, cost = state
    return R_wb, p_wb, v_w, bg, ba, points, {
        "cost0": cost0, "cost": cost, "lam": lam, "lm_iters": lm_n,
        "cg_iters": cg_n}
