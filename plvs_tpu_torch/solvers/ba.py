"""Bundle adjustment as a batched Levenberg-Marquardt solver.

Counterpart of the product path of plvs_tpu/solvers/ba.py: SE3 poses, 3D
points and 3D line endpoints with Huber kernels, the normal equations
applied matrix-free (per-observation Jacobian blocks evaluated in one
batched pass; H @ x is two gathers and two segment sums) and solved by
block-Jacobi preconditioned conjugate gradient inside an LM trust loop.

Segment sums follow the JAX package's ``scatter_free=True`` semantics, not
``index_add_``: points and lines sort once and reduce by a cumulative sum
read at two ``searchsorted`` boundaries, cameras by a one-hot product.
Atomic adds would sum in a different order on every run.

The JAX ``while_loop``s stop on device values (the CG residual, the LM
convergence flag). Reading those back every iteration would cost up to
5 x (14 + 1) host syncs a solve, so both loops here run their full trip
counts and carry a device-side ``active`` flag instead: every state update
is ``torch.where(active, new, old)``. Once a loop would have stopped its
state no longer changes, so the result is the one the ``while_loop`` gives,
and the solve reads nothing back to the host. ``info`` also carries the LM
and CG iterations that were active.

Fixed-capacity convention: arrays are padded; masks mark real entries;
fixed cameras (the gauge) are masked through ``fixed_cam``. Index columns
are int64 (the JAX package's are int32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import cameras as cam_mod
from ..geometry import lie
from . import robust


class BAProblem(NamedTuple):
    """A padded, SoA bundle-adjustment problem (tensors on one device)."""

    R: torch.Tensor               # [K, 3, 3] world-to-camera
    t: torch.Tensor               # [K, 3]
    fixed_cam: torch.Tensor       # [K] bool: gauge / frozen keyframes
    cam_mask: torch.Tensor        # [K] bool: valid keyframe slots
    points: torch.Tensor          # [P, 3]
    point_mask: torch.Tensor      # [P] bool
    obs_cam: torch.Tensor         # [M] int64
    obs_pt: torch.Tensor          # [M] int64
    obs_uvr: torch.Tensor         # [M, 3] (u, v, uR); uR < 0 => mono
    obs_inv_sigma2: torch.Tensor  # [M]
    obs_mask: torch.Tensor        # [M] bool
    lines_Xs: torch.Tensor        # [L, 3] (L may be 0)
    lines_Xe: torch.Tensor        # [L, 3]
    line_mask: torch.Tensor       # [L] bool
    lobs_cam: torch.Tensor        # [Ml] int64
    lobs_line: torch.Tensor       # [Ml] int64
    lobs_nld: torch.Tensor        # [Ml, 3] normalized image line (nx, ny, d)
    lobs_inv_sigma2: torch.Tensor  # [Ml]
    lobs_mask: torch.Tensor       # [Ml] bool
    lobs_depth: torch.Tensor      # [Ml, 2] measured endpoint depths (<= 0 none)


def make_problem(R, t, fixed_cam, points, obs_cam, obs_pt, obs_uvr,
                 obs_inv_sigma2, obs_mask, cam_mask=None, point_mask=None,
                 lines_Xs=None, lines_Xe=None, line_mask=None,
                 lobs_cam=None, lobs_line=None, lobs_nld=None,
                 lobs_inv_sigma2=None, lobs_mask=None,
                 lobs_depth=None) -> BAProblem:
    dev, f32 = R.device, R.dtype

    def b(n, fill):
        return torch.full((n,), fill, dtype=torch.bool, device=dev)

    if cam_mask is None:
        cam_mask = b(R.shape[0], True)
    if point_mask is None:
        point_mask = b(points.shape[0], True)
    if lines_Xs is None:
        lines_Xs = lines_Xe = lobs_nld = torch.zeros((0, 3), dtype=f32,
                                                     device=dev)
        line_mask = lobs_mask = b(0, False)
        lobs_cam = lobs_line = torch.zeros((0,), dtype=torch.int64,
                                           device=dev)
        lobs_inv_sigma2 = torch.zeros((0,), dtype=f32, device=dev)
    if lobs_depth is None:
        lobs_depth = torch.zeros((lobs_nld.shape[0], 2), dtype=f32,
                                 device=dev)
    return BAProblem(R, t, fixed_cam, cam_mask, points, point_mask,
                     obs_cam.long(), obs_pt.long(), obs_uvr, obs_inv_sigma2,
                     obs_mask, lines_Xs, lines_Xe, line_mask,
                     lobs_cam.long(), lobs_line.long(), lobs_nld,
                     lobs_inv_sigma2, lobs_mask, lobs_depth)


# ---------------------------------------------------------------------------
# small batched products (the JAX package's einsums)
# ---------------------------------------------------------------------------

def _mv(A, x):
    """[..., i, j] x [..., j] -> [..., i]."""
    return (A @ x[..., None])[..., 0]


def _vm(v, A):
    """[..., k] x [..., k, j] -> [..., j]."""
    return (v[..., None, :] @ A)[..., 0, :]


def _JTv(J, v):
    """sum_r J[m, r, i] v[m, r] -> [m, i]."""
    return (J * v[..., None]).sum(-2)


def _JTWJ(J, w):
    """sum_r J[m, r, i] w[m, r] J[m, r, j] -> [m, i, j]."""
    return (J * w[..., None]).transpose(-1, -2) @ J


def _dXc_dxi(Xc):
    """[I | -hat(Xc)]: d Xc / d(rho, theta) of the left update, [..., 3, 6]."""
    eye = torch.eye(3, dtype=Xc.dtype, device=Xc.device).expand(
        *Xc.shape[:-1], 3, 3)
    return torch.cat([eye, -lie.hat(Xc)], -1)


def _safe_z(z):
    return torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)


# ---------------------------------------------------------------------------
# residuals / Jacobians (batched over the observation tables)
# ---------------------------------------------------------------------------

def _point_terms(cam, R, t, points, prob: BAProblem, jac: bool = True):
    """Residual [M, 3], Jc [M, 3, 6], Jp [M, 3, 3], validity [M], row
    weights [M, 3], is_stereo [M] (Jacobians None when ``jac`` is False)."""
    Rm = R[prob.obs_cam]
    Xc = _mv(Rm, points[prob.obs_pt]) + t[prob.obs_cam]
    uv = cam_mod.project(cam, Xc)
    z = Xc[..., 2]
    z_safe = _safe_z(z)
    uR = uv[..., 0] - cam.bf / z_safe
    res = prob.obs_uvr - torch.cat([uv, uR[..., None]], -1)
    is_stereo = prob.obs_uvr[..., 2] >= 0
    res = torch.cat([res[..., :2], torch.where(is_stereo, res[..., 2],
                                               0.0)[..., None]], -1)
    one = torch.ones_like(z)
    row_w = torch.stack([one, one, is_stereo.to(z.dtype)], -1)
    ok = prob.obs_mask & (z > 0.05)
    if not jac:
        return res, None, None, ok, row_w, is_stereo
    Jproj = cam_mod.project_jac(cam, Xc)                      # [M, 2, 3]
    zr = torch.zeros_like(z)
    duR = Jproj[..., 0, :] + torch.stack([zr, zr, cam.bf / (z_safe * z_safe)],
                                         -1)
    Jrows = torch.cat([Jproj, duR[..., None, :]], -2)         # [M, 3, 3]
    Jc = -(Jrows @ _dXc_dxi(Xc))
    Jp = -(Jrows @ Rm)
    return res, Jc, Jp, ok, row_w, is_stereo


def _line_terms(cam, R, t, lines_Xs, lines_Xe, prob: BAProblem,
                jac: bool = True):
    """Residual [Ml, 4], Jc [Ml, 4, 6], Jl [Ml, 4, 6] (endpoint deltas),
    validity [Ml], row weights [Ml, 4]. Rows 0-1: signed distance of the
    projected endpoints to the observed infinite line; rows 2-3: endpoint
    disparity residuals bf / z_pred - bf / z_meas where a depth was
    measured."""
    Rm = R[prob.lobs_cam]
    tm = t[prob.lobs_cam]
    n = prob.lobs_nld[..., :2]
    d = prob.lobs_nld[..., 2]
    bf = cam.bf if cam.bf > 0 else float(cam.params[0]) * 0.1

    def endpoint(Xw, z_meas):
        Xc = _mv(Rm, Xw) + tm
        uv = cam_mod.project(cam, Xc)
        r = (n * uv).sum(-1) + d
        z = Xc[..., 2]
        z_safe = _safe_z(z)
        has_d = z_meas > 0
        zm_safe = torch.where(has_d, z_meas, torch.ones_like(z_meas))
        rd = torch.where(has_d, bf / zm_safe - bf / z_safe,
                         torch.zeros_like(z))
        if not jac:
            return r, None, None, rd, None, None, z > 0.05, has_d
        JX = _dXc_dxi(Xc)
        dr_dXc = _vm(n, cam_mod.project_jac(cam, Xc))          # [Ml, 3]
        zr = torch.zeros_like(z)
        drd_dXc = torch.stack([zr, zr, bf / (z_safe * z_safe)], -1)
        return (r, _vm(dr_dXc, JX), _vm(dr_dXc, Rm), rd, _vm(drd_dXc, JX),
                _vm(drd_dXc, Rm), z > 0.05, has_d)

    rs, Jcs, Jxs, rds, Jcds, Jxds, oks, hds = endpoint(
        lines_Xs[prob.lobs_line], prob.lobs_depth[..., 0])
    re, Jce, Jxe, rde, Jcde, Jxde, oke, hde = endpoint(
        lines_Xe[prob.lobs_line], prob.lobs_depth[..., 1])
    res = torch.stack([rs, re, rds, rde], -1)
    ok = prob.lobs_mask & oks & oke
    one = torch.ones_like(rs)
    row_w = torch.stack([one, one, hds.to(rs.dtype), hde.to(rs.dtype)], -1)
    if not jac:
        return res, None, None, ok, row_w
    Jc = torch.stack([Jcs, Jce, Jcds, Jcde], -2)                 # [Ml, 4, 6]
    z3 = torch.zeros_like(Jxs)
    Jl = torch.stack([torch.cat([Jxs, z3], -1), torch.cat([z3, Jxe], -1),
                      torch.cat([Jxds, z3], -1), torch.cat([z3, Jxde], -1)],
                     -2)                                          # [Ml, 4, 6]
    return res, Jc, Jl, ok, row_w


# ---------------------------------------------------------------------------
# segment sums
# ---------------------------------------------------------------------------

def _sorted_seg_reduce(idx: torch.Tensor, num_segments: int):
    """Segment sum for a fixed index vector: a stable sort once, then every
    reduction is a cumulative sum read at the segments' two boundaries.

    PRECISION NOTE (as in the JAX package): the prefix differences carry an
    absolute error of about eps x the global sum, harmless to the
    preconditioned CG that uses them."""
    order = torch.argsort(idx, stable=True)
    idx_s = idx[order]
    seg = torch.arange(num_segments, dtype=idx.dtype, device=idx.device)
    starts = torch.searchsorted(idx_s, seg)
    ends = torch.searchsorted(idx_s, seg, right=True)

    def reduce(v):
        cs = torch.cumsum(v[order], 0, dtype=v.dtype)
        cs = torch.cat([torch.zeros_like(cs[:1]), cs], 0)
        return cs[ends] - cs[starts]

    return reduce


def _onehot_seg_reduce(idx: torch.Tensor, num_segments: int):
    """Segment sum for a small segment count: one [S, M] 0/1 matrix, every
    reduction one float32 product."""
    E = (idx[None, :] == torch.arange(num_segments, dtype=idx.dtype,
                                      device=idx.device)[:, None]).float()

    def reduce(v):
        return (E.to(v.dtype) @ v.reshape(v.shape[0], -1)).reshape(
            (num_segments,) + v.shape[1:])

    return reduce


# ---------------------------------------------------------------------------
# the two loops, at full trip count with an active flag (module docstring)
# ---------------------------------------------------------------------------

def _dot(a, b):
    return sum((x * y).sum() for x, y in zip(a, b))


def _guard_abs(d, tiny):
    """A denominator kept off zero: |d| < 1e-20 reads 1e-20 (the BA's)."""
    return torch.where(d.abs() < 1e-20, tiny, d)


def _guard_max(d, tiny):
    """max(d, 1e-20) (the pose graph's)."""
    return torch.maximum(d, tiny)


def _pcg(matvec, precond, b, cg_iters: int, guard=_guard_abs):
    """Preconditioned CG on a tuple of blocks from x = 0; the JAX loop runs
    while i < cg_iters and rz > 1e-12 rz0. ``guard`` keeps the step's
    denominators off zero as the JAX solver at hand does. Returns (x,
    active iterations)."""
    r = b
    x = tuple(torch.zeros_like(v) for v in b)
    p = z = precond(*r)
    rz = rz0 = _dot(r, z)
    n = torch.zeros((), dtype=torch.int32, device=rz.device)
    tiny = torch.full((), 1e-20, dtype=rz.dtype, device=rz.device)
    for _ in range(cg_iters):
        active = rz > 1e-12 * rz0
        Ap = matvec(*p)
        alpha = rz / guard(_dot(p, Ap), tiny)
        xn = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        rn = tuple(ri - alpha * Ai for ri, Ai in zip(r, Ap))
        zn = precond(*rn)
        rz_new = _dot(rn, zn)
        beta = rz_new / guard(rz, tiny)
        pn = tuple(zi + beta * pi for zi, pi in zip(zn, p))
        x = tuple(torch.where(active, a, c) for a, c in zip(xn, x))
        r = tuple(torch.where(active, a, c) for a, c in zip(rn, r))
        p = tuple(torch.where(active, a, c) for a, c in zip(pn, p))
        rz = torch.where(active, rz_new, rz)
        n = n + active.to(torch.int32)
    return x, n


def _lm_loop(step, state: tuple, num_iters: int):
    """The LM loop; the JAX loop runs while i < num_iters and not done.
    ``step(*state) -> (new_state, done, cg_iterations)``. Returns (state,
    active LM iterations, their CG iterations)."""
    dev = state[0].device
    done = torch.zeros((), dtype=torch.bool, device=dev)
    lm_n = torch.zeros((), dtype=torch.int32, device=dev)
    cg_n = torch.zeros((), dtype=torch.int32, device=dev)
    for _ in range(num_iters):
        active = ~done
        new, new_done, n_cg = step(*state)
        state = tuple(torch.where(active, a, b) for a, b in zip(new, state))
        done = done | (active & new_done)
        lm_n = lm_n + active.to(torch.int32)
        cg_n = cg_n + torch.where(active, n_cg, 0)
    return state, lm_n, cg_n


# ---------------------------------------------------------------------------
# LM solver
# ---------------------------------------------------------------------------

def bundle_adjust(cam: cam_mod.Camera, prob: BAProblem, num_iters: int = 10,
                  cg_iters: int = 40, lam0: float = 1e-3,
                  line_weight: float = 1.0, scatter_free: bool = True,
                  schur_direct: bool = False):
    """Run LM bundle adjustment; returns (R, t, points, lines_Xs, lines_Xe,
    info) with info = dict(cost0, cost, lam, lm_iters, cg_iters), all device
    tensors. ``scatter_free=False`` (the segment-sum formulation the sharded
    backend uses) and ``schur_direct=True`` (the explicit reduced camera
    system) are not ported yet."""
    if not scatter_free:
        raise NotImplementedError(
            "bundle_adjust(scatter_free=False) is the sharded backend's "
            "formulation; ROADMAP.md queue 1 item 8 (multi-device) ports it")
    if schur_direct:
        raise NotImplementedError(
            "bundle_adjust(schur_direct=True) is not on the product path; "
            "ROADMAP.md queue 1 item 9 (direct Schur BA) ports it")
    K = prob.R.shape[0]
    P = prob.points.shape[0]
    L = prob.lines_Xs.shape[0]
    has_lines = L > 0
    dev, f32 = prob.R.device, prob.R.dtype

    seg_c = _onehot_seg_reduce(prob.obs_cam, K)
    seg_p = _sorted_seg_reduce(prob.obs_pt, P)
    if has_lines:
        seg_lc = _onehot_seg_reduce(prob.lobs_cam, K)
        seg_ll = _sorted_seg_reduce(prob.lobs_line, L)

    free_c = ((~prob.fixed_cam) & prob.cam_mask).to(f32)[:, None]
    pt_m = prob.point_mask.to(f32)[:, None]
    ln_m = prob.line_mask.to(f32)[:, None]
    def chi2_pt(is_stereo):
        return torch.where(is_stereo, robust.CHI2_3D, robust.CHI2_2D)

    def robust_w(res, inv_s2, is_stereo=None):
        chi2 = (res * res).sum(-1) * inv_s2
        delta2 = robust.CHI2_2D if is_stereo is None else chi2_pt(is_stereo)
        return robust.huber_weight(chi2, delta2), chi2

    def cost_fn(R, t, points, lXs, lXe):
        res, _, _, ok, row_w, is_st = _point_terms(cam, R, t, points, prob,
                                                   jac=False)
        _, chi2 = robust_w(res * torch.sqrt(row_w), prob.obs_inv_sigma2,
                           is_st)
        c = (torch.minimum(chi2, chi2_pt(is_st) * 2.0) * ok).sum()
        n_ok = ok.sum()
        if has_lines:
            lres, _, _, lok, lrow = _line_terms(cam, R, t, lXs, lXe, prob,
                                                jac=False)
            _, lchi2 = robust_w(lres * torch.sqrt(lrow), prob.lobs_inv_sigma2)
            lthr = torch.where(lrow.sum(-1) > 2.5, 9.488, robust.CHI2_2D)
            c = c + line_weight * (torch.minimum(lchi2, lthr * 2.0)
                                   * lok).sum()
        # a state that invalidates every observation must read as infinitely
        # bad, not as a zero-cost optimum the accept test then locks in
        return torch.where(n_ok > 0, c, torch.full_like(c, float("inf")))

    def damped(Hb, lam):
        diag = torch.diagonal(Hb, dim1=-2, dim2=-1)
        return Hb + torch.diag_embed(lam * diag + 1e-8)

    def inv(H):
        eye = torch.eye(H.shape[-1], dtype=f32, device=dev)
        # inv_ex: no error check, so no host sync
        return torch.linalg.inv_ex(H + eye * 1e-8)[0]

    def lm_step(R, t, points, lXs, lXe, lam, cost_prev):
        # ---- linearize ----
        res, Jc, Jp, ok, row_w, is_st = _point_terms(cam, R, t, points, prob)
        rw, _ = robust_w(res * torch.sqrt(row_w), prob.obs_inv_sigma2, is_st)
        w = prob.obs_inv_sigma2 * rw * ok
        wr = w[:, None] * row_w                                  # [M, 3]
        if has_lines:
            lres, lJc, lJl, lok, lrow = _line_terms(cam, R, t, lXs, lXe, prob)
            lrw, _ = robust_w(lres * torch.sqrt(lrow), prob.lobs_inv_sigma2)
            lw = line_weight * prob.lobs_inv_sigma2 * lrw * lok
            lwr = lw[:, None] * lrow                             # [Ml, 4]

        # ---- gradient: b = -J^T W r (we solve H dx = b) ----
        bc = -seg_c(_JTv(Jc, wr * res))
        bp = -seg_p(_JTv(Jp, wr * res))
        if has_lines:
            bc = bc - seg_lc(_JTv(lJc, lwr * lres))
            bl = -seg_ll(_JTv(lJl, lwr * lres)) * ln_m
        else:
            bl = torch.zeros((L, 6), dtype=f32, device=dev)
        bc = bc * free_c
        bp = bp * pt_m

        # ---- block diagonal of H (damping + preconditioner) ----
        Hcc = seg_c(_JTWJ(Jc, wr))
        Hpp = seg_p(_JTWJ(Jp, wr))
        if has_lines:
            Hcc = Hcc + seg_lc(_JTWJ(lJc, lwr))
            Hll = seg_ll(_JTWJ(lJl, lwr))
            Ml_ = inv(damped(Hll, lam))
            lam_diag_l = lam * torch.diagonal(Hll, dim1=-2, dim2=-1) + 1e-8
        Mc = inv(damped(Hcc, lam))
        Mp = inv(damped(Hpp, lam))
        lam_diag_c = lam * torch.diagonal(Hcc, dim1=-2, dim2=-1) + 1e-8
        lam_diag_p = lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-8

        def matvec(xc, xp, xl):
            xc = xc * free_c
            xp = xp * pt_m
            u = (_mv(Jc, xc[prob.obs_cam]) + _mv(Jp, xp[prob.obs_pt])) * wr
            yc = seg_c(_JTv(Jc, u))
            yp = seg_p(_JTv(Jp, u))
            if has_lines:
                xl_m = xl * ln_m
                ul = (_mv(lJc, xc[prob.lobs_cam])
                      + _mv(lJl, xl_m[prob.lobs_line])) * lwr
                yc = yc + seg_lc(_JTv(lJc, ul))
                yl = seg_ll(_JTv(lJl, ul)) + lam_diag_l * xl_m
            else:
                yl = xl
            return ((yc + lam_diag_c * xc) * free_c,
                    (yp + lam_diag_p * xp) * pt_m, yl)

        def precond(rc, rp, rl):
            return (_mv(Mc, rc) * free_c, _mv(Mp, rp) * pt_m,
                    _mv(Ml_, rl) * ln_m if has_lines else rl)

        x, n_cg = _pcg(matvec, precond, (bc, bp, bl), cg_iters)
        dxc, dxp, dxl = x

        # ---- apply & accept / reject ----
        dR, dt = lie.se3_exp(dxc)
        Rn = lie.normalize_rotation(dR @ R)
        tn = _mv(dR, t) + dt
        pn_ = points + dxp
        lXsn = lXs + dxl[..., :3] if has_lines else lXs
        lXen = lXe + dxl[..., 3:] if has_lines else lXe
        cost_new = cost_fn(Rn, tn, pn_, lXsn, lXen)
        accept = cost_new < cost_prev
        out = [torch.where(accept, a, b) for a, b in
               ((Rn, R), (tn, t), (pn_, points), (lXsn, lXs), (lXen, lXe))]
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e4))
        # an accepted step with negligible relative improvement means LM has
        # converged; a rejected step keeps iterating with raised damping
        done = accept & (cost_prev - cost_new < 1e-6 * cost_prev)
        cost_prev = torch.where(accept, cost_new, cost_prev)
        return (*out, lam, cost_prev), done, n_cg

    cost0 = cost_fn(prob.R, prob.t, prob.points, prob.lines_Xs, prob.lines_Xe)
    state = (prob.R, prob.t, prob.points, prob.lines_Xs, prob.lines_Xe,
             torch.full((), lam0, dtype=f32, device=dev), cost0)
    state, lm_n, cg_n = _lm_loop(lm_step, state, num_iters)
    R, t, points, lXs, lXe, lam, cost = state
    info = {"cost0": cost0, "cost": cost, "lam": lam, "lm_iters": lm_n,
            "cg_iters": cg_n}
    return R, t, points, lXs, lXe, info
