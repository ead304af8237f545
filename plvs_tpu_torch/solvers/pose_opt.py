"""Pose-only optimization (motion-only bundle adjustment).

Counterpart of plvs_tpu/solvers/pose_opt.py: 4 rounds of robust
Gauss-Newton with point (mono / stereo uR) and line (point-to-infinite-
line) unary terms, analytic Jacobians (``cameras.project_jac``), chi2
in/outlier re-classification between rounds, the Huber kernel dropped in
the last round, and an optional SE3 prior. Each round stops, as the JAX
``while_loop`` does, once the step is negligible.

* CUDA tensors: the hand-written kernel in ``csrc/pose_opt.cu``, one
  launch a whole solve, no host read.
* CPU tensors: :func:`pose_optimize_plain`, the eager loop (one host read
  of the step norm per iteration).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..geometry import cameras as cam_mod
from ..geometry import lie
from ..ops import _build
from . import robust

# pose solves on either path; the Gauss-Newton iterations the plain path
# ran (the one whose step met the exit included); launches of the kernel,
# whose iterations add up on the device (iteration_count() reads both)
solves = 0
iterations = 0
kernel_solves = 0
_kernel_iterations: dict = {}


def iteration_count() -> int:
    """Gauss-Newton iterations run so far on both paths: ``iterations``
    plus the kernel's device counters (one host read a device)."""
    return iterations + sum(int(c.item())
                            for c in _kernel_iterations.values())


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


def empty_lines(dtype=torch.float32, device=None):
    """An empty line block: (Xs, Xe, nld [0, 3], inv_sigma2 [0], mask [0])."""
    z3 = torch.zeros((0, 3), dtype=dtype, device=device)
    return (z3, z3, z3, torch.zeros((0,), dtype=dtype, device=device),
            torch.zeros((0,), dtype=torch.bool, device=device))


def make_pose_obs(Xw, uvr, inv_sigma2, mask, line_Xs=None, line_Xe=None,
                  line_nld=None, line_inv_sigma2=None,
                  line_mask=None) -> PoseObs:
    """The observation block. Masked line rows get a zero line and a zero
    weight: a keyline slot the detector left empty carries non-finite
    endpoints, and 0 x NaN in the normal equations would turn the whole
    pose NaN (the JAX package keeps them, and loses such frames)."""
    if line_Xs is None:
        line_Xs, line_Xe, line_nld, line_inv_sigma2, line_mask = \
            empty_lines(Xw.dtype, Xw.device)
    else:
        line_nld = torch.where(line_mask[:, None], line_nld,
                               torch.zeros_like(line_nld))
        line_inv_sigma2 = torch.where(line_mask, line_inv_sigma2,
                                      torch.zeros_like(line_inv_sigma2))
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

    CPU tensors take :func:`pose_optimize_plain`; CUDA tensors the kernel,
    which takes float32 only and raises on anything else.

    Returns (R, t, point_inlier_mask, line_inlier_mask, num_inliers)."""
    dev = obs.Xw.device
    if dev.type == "cpu":
        return pose_optimize_plain(cam, R0, t0, obs, rounds, iters_per_round,
                                   line_weight, prior_R, prior_t, prior_info)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return _pose_optimize_kernel(cam, R0, t0, obs, rounds, iters_per_round,
                                 line_weight, prior_R, prior_t, prior_info)


def pose_optimize_plain(cam: cam_mod.Camera, R0: torch.Tensor,
                        t0: torch.Tensor, obs: PoseObs, rounds: int = 4,
                        iters_per_round: int = 10, line_weight: float = 1.0,
                        prior_R=None, prior_t=None, prior_info=None):
    """The plain PyTorch version of :func:`pose_optimize`: the eager loop,
    on any device."""
    global solves, iterations
    solves += 1
    has_prior = prior_info is not None
    has_lines = obs.line_Xs.shape[0] > 0
    eye6 = torch.eye(6, dtype=R0.dtype, device=R0.device)
    R, t = R0, t0
    in_pts = obs.mask
    in_lines = obs.line_mask
    for round_idx in range(rounds):
        use_robust = round_idx < rounds - 1
        for _ in range(iters_per_round):
            iterations += 1
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


def _check(cam: cam_mod.Camera, R0, t0, obs: PoseObs, prior_R, prior_t,
           prior_info) -> None:
    """Raise on what the kernel does not take: a dtype other than float32
    (bool for the masks), a wrong shape, or tensors on several devices."""
    n, nl = obs.Xw.shape[0], obs.line_Xs.shape[0]
    want = {"R0": (R0, (3, 3)), "t0": (t0, (3,)), "Xw": (obs.Xw, (n, 3)),
            "uvr": (obs.uvr, (n, 3)), "inv_sigma2": (obs.inv_sigma2, (n,)),
            "mask": (obs.mask, (n,)), "line_Xs": (obs.line_Xs, (nl, 3)),
            "line_Xe": (obs.line_Xe, (nl, 3)),
            "line_nld": (obs.line_nld, (nl, 3)),
            "line_inv_sigma2": (obs.line_inv_sigma2, (nl,)),
            "line_mask": (obs.line_mask, (nl,))}
    # prior_R / prior_t without prior_info are ignored, as by the plain loop
    if prior_info is not None:
        if prior_R is None or prior_t is None:
            raise ValueError("prior_info needs prior_R and prior_t")
        want.update(prior_R=(prior_R, (3, 3)), prior_t=(prior_t, (3,)),
                    prior_info=(prior_info, (6, 6)))
    dev = obs.Xw.device
    for name, (x, shape) in want.items():
        dtype = torch.bool if name.endswith("mask") else torch.float32
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {list(shape)} {dtype}, got "
                             f"{list(x.shape)} {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, Xw on {dev}")
    if cam.kind not in (cam_mod.PINHOLE, cam_mod.KANNALA_BRANDT8):
        raise ValueError(f"unsupported camera kind {cam.kind}")


def _pose_optimize_kernel(cam, R0, t0, obs: PoseObs, rounds, iters_per_round,
                          line_weight, prior_R, prior_t, prior_info):
    """One launch of ``csrc/pose_opt.cu``: the whole solve on the card,
    on the current stream, with no host read."""
    global solves, kernel_solves
    _check(cam, R0, t0, obs, prior_R, prior_t, prior_info)
    dev = obs.Xw.device
    n, nl = obs.Xw.shape[0], obs.line_Xs.shape[0]
    ins = [x.contiguous() for x in (
        obs.Xw, obs.uvr, obs.inv_sigma2, obs.mask, obs.line_Xs, obs.line_Xe,
        obs.line_nld, obs.line_inv_sigma2, obs.line_mask, R0, t0)]
    prior = ([x.contiguous() for x in (prior_R, prior_t, prior_info)]
             if prior_info is not None else [])
    R = torch.empty((3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((3,), dtype=torch.float32, device=dev)
    in_pts = torch.empty((n,), dtype=torch.bool, device=dev)
    in_lines = torch.empty((nl,), dtype=torch.bool, device=dev)
    num = torch.empty((), dtype=torch.int64, device=dev)
    acc = _kernel_iterations.get(dev)
    if acc is None:
        acc = _kernel_iterations[dev] = torch.zeros(
            (1,), dtype=torch.int64, device=dev)
    params = (ctypes.c_float * 9)(*(list(cam.params) + [0.0] * 9)[:9])
    ptr = [x.data_ptr() for x in ins]
    pp = [x.data_ptr() for x in prior] or [None] * 3
    err = _lib().plvs_pose_solve(
        *ptr[:4], n, *ptr[4:9], nl, ptr[9], ptr[10], *pp, cam.kind, params,
        cam.bf, rounds, iters_per_round, line_weight, R.data_ptr(),
        t.data_ptr(), in_pts.data_ptr(), in_lines.data_ptr(), num.data_ptr(),
        acc.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "pose solve kernel")
    solves += 1
    kernel_solves += 1
    return R, t, in_pts, in_lines, num


def _lib():
    lib = _build.load("pose_opt")
    fn = lib.plvs_pose_solve
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.restype = i
        fn.argtypes = [p, p, p, p, i, p, p, p, p, p, i, p, p, p, p, p, i,
                       ctypes.POINTER(f), f, i, i, f, p, p, p, p, p, p, p]
    return lib
