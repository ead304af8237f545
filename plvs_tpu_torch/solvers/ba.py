"""Bundle adjustment as a batched Levenberg-Marquardt solver.

Counterpart of the product path of plvs_tpu/solvers/ba.py: SE3 poses, 3D
points and 3D line endpoints with Huber kernels, the normal equations
applied matrix-free (per-observation Jacobian blocks evaluated in one
batched pass; H @ x is two gathers and two segment sums) and solved by
block-Jacobi preconditioned conjugate gradient inside an LM trust loop.

Segment sums take one of the JAX package's two formulations. With
``scatter_free=True`` (the default here, the product path) points and lines
sort once and reduce by a cumulative sum read at two ``searchsorted``
boundaries, cameras by a one-hot product: the same order on every run. With
``scatter_free=False`` every segment sum is ``index_add_`` into zeros
(``jax.ops.segment_sum``), which on CUDA adds by atomics in an order that
changes from run to run; it is the formulation the sharded backend
(``parallel/sharded_ba.py``) splits by shard. ``schur_direct=True``
preconditions the CG by the explicit reduced camera system (see
``bundle_adjust``).

The JAX ``while_loop``s stop on device values (the CG residual, the LM
convergence flag). Reading those back every iteration would cost up to
5 x (14 + 1) host syncs a solve, so both loops here run their full trip
counts and carry a device-side ``active`` flag instead: every state update
is ``torch.where(active, new, old)``. Once a loop would have stopped its
state no longer changes, so the result is the one the ``while_loop`` gives,
and the solve reads nothing back to the host. ``info`` also carries the LM
and CG iterations that were active.

Where a solve runs (:func:`bundle_adjust`):

* CUDA float32 tensors in the local BA's formulation (``scatter_free=True``,
  ``schur_direct=False``): the hand-written kernel in ``csrc/ba_lm.cu``, one
  launch a whole solve, no host read; the wrapper orders the rows once (one
  stable sort of their keys and the CSR offsets of every block).
* CPU tensors, ``scatter_free=False``, ``schur_direct=True`` and the
  sharded backend's hook (``_bundle_adjust(obs=...)``):
  :func:`bundle_adjust_plain`, the eager loops below.

Fixed-capacity convention: arrays are padded; masks mark real entries;
fixed cameras (the gauge) are masked through ``fixed_cam``. Index columns
are int64 (the JAX package's are int32).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..geometry import cameras as cam_mod
from ..geometry import lie
from ..ops import _build
from . import robust

# solves on every path and launches of the kernel; the LM and CG iterations
# of every solve add up on the device, one counter a device
# (iteration_count() reads them)
solves = 0
kernel_solves = 0
_iterations: dict = {}


def iteration_count() -> tuple[int, int]:
    """LM and CG iterations run so far on every path (one host read a
    device)."""
    lm = cg = 0
    for acc in _iterations.values():
        a, b = acc.tolist()
        lm, cg = lm + a, cg + b
    return lm, cg


def _counter(dev: torch.device) -> torch.Tensor:
    acc = _iterations.get(dev)
    if acc is None:
        acc = _iterations[dev] = torch.zeros((2,), dtype=torch.int64,
                                             device=dev)
    return acc


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

def _point_terms(cam, R, t, points, prob: BAProblem, jac: bool = True,
                 gather_p=None):
    """Residual [M, 3], Jc [M, 3, 6], Jp [M, 3, 3], validity [M], row
    weights [M, 3], is_stereo [M] (Jacobians None when ``jac`` is False).
    ``gather_p`` reads each observation's point (``points[obs_pt]`` when
    None)."""
    Rm = R[prob.obs_cam]
    Xw = points[prob.obs_pt] if gather_p is None else gather_p(points)
    Xc = _mv(Rm, Xw) + t[prob.obs_cam]
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


def _index_add_reduce(idx: torch.Tensor, num_segments: int):
    """``jax.ops.segment_sum``: ``index_add_`` into zeros (on CUDA by
    atomics, so the float32 sum order changes from run to run)."""
    def reduce(v):
        return torch.zeros((num_segments,) + v.shape[1:], dtype=v.dtype,
                           device=v.device).index_add_(0, idx, v)

    return reduce


def _sorted_seg_reduce_exact(idx: torch.Tensor, num_segments: int):
    """Segment sum whose accumulator resets at every segment head, so each
    segment's error is about eps x its own sum (the cumulative-sum trick
    carries eps x the global sum): the exact Schur assembly needs it. The
    JAX package runs a segmented associative scan; here the values sort
    once by segment (stable) and ``torch.segment_reduce`` sums each
    segment's run in a fixed order on the CPU and on CUDA alike (no
    atomics), so every run gives the same sums. Empty segments read 0."""
    order = torch.argsort(idx, stable=True)
    idx_s = idx[order]
    seg = torch.arange(num_segments, dtype=idx.dtype, device=idx.device)
    lengths = (torch.searchsorted(idx_s, seg, right=True)
               - torch.searchsorted(idx_s, seg))

    def reduce(v):
        # unsafe: the lengths sum to the row count by construction, and
        # their check would read them back to the host
        return torch.segment_reduce(v[order], "sum", lengths=lengths, axis=0,
                                    unsafe=True)

    return reduce


class Reductions(NamedTuple):
    """How a solve sums over its observation rows: the segment sums of the
    point observations into cameras (``seg_c``) and points (``seg_p``),
    their gather of point blocks (``gather_p``: x [P, ...] -> [M, ...]),
    the plain sum of a per-observation quantity (``total``: the cost), and
    the line observations' segment sums into cameras (``seg_lc``) and lines
    (``seg_ll``). The sharded backend replaces the first four
    (``parallel/sharded_ba.py``)."""

    seg_c: object
    seg_p: object
    gather_p: object
    total: object
    seg_lc: object
    seg_ll: object


def _reductions(prob: BAProblem, scatter_free: bool,
                obs: tuple | None = None) -> Reductions:
    """The solve's segment sums in the ``scatter_free`` formulation; the
    point observations' (seg_c, seg_p, gather_p, total) from ``obs`` when
    the caller gives them."""
    K, P, L = prob.R.shape[0], prob.points.shape[0], prob.lines_Xs.shape[0]
    cams, pts = ((_onehot_seg_reduce, _sorted_seg_reduce) if scatter_free
                 else (_index_add_reduce, _index_add_reduce))
    if obs is None:
        obs = (cams(prob.obs_cam, K), pts(prob.obs_pt, P),
               lambda x: x[prob.obs_pt], lambda v: v.sum())
    lines = ((cams(prob.lobs_cam, K), pts(prob.lobs_line, L)) if L > 0
             else (None, None))
    return Reductions(*obs, *lines)


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
    tensors.

    CUDA tensors with ``scatter_free=True`` and ``schur_direct=False`` take
    the kernel, which takes float32 only and raises on anything else; every
    other call takes :func:`bundle_adjust_plain` (module docstring).

    ``scatter_free=False`` takes the segment-sum formulation (module
    docstring). ``schur_direct=True`` builds the explicit reduced camera
    system each LM step: Jacobi scaling of every block to unit diagonal,
    symmetrised block inverses of the landmarks, the dense [P, K, 6, 3]
    camera-point coupling, the Schur complement S = Hcc - Y Hpp^-1 Y^T with
    a 1e-4 ridge and unit rows for fixed cameras, its Cholesky factor, then
    the camera solve and the landmarks' back substitution. That solve
    preconditions at most 10 CG iterations on the exact matrix-free
    operator. Its memory grows with P x K: keep it to windowed problems
    (K up to ~64), as the JAX package does. A factor that is not positive
    definite reads NaN (as ``cho_factor`` does), and the LM rejects the
    step."""
    dev = prob.R.device
    if dev.type == "cuda" and scatter_free and not schur_direct:
        return _bundle_adjust_kernel(cam, prob, num_iters, cg_iters, lam0,
                                     line_weight)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return bundle_adjust_plain(cam, prob, num_iters, cg_iters, lam0,
                               line_weight, scatter_free, schur_direct)


def bundle_adjust_plain(cam: cam_mod.Camera, prob: BAProblem,
                        num_iters: int = 10, cg_iters: int = 40,
                        lam0: float = 1e-3, line_weight: float = 1.0,
                        scatter_free: bool = True,
                        schur_direct: bool = False):
    """The plain PyTorch version of :func:`bundle_adjust`: the eager loops,
    on any device."""
    return _bundle_adjust(cam, prob, num_iters, cg_iters, lam0, line_weight,
                          scatter_free, schur_direct)


def _bundle_adjust(cam, prob: BAProblem, num_iters, cg_iters, lam0,
                   line_weight, scatter_free, schur_direct, obs=None):
    """``bundle_adjust``; ``obs`` replaces the point observations' row
    reductions (:class:`Reductions`), the sharded backend's hook."""
    global solves
    K = prob.R.shape[0]
    P = prob.points.shape[0]
    L = prob.lines_Xs.shape[0]
    has_lines = L > 0
    dev, f32 = prob.R.device, prob.R.dtype
    red = _reductions(prob, scatter_free, obs)
    seg_c, seg_p, seg_lc, seg_ll = red.seg_c, red.seg_p, red.seg_lc, red.seg_ll
    if schur_direct:
        # the exact reducer on every side of the assembly: the one-hot
        # product's float32 accumulation (~4e-4 relative, the JAX package
        # measured) suits the CG's preconditioner but drowns the reduced
        # system's small (~lam) eigenvalues
        seg_cp = _sorted_seg_reduce_exact(prob.obs_pt * K + prob.obs_cam,
                                          P * K)
        seg_c_x = _sorted_seg_reduce_exact(prob.obs_cam, K)
        seg_p_x = _sorted_seg_reduce_exact(prob.obs_pt, P)
        if has_lines:
            seg_cl = _sorted_seg_reduce_exact(
                prob.lobs_line * K + prob.lobs_cam, L * K)
            seg_lc_x = _sorted_seg_reduce_exact(prob.lobs_cam, K)
            seg_ll_x = _sorted_seg_reduce_exact(prob.lobs_line, L)

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
        res, _, _, ok, row_w, is_st = _point_terms(
            cam, R, t, points, prob, jac=False, gather_p=red.gather_p)
        _, chi2 = robust_w(res * torch.sqrt(row_w), prob.obs_inv_sigma2,
                           is_st)
        c = red.total(torch.minimum(chi2, chi2_pt(is_st) * 2.0) * ok)
        n_ok = red.total(ok.to(f32))
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

    def sym_inv(H):
        """The symmetrised inverse: a float32 inverse of a near-singular
        block carries an asymmetric error that would cost S its
        positive definiteness."""
        Hi = torch.linalg.inv_ex(H)[0]
        return 0.5 * (Hi + Hi.transpose(-1, -2))

    def jacobi(Hd):
        return torch.rsqrt(torch.clamp(torch.diagonal(Hd, dim1=-2, dim2=-1),
                                       min=1e-12))

    def lm_step(R, t, points, lXs, lXe, lam, cost_prev):
        # ---- linearize ----
        res, Jc, Jp, ok, row_w, is_st = _point_terms(
            cam, R, t, points, prob, gather_p=red.gather_p)
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
            u = (_mv(Jc, xc[prob.obs_cam]) + _mv(Jp, red.gather_p(xp))) * wr
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

        if schur_direct:
            # ---- the explicit reduced camera system as the preconditioner
            # (float32 throughout: with TF32 the coupling products' error
            # would wreck S as the one-hot sums' would) ----
            bc_x = -seg_c_x(_JTv(Jc, wr * res))
            Hcc_x = seg_c_x(_JTWJ(Jc, wr))
            bp_x = -seg_p_x(_JTv(Jp, wr * res)) * pt_m
            Hpp_x = seg_p_x(_JTWJ(Jp, wr))
            if has_lines:
                bc_x = bc_x - seg_lc_x(_JTv(lJc, lwr * lres))
                Hcc_x = Hcc_x + seg_lc_x(_JTWJ(lJc, lwr))
                bl_x = -seg_ll_x(_JTv(lJl, lwr * lres)) * ln_m
                Hll_dx = damped(seg_ll_x(_JTWJ(lJl, lwr)), lam)
            else:
                bl_x = bl
            bc_x = bc_x * free_c
            Hcc_dx = damped(Hcc_x, lam)
            Hpp_dx = damped(Hpp_x, lam)
            # Jacobi scaling: every block at unit diagonal bounds the
            # scaled Hpp's condition by ~1/lam and keeps S's entries O(1)
            dc, dp = jacobi(Hcc_dx), jacobi(Hpp_dx)
            A = Hcc_dx * dc[:, :, None] * dc[:, None, :]
            Mp_s = sym_inv(Hpp_dx * dp[:, :, None] * dp[:, None, :])
            # Y[p, k] = sum over p's observations in camera k of Jc^T W Jp
            JcWJp = (Jc * wr[..., None]).transpose(-1, -2) @ Jp   # [M, 6, 3]
            Y = (seg_cp(JcWJp.reshape(-1, 18)).reshape(P, K, 6, 3)
                 * dc[None, :, :, None] * dp[:, None, None, :])
            T = torch.einsum("pkac,pcd->pkad", Y, Mp_s)
            U = torch.einsum("pkad,plbd->kalb", T, Y)              # [K,6,K,6]
            if has_lines:
                dl = jacobi(Hll_dx)
                Ml_s = sym_inv(Hll_dx * dl[:, :, None] * dl[:, None, :])
                JcWJl = (lJc * lwr[..., None]).transpose(-1, -2) @ lJl
                Yl = (seg_cl(JcWJl.reshape(-1, 36)).reshape(L, K, 6, 6)
                      * dc[None, :, :, None] * dl[:, None, None, :])
                Tl = torch.einsum("lkab,lbc->lkac", Yl, Ml_s)
                U = U + torch.einsum("lkac,lnbc->kanb", Tl, Yl)
            eyeK = torch.eye(K, dtype=f32, device=dev)
            S = (torch.einsum("kab,kl->kalb", A, eyeK) - U).reshape(
                6 * K, 6 * K)
            S = 0.5 * (S + S.T) + 1e-4 * torch.eye(6 * K, dtype=f32,
                                                   device=dev)
            # fixed cameras: zero rows and columns, unit diagonal, so the
            # factor stays positive definite and their solution is 0
            ff = free_c[:, 0].repeat_interleave(6)
            S = S * ff[:, None] * ff[None, :] + torch.diag(1.0 - ff)
            # cholesky_ex: no error check, so no host sync; a factor that
            # failed reads NaN, as the JAX package's cho_factor gives it
            Lc, fail = torch.linalg.cholesky_ex(S)
            Lc = torch.where(fail == 0, Lc, torch.full_like(Lc, float("nan")))

            def schur_solve(rc, rp, rl):
                """(H + lam D)^-1 approximately, through the factor:
                forward-reduce, camera solve, back-substitute."""
                rc_s, rp_s = rc * dc, rp * dp
                rt = rc_s - torch.einsum("pkad,pd->ka", T, rp_s)
                if has_lines:
                    rl_s = rl * dl
                    rt = rt - torch.einsum("lkab,lb->ka", Tl, rl_s)
                xc_s = torch.cholesky_solve(
                    (rt.reshape(6 * K) * ff)[:, None], Lc)[:, 0].reshape(
                        K, 6) * free_c
                xp = dp * _mv(Mp_s, rp_s - torch.einsum("pkac,ka->pc", Y,
                                                        xc_s)) * pt_m
                if has_lines:
                    xl = dl * _mv(Ml_s, rl_s - torch.einsum(
                        "lkac,ka->lc", Yl, xc_s)) * ln_m
                else:
                    xl = rl
                return xc_s * dc, xp, xl

            # CG on the exact operator, preconditioned by the factor: its
            # float32 error (~1e-2 relative through the inverses) would spoil
            # a direct step, but CG's descent holds whatever the error
            x, n_cg = _pcg(matvec, schur_solve, (bc_x, bp_x, bl_x),
                           min(cg_iters, 10))
        else:
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
    solves += 1
    _counter(dev).add_(torch.stack([lm_n, cg_n]).to(torch.int64))
    return R, t, points, lXs, lXe, info


# ---------------------------------------------------------------------------
# the kernel (csrc/ba_lm.cu)
# ---------------------------------------------------------------------------

def _row_order(prob: BAProblem):
    """Every row table ordered by its landmark and by its camera, for the
    kernel's segment sums: one stable sort of the rows' keys (the point
    rows' points, then their cameras, then the line rows' lines and their
    cameras, each key range after the one before) and the CSR offsets of
    every key. Returns (order [2M + 2Ml] int64: positions in that key
    vector, offsets [P + 2K + L + 1] int64). Line rows count only where the
    problem has lines (as in the plain solve)."""
    K, P, L = prob.R.shape[0], prob.points.shape[0], prob.lines_Xs.shape[0]
    keys = [prob.obs_pt, prob.obs_cam + P]
    if L > 0:
        keys += [prob.lobs_line + (P + K), prob.lobs_cam + (P + K + L)]
    # int32 keys: half the radix passes of int64 ones
    sorted_keys, order = torch.sort(torch.cat(keys).to(torch.int32),
                                    stable=True)
    off = torch.searchsorted(sorted_keys, torch.arange(
        P + 2 * K + L + 1, dtype=torch.int32, device=prob.R.device))
    return order, off


_KERNEL_FLOATS = ("R", "t", "points", "obs_uvr", "obs_inv_sigma2",
                  "lines_Xs", "lines_Xe", "lobs_nld", "lobs_inv_sigma2",
                  "lobs_depth")
_KERNEL_INDICES = ("obs_cam", "obs_pt", "lobs_cam", "lobs_line")


def _check(cam: cam_mod.Camera, prob: BAProblem) -> None:
    """Raise on what the kernel does not take: a dtype other than float32
    (bool for the masks, int64 for the index columns), a wrong shape, or
    tensors on several devices."""
    K, P, M = prob.R.shape[0], prob.points.shape[0], prob.obs_cam.shape[0]
    L, Ml = prob.lines_Xs.shape[0], prob.lobs_cam.shape[0]
    want = {"R": (K, 3, 3), "t": (K, 3), "fixed_cam": (K,),
            "cam_mask": (K,), "points": (P, 3), "point_mask": (P,),
            "obs_cam": (M,), "obs_pt": (M,), "obs_uvr": (M, 3),
            "obs_inv_sigma2": (M,), "obs_mask": (M,), "lines_Xs": (L, 3),
            "lines_Xe": (L, 3), "line_mask": (L,), "lobs_cam": (Ml,),
            "lobs_line": (Ml,), "lobs_nld": (Ml, 3),
            "lobs_inv_sigma2": (Ml,), "lobs_mask": (Ml,),
            "lobs_depth": (Ml, 2)}
    dev = prob.R.device
    for name, shape in want.items():
        x = getattr(prob, name)
        dtype = (torch.float32 if name in _KERNEL_FLOATS else torch.int64
                 if name in _KERNEL_INDICES else torch.bool)
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {list(shape)} {dtype}, got "
                             f"{list(x.shape)} {x.dtype}")
        if x.device != dev:
            raise ValueError(f"{name} on {x.device}, R on {dev}")
    if cam.kind not in (cam_mod.PINHOLE, cam_mod.KANNALA_BRANDT8):
        raise ValueError(f"unsupported camera kind {cam.kind}")


def _bundle_adjust_kernel(cam, prob: BAProblem, num_iters, cg_iters, lam0,
                          line_weight):
    """One launch of ``csrc/ba_lm.cu``: the whole solve on the card, on the
    current stream, with no host read."""
    global solves, kernel_solves
    _check(cam, prob)
    dev = prob.R.device
    K, P, M = prob.R.shape[0], prob.points.shape[0], prob.obs_cam.shape[0]
    L = prob.lines_Xs.shape[0]
    Ml = prob.lobs_cam.shape[0] if L > 0 else 0
    order, off = _row_order(prob)
    lib = _lib()
    f32 = dict(dtype=torch.float32, device=dev)
    out = [torch.empty((K, 3, 3), **f32), torch.empty((K, 3), **f32),
           torch.empty((P, 3), **f32), torch.empty((L, 3), **f32),
           torch.empty((L, 3), **f32)]
    info_f = torch.empty((3,), **f32)
    info_i = torch.empty((2,), dtype=torch.int32, device=dev)
    ws = torch.empty((lib.plvs_ba_workspace_floats(K, P, M, L, Ml),), **f32)
    ins = [x.contiguous() for x in (
        prob.R, prob.t, prob.fixed_cam, prob.cam_mask, prob.points,
        prob.point_mask, prob.obs_cam, prob.obs_pt, prob.obs_uvr,
        prob.obs_inv_sigma2, prob.obs_mask, prob.lines_Xs, prob.lines_Xe,
        prob.line_mask, prob.lobs_cam, prob.lobs_line, prob.lobs_nld,
        prob.lobs_inv_sigma2, prob.lobs_mask, prob.lobs_depth)]
    tensors = ins + [order, off, ws] + out + [info_f, info_i, _counter(dev)]
    ptr = (ctypes.c_uint64 * len(tensors))(*(x.data_ptr() for x in tensors))
    dims = (ctypes.c_int * 8)(K, P, M, L, Ml, cam.kind, num_iters, cg_iters)
    bf_line = cam.bf if cam.bf > 0 else float(cam.params[0]) * 0.1
    fp = (ctypes.c_float * 13)(*(list(cam.params) + [0.0] * 9)[:9], cam.bf,
                               bf_line, lam0, line_weight)
    err = lib.plvs_ba_solve(ptr, dims, fp,
                            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "bundle adjustment kernel")
    solves += 1
    kernel_solves += 1
    info = {"cost0": info_f[0], "cost": info_f[1], "lam": info_f[2],
            "lm_iters": info_i[0], "cg_iters": info_i[1]}
    return (*out, info)


def _lib():
    lib = _build.load("ba_lm")
    if lib.plvs_ba_solve.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.plvs_ba_workspace_floats.restype = ctypes.c_longlong
        lib.plvs_ba_workspace_floats.argtypes = [i, i, i, i, i]
        lib.plvs_ba_solve.restype = i
        lib.plvs_ba_solve.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.POINTER(i),
                                      ctypes.POINTER(ctypes.c_float), p]
    return lib
