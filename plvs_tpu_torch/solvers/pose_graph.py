"""Sim3 / SE3 pose-graph (essential graph) optimization.

Counterpart of plvs_tpu/solvers/pose_graph.py: Levenberg-Marquardt over
per-vertex Sim3 tangents (left-multiplicative updates), edge residual
log(S_ij^-1 S_i S_j^-1), the residuals of every edge in one batched pass
and their Jacobians with respect to the two endpoint tangents by forward-
mode autodiff (one dual-number pass over the edges stacked once per
tangent coordinate; the tests hold it against ``jacfwd`` under ``vmap``),
and the normal equations applied matrix-free and solved by block-Jacobi preconditioned
CG. ``fix_scale`` pins every scale update to 0 (the RGB-D / stereo SE3
graph). ``dof4_axis`` gives the 4-DoF essential graph of inertial maps:
each vertex's rotation update is projected onto its camera-frame gravity
axis (yaw and translation only) and the scale pinned.

As in ``solvers/ba.py``, the JAX ``while_loop``s (LM while not converged,
CG while the residual has not collapsed) run their full trip counts here
with a device-side ``active`` flag and ``torch.where`` updates, so a solve
reads nothing back to the host; the result is the one the early-exit loops
give. Segment sums over edges are one-hot products (vertex counts are
small), which sum in a fixed order on every device; the edge-sharded
solve (``parallel/sharded_pose_graph.py``) replaces them through
``_optimize``'s ``edges`` hook.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.autograd.forward_ad as fwAD

from ..geometry import lie
from .ba import _guard_max, _lm_loop, _onehot_seg_reduce, _pcg


class PoseGraphProblem(NamedTuple):
    R: torch.Tensor          # [K, 3, 3] world-to-local
    t: torch.Tensor          # [K, 3]
    s: torch.Tensor          # [K]
    fixed: torch.Tensor      # [K] bool
    # edges: relative measurement S_ij = S_i * S_j^-1 (i observes j)
    edge_i: torch.Tensor     # [E] int64
    edge_j: torch.Tensor     # [E] int64
    edge_R: torch.Tensor     # [E, 3, 3]
    edge_t: torch.Tensor     # [E, 3]
    edge_s: torch.Tensor     # [E]
    edge_weight: torch.Tensor  # [E]
    edge_mask: torch.Tensor  # [E] bool


def make_edges_from_poses(R, t, s, pairs):
    """Relative measurements S_ij = S_i S_j^{-1} from the current poses for
    index pairs [E, 2]."""
    i, j = pairs[:, 0], pairs[:, 1]
    Rj_inv, tj_inv, sj_inv = lie.sim3_inverse(R[j], t[j], s[j])
    return lie.sim3_compose(R[i], t[i], s[i], Rj_inv, tj_inv, sj_inv)


def _edge_residual(Ri, ti, si, Rj, tj, sj, Rij, tij, sij):
    """7D residual log(S_ij_meas^-1 * S_i * S_j^-1)."""
    Rj_inv, tj_inv, sj_inv = lie.sim3_inverse(Rj, tj, sj)
    Rp, tp, sp = lie.sim3_compose(Ri, ti, si, Rj_inv, tj_inv, sj_inv)
    Rm_inv, tm_inv, sm_inv = lie.sim3_inverse(Rij, tij, sij)
    Re, te, se = lie.sim3_compose(Rm_inv, tm_inv, sm_inv, Rp, tp, sp)
    return lie.sim3_log(Re, te, se)


def _apply_delta(R, t, s, dx, fix_scale: bool, axis=None):
    """S <- exp(dx) * S, the rotation re-orthonormalised. With ``axis``
    [..., 3] (a unit gravity direction per vertex) the rotation update is
    the rotation about it: exp(a alpha) R == R exp((R^T a) alpha) leaves
    roll and pitch alone."""
    if fix_scale or axis is not None:
        dx = torch.cat([dx[..., :6], torch.zeros_like(dx[..., 6:])], -1)
    if axis is not None:
        alpha = (dx[..., 3:6] * axis).sum(-1, keepdim=True)
        dx = torch.cat([dx[..., :3], alpha * axis, dx[..., 6:]], -1)
    dR, dt, ds = lie.sim3_exp(dx)
    Rn, tn, sn = lie.sim3_compose(dR, dt, ds, R, t, s)
    return lie.normalize_rotation(Rn), tn, sn


def _edge_fn(fix_scale: bool):
    def f(dxi, dxj, Ri, ti, si, Rj, tj, sj, Rm, tm, sm, ax_i=None,
          ax_j=None):
        Ri2, ti2, si2 = _apply_delta(Ri, ti, si, dxi, fix_scale, ax_i)
        Rj2, tj2, sj2 = _apply_delta(Rj, tj, sj, dxj, fix_scale, ax_j)
        return _edge_residual(Ri2, ti2, si2, Rj2, tj2, sj2, Rm, tm, sm)
    return f


def linearize(prob: PoseGraphProblem, R, t, s, fix_scale: bool,
              dof4_axis=None):
    """Residuals [E, 7] and their Jacobians [E, 7, 7] with respect to the
    tangents of vertex i and vertex j of each edge, at (R, t, s).

    Forward-mode autodiff in one pass: the edges are stacked 14 times, the
    k-th copy carrying the unit tangent e_k of the 14 endpoint tangent
    coordinates, so one dual-number evaluation of the batched residual
    gives every Jacobian column (what ``jacfwd`` under ``vmap`` gives,
    without its per-operation dispatch layers)."""
    ei, ej = prob.edge_i, prob.edge_j
    E = ei.shape[0]
    args = (R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], prob.edge_R,
            prob.edge_t, prob.edge_s)
    if dof4_axis is not None:
        args = args + (dof4_axis[ei], dof4_axis[ej])
    f = _edge_fn(fix_scale)
    z = torch.zeros((E, 7), dtype=R.dtype, device=R.device)
    r = f(z, z, *args)
    reps = tuple(a.repeat((14,) + (1,) * (a.dim() - 1)) for a in args)
    basis = torch.eye(14, dtype=R.dtype, device=R.device).repeat_interleave(
        E, 0)
    zz = torch.zeros((14 * E, 7), dtype=R.dtype, device=R.device)
    with fwAD.dual_level():
        out = f(fwAD.make_dual(zz, basis[:, :7]),
                fwAD.make_dual(zz, basis[:, 7:]), *reps)
        tangent = fwAD.unpack_dual(out).tangent
    J = tangent.reshape(14, E, 7).permute(1, 2, 0)
    return r, J[..., :7], J[..., 7:]


def edge_costs(prob: PoseGraphProblem, R, t, s):
    ei, ej = prob.edge_i, prob.edge_j
    r = _edge_residual(R[ei], t[ei], s[ei], R[ej], t[ej], s[ej],
                       prob.edge_R, prob.edge_t, prob.edge_s)
    return (r * r).sum(-1) * prob.edge_weight * prob.edge_mask


def optimize(prob: PoseGraphProblem, num_iters: int = 15, cg_iters: int = 50,
             fix_scale: bool = False, lam0: float = 1e-4, dof4_axis=None):
    """LM over vertex Sim3 tangents. Returns (R, t, s, info) with info =
    dict(cost0, cost, lm_iters, cg_iters), all device tensors.
    ``dof4_axis`` [K, 3]: the camera-frame gravity direction per vertex
    (the 4-DoF graph, see the module docstring)."""
    return _optimize(prob, num_iters, cg_iters, fix_scale, lam0, dof4_axis)


def _optimize(prob: PoseGraphProblem, num_iters, cg_iters, fix_scale, lam0,
              dof4_axis, edges=None):
    """``optimize``; ``edges`` = (seg_i, seg_j, total) replaces the sums
    over the edge rows (the segment sums into the edges' two vertices and
    the cost's plain sum), the edge-sharded solve's hook."""
    K = prob.R.shape[0]
    dev, f32 = prob.R.device, prob.R.dtype
    free = (~prob.fixed).to(f32)[:, None]
    w = prob.edge_weight * prob.edge_mask
    if edges is None:
        edges = (_onehot_seg_reduce(prob.edge_i, K),
                 _onehot_seg_reduce(prob.edge_j, K), torch.sum)
    seg_i, seg_j, total = edges
    eye = torch.eye(7, dtype=f32, device=dev)

    def cost_of(R, t, s):
        return total(edge_costs(prob, R, t, s))

    def lm_step(R, t, s, lam, cost_prev):
        r, Ji, Jj = linearize(prob, R, t, s, fix_scale, dof4_axis)
        # gradient b = -J^T W r
        b = -(seg_i(((Ji * r[..., None]).sum(-2)) * w[:, None])
              + seg_j(((Jj * r[..., None]).sum(-2)) * w[:, None])) * free
        Hd = (seg_i((Ji.transpose(-1, -2) @ Ji) * w[:, None, None])
              + seg_j((Jj.transpose(-1, -2) @ Jj) * w[:, None, None]))
        lam_diag = lam * torch.diagonal(Hd, dim1=-2, dim2=-1) + 1e-8
        M = torch.linalg.inv_ex(Hd + lam_diag[..., None] * eye
                                + 1e-8 * eye)[0]

        def matvec(x):
            x = x * free
            u = ((Ji @ x[prob.edge_i][..., None])[..., 0]
                 + (Jj @ x[prob.edge_j][..., None])[..., 0]) * w[:, None]
            y = (seg_i((Ji * u[..., None]).sum(-2))
                 + seg_j((Jj * u[..., None]).sum(-2)))
            return ((y + lam_diag * x) * free,)

        def precond(rr):
            return ((M @ rr[..., None])[..., 0] * free,)

        (x,), n_cg = _pcg(matvec, precond, (b,), cg_iters, guard=_guard_max)
        Rn, tn, sn = _apply_delta(R, t, s, x, fix_scale, dof4_axis)
        cost_new = cost_of(Rn, tn, sn)
        accept = cost_new < cost_prev
        R = torch.where(accept, Rn, R)
        t = torch.where(accept, tn, t)
        s = torch.where(accept, sn, s)
        lam = torch.where(accept, torch.clamp(lam * 0.5, min=1e-8),
                          torch.clamp(lam * 4.0, max=1e3))
        done = accept & (cost_prev - cost_new < 1e-8 * cost_prev)
        cost_prev = torch.where(accept, cost_new, cost_prev)
        return (R, t, s, lam, cost_prev), done, n_cg

    cost0 = cost_of(prob.R, prob.t, prob.s)
    state = (prob.R, prob.t, prob.s, torch.full((), lam0, dtype=f32,
                                                device=dev), cost0)
    (R, t, s, _, cost), lm_n, cg_n = _lm_loop(lm_step, state, num_iters)
    return R, t, s, {"cost0": cost0, "cost": cost, "lm_iters": lm_n,
                     "cg_iters": cg_n}
