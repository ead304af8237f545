"""Visual-inertial initialization: gravity direction, scale, biases and
velocities from visually tracked keyframe poses and their IMU
preintegrations.

Counterpart of plvs_tpu/imu/initialization.py (the reference's
LocalMapping::InitializeIMU and its inertial-only optimizations): a fixed
number of Gauss-Newton steps over theta = [gravity direction (2), log
scale, gyro bias (3), acc bias (3), per-keyframe velocities (3K)] with the
poses held fixed, consecutive preintegration residuals whitened by the
covariance diagonal, composed long-baseline rotation edges (dyadic strides)
for the gyro bias, and bias priors.

The JAX package takes the Jacobian with ``jacfwd`` of the stacked
residual. Here the residual is written batched over a leading axis of
theta, and one forward-mode dual pass over theta repeated once per
coordinate gives every column. The chain is padded as the JAX package's
entry point pads it (identity poses and no-op preintegrations up to a
power-of-two length, masked through ``k_real``), because the padded length
sets the composed rotation levels and the velocity block.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import lie
from ..solvers.autodiff import jacobian
from . import preintegration as pre


class InertialInit(NamedTuple):
    gravity: torch.Tensor     # [3] world gravity (norm 9.81)
    scale: torch.Tensor       # [] metric scale correction of the visual map
    bias_gyro: torch.Tensor   # [3]
    bias_acc: torch.Tensor    # [3]
    velocities: torch.Tensor  # [K, 3] world-frame body velocities
    residual_norm: torch.Tensor


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _const(vals, like: torch.Tensor) -> torch.Tensor:
    """A small constant vector on ``like``'s device, made from the identity
    scaled by each value (exact): no host-to-device copy, which would
    synchronise inside a solve."""
    eye = torch.eye(len(vals), dtype=like.dtype, device=like.device)
    return sum(v * eye[i] for i, v in enumerate(vals))


def _gravity_from_dirs(rxy: torch.Tensor, R0: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """2-dof gravity: the nominal -z gravity rotated by a zero-yaw rotation
    exp([rxy, 0]), then by the coarse estimate R0. rxy [..., 2]."""
    Rg = lie.so3_exp(torch.cat([rxy, torch.zeros_like(rxy[..., :1])], -1))
    g = _mv(Rg, _const((0.0, 0.0, -9.81), rxy))
    return g if R0 is None else _mv(R0, g)


def _rotation_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation taking unit vector a to unit vector b (Rodrigues; a fixed
    axis in the antiparallel case)."""
    v = torch.linalg.cross(a, b)
    c = (a * b).sum()
    s2 = (v * v).sum()
    V = lie.hat(v)
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    R = eye + V + V @ V * ((1 - c) / torch.clamp(s2, min=1e-12))
    R_anti = lie.so3_exp(_const((np.pi, 0.0, 0.0), a))
    return torch.where(s2 < 1e-12, torch.where(c > 0, eye, R_anti), R)


def inertial_only_optimize(R_wb: torch.Tensor, p_wb: torch.Tensor,
                           preints: pre.Preintegrated,
                           fix_scale: bool = False, iters: int = 20,
                           prior_gyro: float = 1e2, prior_acc: float = 1e0,
                           k_real: int | None = None) -> InertialInit:
    """Estimate (gravity, scale, biases, velocities) with the poses fixed.
    ``preints`` is stacked with a leading [K-1] axis; ``k_real`` is the
    real chain length (the padded tail is masked out of every residual)."""
    K = R_wb.shape[0]
    dev, f32 = R_wb.device, R_wb.dtype
    if k_real is None:
        k_real = K
    edge_valid = (torch.arange(K - 1, device=dev) < (k_real - 1)).to(f32)
    n = 9 + 3 * K

    # coarse gravity direction from the preintegrated velocity deltas
    dirG = -(_mv(R_wb[:-1], preints.dV) * edge_valid[:, None]).sum(0)
    dirG = dirG / (torch.linalg.norm(dirG) + 1e-9)
    R0_g = _rotation_between(_const((0.0, 0.0, -1.0), dirG), dirG)

    # composed long-baseline rotation edges (dyadic strides): the gyro-bias
    # signal grows with the baseline, the visual noise stays at the ends
    sigma_vis2 = torch.full((), 1e-3, dtype=f32, device=dev) ** 2
    rot_levels = []
    R_s, J_s = preints.dR, preints.JRg
    c_s = torch.diagonal(preints.cov, dim1=-2, dim2=-1)[:, 0:3]
    b_s = preints.bias_gyro
    stride = 1
    while 2 * stride <= K - 1:
        L = R_s.shape[0]
        A, B = slice(0, L - stride), slice(stride, L)
        R2 = R_s[A] @ R_s[B]
        J2 = R_s[B].transpose(-1, -2) @ J_s[A] + J_s[B]
        R_s, J_s = R2, J2
        c_s = c_s[A] + c_s[B]
        b_s = 0.5 * (b_s[A] + b_s[B])
        stride *= 2
        rot_levels.append((stride, R_s, J_s, c_s, b_s))

    p_w = 1.0 / torch.sqrt(torch.diagonal(preints.cov, dim1=-2, dim2=-1)
                           [:, 0:9] + 1e-8)                     # [K-1, 9]

    def residuals(theta):
        """theta [B, n] -> residuals [B, R]."""
        Bn = theta.shape[0]
        rxy = theta[:, 0:2]
        log_s = theta[:, 2]
        bg = theta[:, 3:6]
        ba = theta[:, 6:9]
        vel = theta[:, 9:].reshape(Bn, K, 3)
        s = torch.ones_like(log_s) if fix_scale else torch.exp(log_s)
        g = _gravity_from_dirs(rxy, R0_g)
        sp = s[:, None, None] * p_wb                            # [B, K, 3]
        r = pre.inertial_residual(
            preints, R_wb[:-1], sp[:, :-1], vel[:, :-1], R_wb[1:],
            sp[:, 1:], vel[:, 1:], bg[:, None], ba[:, None],
            gravity=g[:, None])                                 # [B, K-1, 9]
        rs = [(r * p_w * edge_valid[:, None]).reshape(Bn, -1)]
        for stride_, Rij, Jij, cij, bij in rot_levels:
            L = Rij.shape[0]
            dR_corr = Rij @ lie.so3_exp(_mv(Jij, bg[:, None] - bij))
            rr = lie.so3_log(dR_corr.transpose(-1, -2)
                             @ R_wb[:L].transpose(-1, -2)
                             @ R_wb[stride_:stride_ + L])
            w = 1.0 / torch.sqrt(cij + sigma_vis2)
            ok = ((torch.arange(L, device=dev) + stride_) < k_real).to(f32)
            rs.append((rr * w * ok[:, None]).reshape(Bn, -1))
        rs.append(bg * prior_gyro)
        rs.append(ba * prior_acc)
        return torch.cat(rs, -1)

    eye_n = torch.eye(n, dtype=f32, device=dev)

    def gn_step(theta):
        r = residuals(theta[None])[0]
        J = jacobian(residuals, theta)                          # [R, n]
        H = J.T @ J + 1e-6 * eye_n
        dx = torch.linalg.solve_ex(H, J.T @ r)[0]   # no error check, no sync
        return theta - dx

    theta = torch.zeros((n,), dtype=f32, device=dev)
    for _ in range(iters):
        theta = gn_step(theta)
    s = (torch.ones((), dtype=f32, device=dev) if fix_scale
         else torch.exp(theta[2]))
    return InertialInit(
        gravity=_gravity_from_dirs(theta[0:2], R0_g), scale=s,
        bias_gyro=theta[3:6], bias_acc=theta[6:9],
        velocities=theta[9:].reshape(K, 3),
        residual_norm=torch.linalg.norm(residuals(theta[None])[0]))


def stack_preints(preints) -> pre.Preintegrated:
    """A list of Preintegrated -> one with a leading [N] axis per field."""
    return pre.Preintegrated(*(torch.stack(xs) for xs in zip(*preints)))


def _identity_preint(template: pre.Preintegrated) -> pre.Preintegrated:
    """A no-op preintegration (identity dR, zero deltas, tiny diagonal
    covariance) shaped like ``template``: finite downstream, masked out."""
    z = pre.Preintegrated(*(torch.zeros_like(x) for x in template))
    return z._replace(
        dR=torch.eye(3, dtype=template.dR.dtype, device=template.dR.device),
        cov=torch.eye(15, dtype=template.cov.dtype,
                      device=template.cov.device) * 1e-6)


def inertial_only_optimize_padded(R_wb, p_wb, preint_list,
                                  fix_scale: bool = False, lo: int = 8,
                                  **kw) -> InertialInit:
    """Pad the chain to a power-of-two length (at least ``lo``) with
    identity poses and no-op preintegrations, as the JAX package's entry
    point does, and solve. R_wb [K, 3, 3] and p_wb [K, 3] are numpy arrays;
    the solve runs on the preintegrations' device."""
    K = int(R_wb.shape[0])
    Kb = lo
    while Kb < K:
        Kb *= 2
    preint_list = list(preint_list)
    if Kb > K:
        pk = Kb - K
        R_wb = np.concatenate(
            [R_wb, np.tile(np.eye(3, dtype=np.float32)[None], (pk, 1, 1))])
        p_wb = np.concatenate([p_wb, np.zeros((pk, 3), np.float32)])
        preint_list += [_identity_preint(preint_list[0])] * pk
    dev = preint_list[0].dR.device
    return inertial_only_optimize(
        torch.as_tensor(np.asarray(R_wb, np.float32), device=dev),
        torch.as_tensor(np.asarray(p_wb, np.float32), device=dev),
        stack_preints(preint_list), fix_scale=fix_scale, k_real=K, **kw)
