"""IMU preintegration on the manifold.

Counterpart of plvs_tpu/imu/preintegration.py: the per-sample forward-Euler
update of the reference's IntegrateNewMeasurement (dR, dV, dP, the bias
Jacobians JRg / JVg / JVa / JPg / JPa and the 15x15 covariance), the
bias-corrected getters and the 9D inertial residual. The covariance state
is ordered [dtheta(3), dv(3), dp(3), dbg(3), dba(3)].

The JAX package runs the update as one ``lax.scan``. Here the parts of a
step that do not depend on the carried state (the bias-corrected sample,
``so3_exp(w dt)``, the right Jacobian, ``hat(a)`` and the noise block
``Qn``) are computed for the whole window in one batched pass, and only
the recurrence runs in a Python loop, in the JAX step's order of
operations (``normalize_rotation`` at every step, ``Qn`` over
``max(dt, 1e-6)``). PyTorch compiles nothing per shape, so the window is
not padded to a power-of-two bucket; a ``mask`` still gives the padded
variant's semantics (a masked sample leaves the state untouched).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import lie

GRAVITY = (0.0, 0.0, -9.81)


class ImuCalib(NamedTuple):
    """Continuous-time noise densities (the reference's IMU::Calib)."""

    gyro_noise: float = 1.7e-4    # rad/s/sqrt(Hz)
    acc_noise: float = 2.0e-3     # m/s^2/sqrt(Hz)
    gyro_walk: float = 1.9e-5     # rad/s^2/sqrt(Hz)
    acc_walk: float = 3.0e-3      # m/s^3/sqrt(Hz)


class Preintegrated(NamedTuple):
    """A window of IMU samples preintegrated at a fixed bias (tensors on one
    device; a stacked chain carries a leading axis on every field)."""

    dT: torch.Tensor        # [] total time
    dR: torch.Tensor        # [3, 3]
    dV: torch.Tensor        # [3]
    dP: torch.Tensor        # [3]
    JRg: torch.Tensor       # [3, 3] d(dR)/d(bg)
    JVg: torch.Tensor       # [3, 3]
    JVa: torch.Tensor       # [3, 3]
    JPg: torch.Tensor       # [3, 3]
    JPa: torch.Tensor       # [3, 3]
    cov: torch.Tensor       # [15, 15]
    bias_gyro: torch.Tensor  # [3] linearization bias
    bias_acc: torch.Tensor   # [3]


def _as(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def preintegrate(gyro: torch.Tensor, acc: torch.Tensor, dts: torch.Tensor,
                 bias_gyro, bias_acc, calib: ImuCalib = ImuCalib(),
                 mask: torch.Tensor | None = None) -> Preintegrated:
    """Integrate a window of samples (gyro [T, 3] rad/s, acc [T, 3] m/s^2 in
    the body frame, dts [T] s) at the given bias."""
    T = gyro.shape[0]
    bg = _as(bias_gyro, gyro)
    ba = _as(bias_acc, gyro)
    dts = _as(dts, gyro)
    Ng = calib.gyro_noise ** 2
    Na = calib.acc_noise ** 2
    Nwg = calib.gyro_walk ** 2
    Nwa = calib.acc_walk ** 2
    dev, f32 = gyro.device, gyro.dtype

    # sample-independent parts of every step, in one batched pass
    if mask is not None:
        dts = torch.where(mask, dts, torch.zeros_like(dts))
    w = gyro - bg
    a = acc - ba
    wdt = w * dts[:, None]
    dRi_all = lie.so3_exp(wdt)
    rightJ_all = lie.so3_left_jacobian(-wdt)   # J_r(theta) = J_l(-theta)
    aH_all = lie.hat(a)
    q = torch.cat([torch.full((3,), Ng, dtype=f32, device=dev),
                   torch.full((3,), Na, dtype=f32, device=dev)])
    Qn_all = torch.diag_embed(q.expand(T, 6)) / torch.clamp(
        dts, min=1e-6)[:, None, None]
    eye3 = torch.eye(3, dtype=f32, device=dev)
    z3 = torch.zeros((3, 3), dtype=f32, device=dev)
    dt_col = dts[:, None, None]

    dR = eye3
    dV = torch.zeros(3, dtype=f32, device=dev)
    dP = torch.zeros(3, dtype=f32, device=dev)
    JRg = JVg = JVa = JPg = JPa = z3
    C = torch.zeros((15, 15), dtype=f32, device=dev)
    dT = torch.zeros((), dtype=f32, device=dev)
    for k in range(T):
        dt = dts[k]
        dtm = dt_col[k]
        a_k, aH, dRi, rightJ = a[k], aH_all[k], dRi_all[k], rightJ_all[k]
        # position / velocity first (with the current dR), as the reference
        acc_w = dR @ a_k
        dP_n = dP + dV * dt + 0.5 * acc_w * dt * dt
        dV_n = dV + acc_w * dt
        dRaH = dR @ aH
        JPa_n = JPa + JVa * dtm - 0.5 * dtm * dtm * dR
        JPg_n = JPg + JVg * dtm - 0.5 * dtm * dtm * dRaH @ JRg
        JVa_n = JVa - dR * dtm
        JVg_n = JVg - dtm * dRaH @ JRg
        # covariance: x = [dtheta, dv, dp, dbg, dba]
        A = torch.cat([
            torch.cat([dRi.T, z3, z3, z3, z3], 1),
            torch.cat([-dRaH * dtm, eye3, z3, z3, z3], 1),
            torch.cat([-0.5 * dRaH * dtm * dtm, eye3 * dtm, eye3, z3, z3], 1),
            torch.cat([z3, z3, z3, eye3, z3], 1),
            torch.cat([z3, z3, z3, z3, eye3], 1)], 0)
        B = torch.cat([
            torch.cat([rightJ * dtm, z3], 1),
            torch.cat([z3, dR * dtm], 1),
            torch.cat([z3, 0.5 * dR * dtm * dtm], 1),
            torch.zeros((6, 6), dtype=f32, device=dev)], 0)
        C_n = A @ C @ A.T + B @ Qn_all[k] @ B.T
        walk = torch.diag_embed(torch.cat([
            torch.zeros(9, dtype=f32, device=dev),
            (Nwg * dt).expand(3), (Nwa * dt).expand(3)]))
        C_n = C_n + walk
        dR_n = lie.normalize_rotation(dR @ dRi)
        JRg_n = dRi.T @ JRg - rightJ * dtm
        new = (dR_n, dV_n, dP_n, JRg_n, JVg_n, JVa_n, JPg_n, JPa_n, C_n,
               dT + dt)
        if mask is not None:
            m = mask[k]
            new = tuple(torch.where(m, n, o) for n, o in zip(
                new, (dR, dV, dP, JRg, JVg, JVa, JPg, JPa, C, dT)))
        dR, dV, dP, JRg, JVg, JVa, JPg, JPa, C, dT = new
    return Preintegrated(dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, C, bg, ba)


# -- bias-corrected getters (the reference's GetDeltaRotation / Velocity /
#    Position) --------------------------------------------------------------

def delta_rotation(p: Preintegrated, bias_gyro) -> torch.Tensor:
    db = bias_gyro - p.bias_gyro
    return p.dR @ lie.so3_exp((p.JRg @ db[..., None])[..., 0])


def delta_velocity(p: Preintegrated, bias_gyro, bias_acc) -> torch.Tensor:
    return (p.dV + (p.JVg @ (bias_gyro - p.bias_gyro)[..., None])[..., 0]
            + (p.JVa @ (bias_acc - p.bias_acc)[..., None])[..., 0])


def delta_position(p: Preintegrated, bias_gyro, bias_acc) -> torch.Tensor:
    return (p.dP + (p.JPg @ (bias_gyro - p.bias_gyro)[..., None])[..., 0]
            + (p.JPa @ (bias_acc - p.bias_acc)[..., None])[..., 0])


def deltas(p: Preintegrated, bias_gyro, bias_acc):
    """(dR, dV, dP, dT, cov) corrected to the given bias: what the
    per-frame path reads, in one tuple (``deltas_jit`` in JAX)."""
    bg = _as(bias_gyro, p.dR)
    ba = _as(bias_acc, p.dR)
    return (delta_rotation(p, bg), delta_velocity(p, bg, ba),
            delta_position(p, bg, ba), p.dT, p.cov)


def inertial_residual(p: Preintegrated, R1, p1, v1, R2, p2, v2, bias_gyro,
                      bias_acc, gravity=None) -> torch.Tensor:
    """9D preintegration residual (er, ev, ep) between body states at t1
    and t2 (world frame, R_wb), the reference's EdgeInertial."""
    if gravity is None:
        gravity = _as(GRAVITY, R1)
    dT = p.dT[..., None]
    dR = delta_rotation(p, bias_gyro)
    dV = delta_velocity(p, bias_gyro, bias_acc)
    dP = delta_position(p, bias_gyro, bias_acc)
    R1T = R1.transpose(-1, -2)
    er = lie.so3_log(dR.transpose(-1, -2) @ R1T @ R2)
    ev = (R1T @ (v2 - v1 - gravity * dT)[..., None])[..., 0] - dV
    ep = (R1T @ (p2 - p1 - v1 * dT - 0.5 * gravity * dT * dT)[..., None]
          )[..., 0] - dP
    return torch.cat([er, ev, ep], -1)
