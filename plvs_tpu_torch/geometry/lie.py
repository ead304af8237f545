"""Batched SO3 / SE3 operations on tensors.

Counterpart of plvs_tpu/geometry/lie.py, Sim3 included. Same conventions: rotations are [..., 3, 3] matrices, poses
are (R, t) pairs, SE3 tangents are ordered (rho, theta), and small-angle
branches use the same Taylor expansions selected elementwise.
"""

from __future__ import annotations

import torch

_EPS = 1e-6


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _safe_norm(v):
    return torch.sqrt(torch.clamp((v * v).sum(-1), min=1e-24))


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _sinc(x):
    small = x.abs() < _EPS
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, 1.0 - x * x / 6.0, torch.sin(safe) / safe)


def _cosc(x):
    small = x.abs() < _EPS
    one = torch.ones_like(x)
    safe2 = torch.where(small, one, x * x)
    return torch.where(small, 0.5 - x * x / 24.0,
                       (1.0 - torch.cos(torch.where(small, one, x))) / safe2)


def _sin3(x):
    small = x.abs() < _EPS
    one = torch.ones_like(x)
    xs = torch.where(small, one, x)
    safe3 = torch.where(small, one, x * x * x)
    return torch.where(small, 1.0 / 6.0 - x * x / 120.0,
                       (xs - torch.sin(xs)) / safe3)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Exponential map so(3) -> SO(3): [..., 3] -> [..., 3, 3]."""
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    return (_eye(w) + _sinc(theta)[..., None, None] * W
            + _cosc(theta)[..., None, None] * W2)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3) through the quaternion (stable near 0
    and pi)."""
    q = rotmat_to_quat(R)
    qw, qv = q[..., 0], q[..., 1:]
    nv = _safe_norm(qv)
    theta = 2.0 * torch.atan2(nv, qw)
    small = nv < _EPS
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=_EPS),
                        theta / torch.where(small, torch.ones_like(nv), nv))
    return qv * scale[..., None]


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    return (_eye(w) + _cosc(theta)[..., None, None] * W
            + _sin3(theta)[..., None, None] * W2)


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    x = theta
    small = x.abs() < _EPS
    one = torch.ones_like(x)
    safex = torch.where(small, one, x)
    sinx = torch.sin(safex)
    cot_term = torch.where(
        small, 1.0 / 12.0 + x * x / 720.0,
        1.0 / torch.where(small, one, x * x)
        - (1.0 + torch.cos(safex))
        / (2.0 * safex * torch.where(sinx.abs() < _EPS, one, sinx)))
    return _eye(w) - 0.5 * W + cot_term[..., None, None] * W2


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (w, x, y, z) -> [..., 3, 3]."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> unit quaternion [..., 4] (w, x, y, z), w >= 0, by the
    same largest-pivot selection as the JAX package."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    qx0 = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                       m02 + m20], -1)
    qy0 = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                       m12 + m21], -1)
    qz0 = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                       1.0 - m00 - m11 + m22], -1)
    cands = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                         1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], -1)
    idx = torch.argmax(cands, dim=-1)
    qs = torch.stack([qw0, qx0, qy0, qz0], -2)
    q = torch.take_along_dim(qs, idx[..., None, None], dim=-2)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions [..., 4] (w, x, y, z)."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def se3_exp(xi: torch.Tensor):
    """se(3) -> SE(3): [..., 6] (rho, theta) -> (R, t)."""
    rho, theta = xi[..., :3], xi[..., 3:]
    R = so3_exp(theta)
    t = (so3_left_jacobian(theta) @ rho[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    theta = so3_log(R)
    rho = (so3_left_jacobian_inv(theta) @ t[..., None])[..., 0]
    return torch.cat([rho, theta], -1)


def se3_inverse(R: torch.Tensor, t: torch.Tensor):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_compose(R1, t1, R2, t2):
    """(R1, t1) * (R2, t2)."""
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def se3_apply(R, t, p):
    """Apply pose (R [3, 3], t [3]) to points p [..., 3]."""
    return p @ R.transpose(-1, -2) + t


def se3_adjoint(R, t) -> torch.Tensor:
    """Adjoint of SE(3) acting on (rho, theta)-ordered tangents: [..., 6, 6]."""
    top = torch.cat([R, hat(t) @ R], -1)
    bot = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bot], -2)


def se3_from_mat(T: torch.Tensor):
    """[..., 4, 4] -> (R [..., 3, 3], t [..., 3])."""
    return T[..., :3, :3], T[..., :3, 3]


def se3_to_mat(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R [..., 3, 3], t [..., 3]) -> [..., 4, 4]."""
    bottom = R.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(*R.shape[:-2], 1, 4)
    return torch.cat([torch.cat([R, t[..., None]], -1), bottom], -2)


# ---------------------------------------------------------------------------
# Sim(3): (R, t, s); tangent zeta = [rho, theta, sigma] (7,), s = exp(sigma)
# ---------------------------------------------------------------------------

def _sim3_W(theta_vec: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim3 'W' matrix such that t = W @ rho.

    W = A I + C hat(theta) + D hat(theta)^2 with the closed-form integrals
    of int_0^1 e^{sigma u} exp(u hat(theta)) du, and Taylor branches near
    sigma = 0 and |theta| = 0 selected elementwise.
    """
    h = _safe_norm(theta_vec)
    W = hat(theta_vec)
    W2 = W @ W
    es = torch.exp(sigma)
    eps = 1e-4
    one = torch.ones_like(sigma)

    s_small = sigma.abs() < eps
    h_small = h < eps
    ss = torch.where(s_small, one, sigma)
    hh = torch.where(h_small, torch.ones_like(h), h)
    denom = ss * ss + hh * hh

    A = torch.where(s_small, 1.0 + 0.5 * sigma + sigma * sigma / 6.0,
                    (es - 1.0) / ss)
    I1 = (es * (ss * torch.sin(hh) - hh * torch.cos(hh)) + hh) / denom
    I2 = (es * (ss * torch.cos(hh) + hh * torch.sin(hh)) - ss) / denom
    I0g = (es - 1.0) / ss

    C_gen = I1 / hh
    D_gen = (torch.where(s_small, A, I0g) - I2) / (hh * hh)
    C_h0 = torch.where(s_small, 0.5 + sigma / 3.0,
                       (es * (ss - 1.0) + 1.0) / (ss * ss))
    D_h0 = torch.where(s_small, 1.0 / 6.0 + sigma / 8.0,
                       (es * (ss * ss - 2.0 * ss + 2.0) - 2.0) / (2.0 * ss * ss * ss))
    C_s0 = (1.0 - torch.cos(hh)) / (hh * hh)
    D_s0 = (hh - torch.sin(hh)) / (hh * hh * hh)

    C = torch.where(h_small, C_h0, torch.where(s_small, C_s0, C_gen))
    D = torch.where(h_small, D_h0, torch.where(s_small, D_s0, D_gen))
    I = _eye(theta_vec).expand(W.shape)
    return A[..., None, None] * I + C[..., None, None] * W + D[..., None, None] * W2


def sim3_exp(zeta: torch.Tensor):
    """sim(3) -> Sim(3): [..., 7] (rho, theta, sigma) -> (R, t, s)."""
    rho, theta, sigma = zeta[..., :3], zeta[..., 3:6], zeta[..., 6]
    R = so3_exp(theta)
    t = (_sim3_W(theta, sigma) @ rho[..., None])[..., 0]
    return R, t, torch.exp(sigma)


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A^-1 b for [..., 3, 3] A by Cramer's rule (the rows' cross products
    over the determinant): a closed form that forward-mode autodiff under
    vmap differentiates correctly, where torch.linalg.solve's batched
    forward rule does not."""
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    cof = torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                       torch.linalg.cross(r0, r1)], -1)
    det = (r0 * cof[..., :, 0]).sum(-1)
    return (cof @ b[..., None])[..., 0] / det[..., None]


def sim3_log(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Sim(3) -> sim(3), solving W rho = t."""
    theta = so3_log(R)
    sigma = torch.log(s)
    rho = _solve3(_sim3_W(theta, sigma), t)
    return torch.cat([rho, theta, sigma[..., None]], -1)


def sim3_inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    inv_s = 1.0 / s
    return Rt, -inv_s[..., None] * (Rt @ t[..., None])[..., 0], inv_s


def sim3_compose(R1, t1, s1, R2, t2, s2):
    """(R1,t1,s1) * (R2,t2,s2): x -> s1 R1 (s2 R2 x + t2) + t1."""
    return (R1 @ R2, s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1,
            s1 * s2)


def sim3_apply(R, t, s, p):
    return s[..., None] * (R @ p[..., None])[..., 0] + t


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize through a quaternion round trip."""
    return quat_to_rotmat(rotmat_to_quat(R))
