"""Batched camera models: pinhole (+ radtan distortion) and Kannala-Brandt8.

Counterpart of plvs_tpu/geometry/cameras.py. A camera is a small frozen
parameter block; every operation is batched over points and Jacobians are
closed forms. Camera convention: z forward, x right, y down.
"""

from __future__ import annotations

import dataclasses
import math

import torch

PINHOLE = 0
KANNALA_BRANDT8 = 1


@dataclasses.dataclass(frozen=True)
class Camera:
    """params layout:
      PINHOLE:          (fx, fy, cx, cy, k1, k2, p1, p2, k3)
      KANNALA_BRANDT8:  (fx, fy, cx, cy, k1, k2, k3, k4)
    """

    kind: int
    params: tuple
    width: int = 640
    height: int = 480
    bf: float = 0.0  # stereo baseline * fx

    @property
    def fx(self):
        return self.params[0]

    @property
    def fy(self):
        return self.params[1]

    @property
    def cx(self):
        return self.params[2]

    @property
    def cy(self):
        return self.params[3]

    @property
    def K(self) -> torch.Tensor:
        fx, fy, cx, cy = self.params[:4]
        return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                            dtype=torch.float32)


def pinhole(fx, fy, cx, cy, dist=None, width=640, height=480, bf=0.0) -> Camera:
    d = [0.0] * 5 if dist is None else [float(x) for x in dist]
    d = d + [0.0] * (5 - len(d))
    return Camera(PINHOLE, (float(fx), float(fy), float(cx), float(cy), *d),
                  int(width), int(height), float(bf))


def kannala_brandt8(fx, fy, cx, cy, k1, k2, k3, k4, width=640, height=480,
                    bf=0.0) -> Camera:
    p = tuple(float(v) for v in (fx, fy, cx, cy, k1, k2, k3, k4))
    return Camera(KANNALA_BRANDT8, p, int(width), int(height), float(bf))


def _nz(x, eps=1e-9):
    """x with |x| < eps replaced by eps (the reference's safe divisor)."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def _pinhole_project(params, Xc):
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = params[:9]
    inv_z = 1.0 / _nz(Xc[..., 2])
    x = Xc[..., 0] * inv_z
    y = Xc[..., 1] * inv_z
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], -1)


def _kb8_project(params, Xc):
    fx, fy, cx, cy, k1, k2, k3, k4 = params[:8]
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    small = r < 1e-9
    inv_r = 1.0 / torch.where(small, torch.full_like(r, 1e-9), r)
    scale = torch.where(small, 1.0 / _nz(z), theta_d * inv_r)
    return torch.stack([fx * x * scale + cx, fy * y * scale + cy], -1)


def project(cam: Camera, Xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixels [..., 2]."""
    if cam.kind == PINHOLE:
        return _pinhole_project(cam.params, Xc)
    return _kb8_project(cam.params, Xc)


def project_jac(cam: Camera, Xc: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(Xc): [..., 2, 3] (distortion-free for pinhole, like the
    reference)."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    if cam.kind == PINHOLE:
        fx, fy = cam.params[0], cam.params[1]
        inv_z = 1.0 / _nz(z)
        inv_z2 = inv_z * inv_z
        zr = torch.zeros_like(x)
        row0 = torch.stack([fx * inv_z, zr, -fx * x * inv_z2], -1)
        row1 = torch.stack([zr, fy * inv_z, -fy * y * inv_z2], -1)
        return torch.stack([row0, row1], -2)
    fx, fy, _, _, k1, k2, k3, k4 = cam.params[:8]
    r2 = x * x + y * y
    r = torch.sqrt(r2)
    r_safe = torch.where(r < 1e-9, torch.full_like(r, 1e-9), r)
    norm2 = r2 + z * z
    theta = torch.atan2(r, z)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    d_thetad = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (
        7.0 * k3 + 9.0 * k4 * t2)))
    d_theta_dx = x * z / (norm2 * r_safe)
    d_theta_dy = y * z / (norm2 * r_safe)
    d_theta_dz = -r / norm2
    s = theta_d / r_safe
    ds_dtheta = d_thetad / r_safe
    ds_dx = ds_dtheta * d_theta_dx + (-theta_d / (r_safe * r_safe)) * (x / r_safe)
    ds_dy = ds_dtheta * d_theta_dy + (-theta_d / (r_safe * r_safe)) * (y / r_safe)
    ds_dz = ds_dtheta * d_theta_dz
    row0 = torch.stack([fx * (s + x * ds_dx), fx * x * ds_dy, fx * x * ds_dz], -1)
    row1 = torch.stack([fy * y * ds_dx, fy * (s + y * ds_dy), fy * y * ds_dz], -1)
    return torch.stack([row0, row1], -2)


def _pinhole_unproject(params, uv):
    """Newton solve of distort(x) = x_d (10 fixed iterations)."""
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = params[:9]
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(10):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dradial = 2.0 * (k1 + r2 * (2.0 * k2 + 3.0 * k3 * r2))
        f_x = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) - xd
        f_y = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y - yd
        j00 = radial + x * x * dradial + 2.0 * p1 * y + 6.0 * p2 * x
        j01 = x * y * dradial + 2.0 * p1 * x + 2.0 * p2 * y
        j10 = x * y * dradial + 2.0 * p2 * y + 2.0 * p1 * x
        j11 = radial + y * y * dradial + 2.0 * p2 * x + 6.0 * p1 * y
        det = _nz(j00 * j11 - j01 * j10, 1e-12)
        x, y = (x - (j11 * f_x - j01 * f_y) / det,
                y - (-j10 * f_x + j00 * f_y) / det)
    return torch.stack([x, y, torch.ones_like(x)], -1)


def _kb8_unproject(params, uv):
    """Newton solve of theta_d(theta) = d (10 fixed iterations)."""
    fx, fy, cx, cy, k1, k2, k3, k4 = params[:8]
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    theta_d = torch.sqrt(mx * mx + my * my)
    theta_d_c = torch.clamp(theta_d, 0.0, math.pi)
    theta = theta_d_c
    for _ in range(10):
        t2 = theta * theta
        f = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))) \
            - theta_d_c
        fp = 1.0 + t2 * (3.0 * k1 + t2 * (5.0 * k2 + t2 * (
            7.0 * k3 + 9.0 * k4 * t2)))
        theta = theta - f / _nz(fp)
    small = theta_d < 1e-9
    one = torch.ones_like(theta_d)
    scale = torch.where(small, one,
                        torch.tan(theta) / torch.where(small, one, theta_d))
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], -1)


def unproject(cam: Camera, uv: torch.Tensor) -> torch.Tensor:
    """Pixels [..., 2] -> unit-depth rays [..., 3] (z = 1)."""
    if cam.kind == PINHOLE:
        return _pinhole_unproject(cam.params, uv)
    return _kb8_unproject(cam.params, uv)


def backproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    return unproject(cam, uv) * depth[..., None]


def in_image(cam: Camera, uv: torch.Tensor, margin: float = 0.0) -> torch.Tensor:
    return ((uv[..., 0] >= margin) & (uv[..., 0] < cam.width - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < cam.height - margin))
