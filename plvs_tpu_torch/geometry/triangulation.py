"""Batched two-view triangulation and epipolar tools.

Counterpart of plvs_tpu/geometry/triangulation.py: midpoint triangulation
of bearing-ray pairs (closed-form 2x2 least squares), its world-frame form,
the parallax cosine, the essential matrix and its epipolar error, and line
triangulation by back-projected plane intersection. Everything is batched
over candidate pairs.
"""

from __future__ import annotations

import torch

from . import lie


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] x [..., 3] -> [..., 3]."""
    return (M @ v[..., None])[..., 0]


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


def triangulate_dlt(ray1: torch.Tensor, ray2: torch.Tensor, R12: torch.Tensor,
                    t12: torch.Tensor):
    """Midpoint triangulation of rays (unit depth, camera 1 and camera 2
    frames) with camera 2's pose in camera 1 (x1 = R12 x2 + t12). Returns
    (X1 [..., 3] in camera 1, valid)."""
    d1 = _unit(ray1)
    d2w = _unit(_mv(R12, ray2))
    a11 = (d1 * d1).sum(-1)
    a12 = -(d1 * d2w).sum(-1)
    a22 = (d2w * d2w).sum(-1)
    b1 = (d1 * t12).sum(-1)
    b2 = -(d2w * t12).sum(-1)
    det = a11 * a22 - a12 * a12
    det_safe = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    alpha = (a22 * b1 - a12 * b2) / det_safe
    beta = (a11 * b2 - a12 * b1) / det_safe
    p1 = alpha[..., None] * d1
    p2 = t12 + beta[..., None] * d2w
    X1 = 0.5 * (p1 + p2)
    valid = (alpha > 0) & (beta > 0) & (det.abs() > 1e-12)
    return X1, valid


def triangulate_points_world(Rcw1, tcw1, Rcw2, tcw2, ray1, ray2):
    """Triangulate rays seen from two world-to-camera poses; returns (world
    points, valid)."""
    Rwc2, twc2 = lie.se3_inverse(Rcw2, tcw2)
    R12, t12 = lie.se3_compose(Rcw1, tcw1, Rwc2, twc2)
    X1, valid = triangulate_dlt(ray1, ray2, R12, t12)
    Rwc1, twc1 = lie.se3_inverse(Rcw1, tcw1)
    return _mv(Rwc1, X1) + twc1, valid


def parallax_cos(ray1, ray2, R12):
    """Cosine of the parallax angle between two bearing rays."""
    return (_unit(ray1) * _unit(_mv(R12, ray2))).sum(-1)


def essential_from_pose(R12: torch.Tensor, t12: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R."""
    return lie.hat(t12) @ R12


def epipolar_error(ray1, ray2, R12, t12):
    """|ray1^T E ray2| over the norm of the epipolar line's normal."""
    l1 = _mv(essential_from_pose(R12, t12), ray2)
    num = (ray1 * l1).sum(-1).abs()
    den = torch.sqrt(l1[..., 0] ** 2 + l1[..., 1] ** 2) + 1e-12
    return num / den


def triangulate_line_planes(Rcw1, tcw1, Rcw2, tcw2, ray_s1, ray_e1, ray_s2,
                            ray_e2):
    """Line triangulation by back-projected plane intersection: each image
    segment spans a plane through its camera centre, and the endpoint rays
    of camera 1 are cut by camera 2's plane. Returns (Xs_w, Xe_w, valid,
    degeneracy_cos), valid requiring non-parallel planes and positive depth
    of both endpoints in both cameras."""
    Rwc1, twc1 = lie.se3_inverse(Rcw1, tcw1)
    Rwc2, twc2 = lie.se3_inverse(Rcw2, tcw2)
    n1 = _mv(Rwc1, torch.linalg.cross(ray_s1, ray_e1, dim=-1))
    n2 = _mv(Rwc2, torch.linalg.cross(ray_s2, ray_e2, dim=-1))
    n1 = n1 / (torch.linalg.norm(n1, dim=-1, keepdim=True) + 1e-12)
    n2 = n2 / (torch.linalg.norm(n2, dim=-1, keepdim=True) + 1e-12)
    deg_cos = (n1 * n2).sum(-1).abs()
    c1, c2 = twc1, twc2

    def hit(ray_c):
        d = _mv(Rwc1, ray_c)
        denom = (n2 * d).sum(-1)
        denom = torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9),
                            denom)
        a = (n2 * (c2 - c1)).sum(-1) / denom
        return c1 + a[..., None] * d, a

    Xs, a_s = hit(ray_s1)
    Xe, a_e = hit(ray_e1)

    def z(R, t, X):
        return (_mv(R, X) + t)[..., 2]

    valid = ((deg_cos < 0.998) & (a_s > 0) & (a_e > 0)
             & (z(Rcw1, tcw1, Xs) > 0) & (z(Rcw1, tcw1, Xe) > 0)
             & (z(Rcw2, tcw2, Xs) > 0) & (z(Rcw2, tcw2, Xe) > 0))
    return Xs, Xe, valid, deg_cos
