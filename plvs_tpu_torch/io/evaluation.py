"""Trajectory and map evaluation: ATE-RMSE after rigid alignment (a copy of
plvs_tpu/io/evaluation.py's umeyama_alignment / ate_rmse), and surface
points sampled from posed depth images."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid (or similarity) alignment dst ~= s R src + t.
    Returns (s, R, t)."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((xs ** 2).sum() / len(src))) \
        if with_scale else 1.0
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, align: bool = True,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after optional alignment."""
    if align:
        s, R, t = umeyama_alignment(est_xyz, gt_xyz, with_scale)
        est_xyz = (s * (R @ est_xyz.T)).T + t
    err = np.linalg.norm(est_xyz - gt_xyz, axis=-1)
    return float(np.sqrt((err ** 2).mean()))


def depth_samples(depths, poses, cam, n: int, max_depth: float,
                  seed: int = 0) -> np.ndarray:
    """``n`` world points [n, 3] float32: random pixels (``seed``) of the
    pinhole depth images ``depths`` [(key, [H, W])] nearer than
    ``max_depth``, back-projected at ``poses`` ({key: (Rcw, tcw)}; keys
    without a pose are skipped)."""
    fx, fy, cx, cy = (float(v) for v in cam.params[:4])
    pts = []
    for key, depth in depths:
        if key not in poses:
            continue
        R, t = poses[key]
        v, u = np.nonzero((depth > 0) & (depth < max_depth))
        z = depth[v, u]
        X = np.stack([(u - cx) / fx * z, (v - cy) / fy * z, z], -1)
        pts.append((X - t) @ R)           # R^T (X - t)
    pts = np.concatenate(pts).astype(np.float32)
    rng = np.random.default_rng(seed)
    return pts[rng.choice(len(pts), n, replace=False)]
