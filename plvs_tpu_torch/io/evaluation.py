"""Trajectory evaluation: ATE-RMSE after rigid alignment (a copy of
plvs_tpu/io/evaluation.py's umeyama_alignment / ate_rmse)."""

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
