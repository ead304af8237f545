"""Trajectory alignment and error (NumPy).

``umeyama_alignment`` and ``ate_rmse`` are frozen copies of
plvs_tpu_torch/io/evaluation.py:16-42.
"""

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


def aligned_errors(est_xyz: np.ndarray, gt_xyz: np.ndarray):
    """(per-frame camera-centre errors [N] after SE3 Umeyama alignment of
    the estimate onto the ground truth, (R, t) of that alignment)."""
    est = np.asarray(est_xyz, np.float64)
    gt = np.asarray(gt_xyz, np.float64)
    _, R, t = umeyama_alignment(est, gt)
    return np.linalg.norm(est @ R.T + t - gt, axis=-1), (R, t)


def pooled_rmse(errors: list) -> float:
    """RMSE over the frames of several sessions, each aligned alone."""
    e = np.concatenate([np.asarray(x, np.float64) for x in errors])
    return float(np.sqrt((e ** 2).mean()))


def quat_xyzw_to_rotmat(q: np.ndarray) -> np.ndarray:
    """[4] (qx, qy, qz, qw) -> [3, 3] rotation."""
    x, y, z, w = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def first_frame_transform(row0: np.ndarray, R0_cw: np.ndarray,
                          t0_cw: np.ndarray):
    """(R, t) taking the estimate's world into the ground truth's through
    the first frame: its exported pose (TUM row: t, position, qx qy qz qw of
    camera-in-world) and its true world-to-camera pose. A map made from the
    first keyframe onwards is carried without the rotation ambiguity of an
    alignment fitted to a short trajectory."""
    Rwc_e = quat_xyzw_to_rotmat(row0[4:8])
    twc_e = np.asarray(row0[1:4], np.float64)
    Rwc_g = np.asarray(R0_cw, np.float64).T
    C_g = -Rwc_g @ np.asarray(t0_cw, np.float64)
    R = Rwc_g @ Rwc_e.T
    return R, C_g - R @ twc_e
