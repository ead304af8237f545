"""Trajectory and map evaluation: ATE-RMSE after rigid alignment, the
timestamp association, ATE over timestamped rows, the relative pose error
and the benchmark's median-of-runs statistics (copies of
plvs_tpu/io/evaluation.py's functions; ``rpe`` builds its rotations with
``geometry.lie.quat_to_rotmat`` in float32, as the JAX package does), and
surface points sampled from posed depth images."""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import lie


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


def associate(est_ts: np.ndarray, gt_ts: np.ndarray,
              max_difference: float = 0.02, offset: float = 0.0):
    """Greedy nearest-timestamp association: all pairs within
    ``max_difference``, taken closest first, each stamp used once.
    Returns (est_idx, gt_idx) index arrays of equal length, sorted by
    estimated timestamp."""
    est_ts = np.asarray(est_ts, np.float64)
    gt_ts = np.asarray(gt_ts, np.float64) + offset
    diff = np.abs(est_ts[:, None] - gt_ts[None, :])
    ei, gi = np.nonzero(diff <= max_difference)
    order = np.argsort(diff[ei, gi], kind="stable")
    used_e = np.zeros(len(est_ts), bool)
    used_g = np.zeros(len(gt_ts), bool)
    pairs = []
    for k in order:
        e, g = ei[k], gi[k]
        if used_e[e] or used_g[g]:
            continue
        used_e[e] = used_g[g] = True
        pairs.append((e, g))
    if not pairs:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    pairs.sort()
    pe, pg = zip(*pairs)
    return np.asarray(pe, np.int64), np.asarray(pg, np.int64)


def ate_rmse_timed(est: np.ndarray, gt: np.ndarray, align: bool = True,
                   with_scale: bool = False,
                   max_difference: float = 0.02) -> float:
    """ATE-RMSE between timestamped trajectories ``[N, >=4]`` rows
    ``(t, x, y, z, ...)``: associated by timestamp first, then aligned."""
    ei, gi = associate(est[:, 0], gt[:, 0], max_difference)
    if len(ei) < 3:
        return float("nan")
    return ate_rmse(est[ei, 1:4], gt[gi, 1:4], align, with_scale)


def rpe(est: np.ndarray, gt: np.ndarray, delta: int = 1,
        max_difference: float = 0.02):
    """Relative pose error over a fixed frame delta: RMSE of the
    translational and rotational drift between associated poses.
    ``est`` / ``gt`` are TUM rows ``(t, x, y, z, qx, qy, qz, qw)``.
    Returns (trans_rmse, rot_rmse_rad)."""
    ei, gi = associate(est[:, 0], gt[:, 0], max_difference)
    if len(ei) < delta + 2:
        return float("nan"), float("nan")

    def poses(rows):
        q = rows[:, [7, 4, 5, 6]]  # -> (w, x, y, z)
        R = lie.quat_to_rotmat(torch.from_numpy(
            np.ascontiguousarray(q, np.float32))).numpy()
        return R, rows[:, 1:4]

    Re, te = poses(est[ei])
    Rg, tg = poses(gt[gi])
    terrs, rerrs = [], []
    for i in range(len(ei) - delta):
        j = i + delta
        # relative motions in each trajectory's own frame
        dRe = Re[i].T @ Re[j]
        dte = Re[i].T @ (te[j] - te[i])
        dRg = Rg[i].T @ Rg[j]
        dtg = Rg[i].T @ (tg[j] - tg[i])
        E_R = dRg.T @ dRe
        terrs.append(np.linalg.norm(dRg.T @ (dte - dtg)))
        c = np.clip((np.trace(E_R) - 1.0) / 2.0, -1.0, 1.0)
        rerrs.append(np.arccos(c))
    terrs = np.asarray(terrs)
    rerrs = np.asarray(rerrs)
    return (float(np.sqrt((terrs ** 2).mean())),
            float(np.sqrt((rerrs ** 2).mean())))


def benchmark_statistics(run_rmses: list[float], lost_fracs: list[float],
                         lost_gate: float = 0.05, max_failed: int = 2):
    """Median of the runs that pass the lost-frame gate (at most
    ``lost_gate`` of the frames lost); more than ``max_failed`` gated runs
    fail the sequence."""
    keep = [r for r, l in zip(run_rmses, lost_fracs) if l <= lost_gate]
    failed = len(run_rmses) - len(keep)
    if failed > max_failed or not keep:
        return {"failed": True, "median_rmse": float("nan"),
                "sigma": float("nan"), "discarded": failed}
    arr = np.asarray(keep)
    return {"failed": False, "median_rmse": float(np.median(arr)),
            "sigma": float(arr.std()), "discarded": failed}


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
