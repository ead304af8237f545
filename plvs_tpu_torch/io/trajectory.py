"""Trajectory files: TUM, KITTI and EuRoC writers and the TUM reader.

Counterpart of plvs_tpu/io/trajectory.py, line for line. A trajectory is
a list of (timestamp, R_cw, t_cw); the files hold the camera in the world.
The quaternion comes from ``geometry.lie.rotmat_to_quat`` on the float32
rotation, as the JAX package computes it with x64 off.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import lie


def _cam_in_world(R_cw: np.ndarray, t_cw: np.ndarray):
    R_wc = R_cw.T
    return R_wc, -R_wc @ t_cw


def _quat(R_wc: np.ndarray) -> np.ndarray:
    """(w, x, y, z) of a rotation, computed in float32."""
    return lie.rotmat_to_quat(torch.from_numpy(
        np.ascontiguousarray(R_wc, np.float32))).numpy()


def write_tum(path: str, trajectory):
    """Rows: t tx ty tz qx qy qz qw (camera-in-world)."""
    with open(path, "w") as f:
        for ts, R, t in trajectory:
            Rwc, twc = _cam_in_world(R, t)
            q = _quat(Rwc)
            f.write(
                f"{ts:.6f} {twc[0]:.7f} {twc[1]:.7f} {twc[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n"
            )


def write_kitti(path: str, trajectory):
    """Rows: flattened 3x4 [R_wc | t_wc] per frame (KITTI odometry format)."""
    with open(path, "w") as f:
        for ts, R, t in trajectory:
            Rwc, twc = _cam_in_world(R, t)
            T = np.hstack([Rwc, twc[:, None]])
            f.write(" ".join(f"{v:.9e}" for v in T.reshape(-1)) + "\n")


def write_euroc(path: str, trajectory):
    """EuRoC csv: timestamp_ns, px, py, pz, qw, qx, qy, qz."""
    with open(path, "w") as f:
        f.write("#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z\n")
        for ts, R, t in trajectory:
            Rwc, twc = _cam_in_world(R, t)
            q = _quat(Rwc)
            f.write(
                f"{int(ts * 1e9)},{twc[0]:.6f},{twc[1]:.6f},{twc[2]:.6f},"
                f"{q[0]:.6f},{q[1]:.6f},{q[2]:.6f},{q[3]:.6f}\n"
            )


def read_tum(path: str) -> np.ndarray:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            rows.append([float(x) for x in line.split()])
    return np.asarray(rows)
