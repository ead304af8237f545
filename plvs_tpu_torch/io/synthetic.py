"""Synthetic RGB-D sequences with ground truth (numpy / scipy).

A copy of the parts of plvs_tpu/io/synthetic.py the port's tests and chip
smoke use: the corner-blob and structured-panel textures, the default
sweep trajectory, and the textured-wall renderer. The renderer's ray table
comes from the port's own ``cameras.unproject`` on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import cameras as cam_mod


def make_texture(size: int = 1024,
                 rng: np.random.Generator | None = None) -> np.ndarray:
    """High-contrast blob texture rich in FAST corners."""
    rng = rng or np.random.default_rng(0)
    tex = np.full((size, size), 40.0, np.float32)
    n = (size // 28) ** 2
    xs = rng.integers(8, size - 24, n)
    ys = rng.integers(8, size - 24, n)
    for x, y in zip(xs, ys):
        w = int(rng.integers(6, 18))
        h = int(rng.integers(6, 18))
        tex[y: y + h, x: x + w] = rng.uniform(90, 250)
    tex += rng.normal(size=tex.shape).astype(np.float32) * 2.0
    return np.clip(tex, 0, 255)


def make_structured_texture(size: int = 2048,
                            rng: np.random.Generator | None = None,
                            n_panels: int = 48,
                            n_blobs: int = 600) -> np.ndarray:
    """Indoor look: rectangular panels with contrasting 4-px borders (long
    straight edges for the line pipeline) plus dense corner blobs."""
    rng = rng or np.random.default_rng(7)
    tex = np.full((size, size), 70.0, np.float32)
    for _ in range(n_panels):
        w = int(rng.integers(size // 16, size // 4))
        h = int(rng.integers(size // 16, size // 4))
        x = int(rng.integers(0, size - w))
        y = int(rng.integers(0, size - h))
        fill = float(rng.uniform(60, 200))
        border = 250.0 if fill < 130 else 30.0
        tex[y:y + h, x:x + w] = fill
        b = 4
        tex[y:y + b, x:x + w] = border
        tex[y + h - b:y + h, x:x + w] = border
        tex[y:y + h, x:x + b] = border
        tex[y:y + h, x + w - b:x + w] = border
    xs = rng.integers(8, size - 24, n_blobs)
    ys = rng.integers(8, size - 24, n_blobs)
    for x, y in zip(xs, ys):
        w = int(rng.integers(6, 16))
        h = int(rng.integers(6, 16))
        tex[y:y + h, x:x + w] = rng.uniform(90, 250)
    tex += rng.normal(size=tex.shape).astype(np.float32) * 2.0
    return np.clip(tex, 0, 255)


def _so3_exp_np(w: np.ndarray) -> np.ndarray:
    """Host-side Rodrigues formula."""
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]],
                 np.float64)
    if th < 1e-12:
        return np.eye(3, dtype=np.float32)
    A, B = np.sin(th) / th, (1 - np.cos(th)) / th ** 2
    return (np.eye(3) + A * K + B * (K @ K)).astype(np.float32)


def default_trajectory(n_frames: int = 60):
    """World-to-camera poses: lateral sweep + mild yaw/depth changes."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        yaw = 0.10 * np.sin(2 * np.pi * s)
        pitch = 0.04 * np.sin(4 * np.pi * s)
        C = np.array([0.8 * s, 0.12 * np.sin(2 * np.pi * s), 0.25 * s],
                     np.float32)
        R = _so3_exp_np(np.array([pitch, yaw, 0.0]))
        t = (-R @ C).astype(np.float32)
        poses.append((R.astype(np.float32), t))
    return poses


class SyntheticRGBD:
    """Renders frames of a textured wall at world z = wall_z (camera x
    right, y down, z forward; world frame = first camera frame)."""

    def __init__(self, cam: cam_mod.Camera, wall_z: float = 3.0,
                 tex_size: int = 1024, tex_scale: float = 220.0,
                 seed: int = 0, texture: np.ndarray | None = None):
        self.cam = cam
        self.wall_z = wall_z
        self.tex = (texture if texture is not None
                    else make_texture(tex_size, np.random.default_rng(seed)))
        self.tex_scale = tex_scale  # pixels per world unit on the wall
        h, w = cam.height, cam.width
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
        uv = torch.from_numpy(np.stack([xs, ys], -1).reshape(-1, 2))
        self._rays_c = cam_mod.unproject(cam, uv).numpy().T  # [3, H*W], z=1

    def render(self, R: np.ndarray, t: np.ndarray):
        """Returns (gray [H, W] f32, depth [H, W] f32 metres)."""
        from scipy.ndimage import map_coordinates

        h, w = self.cam.height, self.cam.width
        Rwc = R.T
        C = -Rwc @ t
        rays_w = Rwc @ self._rays_c
        denom = rays_w[2]
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        a = (self.wall_z - C[2]) / denom
        Xw = C[:, None] + a * rays_w
        depth = a.reshape(h, w).astype(np.float32)
        ts = self.tex.shape[0]
        u = (Xw[0] * self.tex_scale) % ts
        v = (Xw[1] * self.tex_scale) % ts
        gray = map_coordinates(self.tex, [v.reshape(-1), u.reshape(-1)],
                               order=1, mode="wrap").reshape(h, w).astype(
                                   np.float32)
        depth = np.where((a <= 0.05).reshape(h, w), 0.0, depth)
        return gray, depth

    def sequence(self, poses=None, n_frames: int = 60, fps: float = 30.0):
        poses = poses if poses is not None else default_trajectory(n_frames)
        for i, (R, t) in enumerate(poses):
            gray, depth = self.render(R, t)
            yield i / fps, gray, depth, R, t
