"""The benchmark's scenes and trajectories: frozen copies (numpy / scipy).

Copied from plvs_tpu_torch/io/synthetic.py so that a later change to the
program cannot move the yardstick:

* ``make_structured_texture``: synthetic.py:205-233;
* ``_so3_exp_np``: synthetic.py:236-244;
* ``default_trajectory``: synthetic.py:247-259;
* ``orbit_loop_trajectory``: synthetic.py:262-277;
* ``SyntheticRoom``: synthetic.py:338-396 (render; always the structured
  texture);
* ``SyntheticRGBD``: synthetic.py:408-445 (render).

Departures: the pixel rays come from the undistorted pinhole model written
out here (``Pinhole.rays``), not from the program's ``cameras.unproject``
(the configurations' cameras carry no distortion, so both give the same
rays); each scene adds ``surface_distance``, the reference's distance of a
point to its surfaces.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Pinhole:
    """Undistorted pinhole camera of a configuration (bf: baseline x fx)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    bf: float = 0.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    def rays(self) -> np.ndarray:
        """[3, H*W] camera rays of every pixel centre, scaled to z = 1."""
        ys, xs = np.mgrid[0:self.height, 0:self.width].astype(np.float32)
        x = (xs.reshape(-1) - np.float32(self.cx)) / np.float32(self.fx)
        y = (ys.reshape(-1) - np.float32(self.cy)) / np.float32(self.fy)
        return np.stack([x, y, np.ones_like(x)]).astype(np.float32)


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


def orbit_loop_trajectory(n_frames: int = 96, radius: float = 1.0,
                          wobble: float = 0.05, laps: float = 1.0):
    """Camera orbiting the room centre looking outward: mid-orbit frames
    share no wall with the start, so passing 360 degrees is a true
    place-recognition loop; ``laps`` > 1 keeps revisiting."""
    poses = []
    for i in range(n_frames):
        s = i / (n_frames / laps)
        ang = 2.0 * np.pi * s
        C = np.array([radius * np.sin(ang),
                      wobble * np.sin(4 * np.pi * s),
                      radius * np.cos(ang)], np.float32)
        R = _so3_exp_np(np.array([0.0, -ang, 0.0]))
        t = (-R @ C).astype(np.float32)
        poses.append((R.astype(np.float32), t))
    return poses


class SyntheticRoom:
    """Four textured vertical walls forming a square room (infinite in y),
    each with its own texture, one texture period spanning a wall.

    Walls: z = +half, z = -half, x = +half, x = -half around the origin.
    """

    # (axis, sign, u_axis, u_sign) per wall; u = horizontal texture coord
    _WALLS = (
        (2, +1.0, 0, +1.0),
        (2, -1.0, 0, -1.0),
        (0, +1.0, 2, -1.0),
        (0, -1.0, 2, +1.0),
    )

    def __init__(self, cam: Pinhole, half: float = 3.0,
                 tex_size: int = 1024, tex_scale: float | None = None,
                 seed: int = 0):
        self.cam = cam
        self.half = half
        self.tex_scale = (tex_size / (2.0 * half)
                          if tex_scale is None else tex_scale)
        self.texs = [make_structured_texture(
            tex_size, np.random.default_rng(seed + i)) for i in range(4)]
        self._rays_c = cam.rays()

    def render(self, R: np.ndarray, t: np.ndarray):
        """(gray [H, W] f32, depth [H, W] f32 camera-z metres)."""
        from scipy.ndimage import map_coordinates

        h, w = self.cam.height, self.cam.width
        Rwc = R.T
        C = -Rwc @ t
        rays_w = Rwc @ self._rays_c
        n = rays_w.shape[1]
        best_a = np.full((n,), np.inf, np.float32)
        gray = np.zeros((n,), np.float32)
        for wi, (ax, sign, uax, usign) in enumerate(self._WALLS):
            denom = rays_w[ax]
            denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
            a = (sign * self.half - C[ax]) / denom
            hit = (a > 0.05) & (a < best_a)
            if not hit.any():
                continue
            X = C[:, None] + a * rays_w
            tex = self.texs[wi]
            u = (usign * X[uax, hit] * self.tex_scale) % tex.shape[1]
            v = (X[1, hit] * self.tex_scale) % tex.shape[0]
            gray[hit] = map_coordinates(tex, [v, u], order=1, mode="wrap")
            best_a[hit] = a[hit]
        depth = best_a.copy()
        depth[~np.isfinite(depth)] = 0.0
        return gray.reshape(h, w), depth.reshape(h, w)

    def surface_distance(self, pts: np.ndarray) -> np.ndarray:
        """Distance [N] of world points [N, 3] to the nearest wall."""
        return np.minimum(np.abs(self.half - np.abs(pts[:, 0])),
                          np.abs(self.half - np.abs(pts[:, 2])))


class SyntheticRGBD:
    """Renders frames of a textured wall at world z = wall_z (camera x
    right, y down, z forward; world frame = first camera frame)."""

    def __init__(self, cam: Pinhole, texture: np.ndarray,
                 wall_z: float = 3.0, tex_scale: float = 220.0):
        self.cam = cam
        self.wall_z = wall_z
        self.tex = texture
        self.tex_scale = tex_scale  # pixels per world unit on the wall
        self._rays_c = cam.rays()

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

    def surface_distance(self, pts: np.ndarray) -> np.ndarray:
        """Distance [N] of world points [N, 3] to the wall plane."""
        return np.abs(pts[:, 2] - self.wall_z)
