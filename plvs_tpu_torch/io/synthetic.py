"""Synthetic RGB-D sequences with ground truth (numpy / scipy).

A copy of plvs_tpu/io/synthetic.py: the RGB-D sensor-artifact model, the
corner-blob, bar-dominated and structured-panel textures, the default
sweep trajectory, the textured-wall renderer and its two views through a
calibrated stereo rig, and the four-wall room with its orbit trajectory
(the loop-closure scene). The renderers' ray tables come from the port's
own ``cameras.unproject`` on the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import cameras as cam_mod


@dataclasses.dataclass
class SensorModel:
    """RGB-D sensor-artifact model applied on top of the ideal renderers
    (bit-equal to the JAX package's, numpy and scipy on the host):

    - photometric: additive Gaussian read noise and a per-frame exposure
      gain jitter;
    - motion blur: a 1-D blur of the gray image along the apparent image
      motion since the previous frame (flow x shutter fraction, capped);
    - depth quantization: structured-light disparity d = bf / z rounded to
      ``disparity_step`` px, so depth comes back staircased;
    - axial depth noise: sigma_z(z) = depth_noise_at_1m * z^2;
    - edge shadowing: depth invalidated in a band around strong depth
      discontinuities, plus sparse random speckle dropout.
    """

    photometric_sigma: float = 2.5   # gray DN
    exposure_jitter: float = 0.03    # multiplicative gain sd per frame
    shutter_fraction: float = 0.5    # fraction of inter-frame motion blurred
    blur_max_px: float = 6.0
    disparity_step: float = 0.125    # px; 0 disables quantization
    stereo_bf: float = 40.0          # disparity bf when the camera has none
    depth_noise_at_1m: float = 0.0015  # m (sigma ~ this * z^2)
    edge_shadow_px: int = 2          # half-width of the invalid band
    edge_grad_m: float = 0.10        # depth-jump threshold (m / px)
    dropout_frac: float = 0.002      # random invalid-pixel speckle
    seed: int = 0

    def _rng(self, frame_idx: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, frame_idx]))

    def apply(self, gray: np.ndarray, depth: np.ndarray, frame_idx: int,
              bf: float = 0.0, flow_px: np.ndarray | None = None):
        """(gray', depth') with sensor artifacts. ``flow_px`` is the
        apparent image motion (du, dv) since the previous frame for the
        motion blur; None or a short flow skips the blur."""
        rng = self._rng(frame_idx)
        g = gray.astype(np.float32)

        if flow_px is not None and self.shutter_fraction > 0:
            L = float(np.hypot(*flow_px)) * self.shutter_fraction
            L = min(L, self.blur_max_px)
            if L >= 1.0:
                g = _directional_blur(g, np.asarray(flow_px, np.float64), L)

        gain = 1.0 + self.exposure_jitter * rng.standard_normal()
        g = g * gain + self.photometric_sigma * \
            rng.standard_normal(g.shape).astype(np.float32)
        g = np.clip(g, 0.0, 255.0)

        d = depth.astype(np.float32).copy()
        valid = d > 1e-6

        if self.edge_shadow_px > 0:
            from scipy.ndimage import binary_dilation

            gy, gx = np.gradient(np.where(valid, d, 0.0))
            edge = (np.abs(gy) > self.edge_grad_m) | \
                   (np.abs(gx) > self.edge_grad_m)
            edge &= valid
            if edge.any():
                band = binary_dilation(edge, iterations=self.edge_shadow_px)
                valid &= ~band

        if self.depth_noise_at_1m > 0:
            sig = self.depth_noise_at_1m * np.square(d)
            d = d + sig * rng.standard_normal(d.shape).astype(np.float32)

        if self.disparity_step > 0:
            bf_eff = bf if bf > 1e-6 else self.stereo_bf
            disp = bf_eff / np.where(valid, d, 1.0)
            disp = np.round(disp / self.disparity_step) * self.disparity_step
            d = np.where(disp > 1e-6, bf_eff / np.maximum(disp, 1e-6), d)

        if self.dropout_frac > 0:
            valid &= rng.random(d.shape) >= self.dropout_frac

        return g, np.where(valid, d, 0.0).astype(np.float32)


def _directional_blur(img: np.ndarray, direction: np.ndarray,
                      length_px: float) -> np.ndarray:
    """Box blur along ``direction`` with total extent ``length_px`` (a line
    kernel rasterized bilinearly into a small 2-D stencil)."""
    from scipy.ndimage import convolve

    n = max(int(np.ceil(length_px)), 1)
    dnorm = np.linalg.norm(direction)
    u = direction / dnorm if dnorm > 1e-9 else np.array([1.0, 0.0])
    half = (n - 1) / 2.0
    r = int(np.ceil(half)) + 1
    k = np.zeros((2 * r + 1, 2 * r + 1), np.float32)
    taps = max(2 * n, 2)
    for s in np.linspace(-half, half, taps):
        x, y = r + s * u[0], r + s * u[1]
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - x0, y - y0
        for dy_, wy in ((0, 1 - fy), (1, fy)):
            for dx_, wx in ((0, 1 - fx), (1, fx)):
                k[y0 + dy_, x0 + dx_] += wx * wy
    k /= k.sum()
    return convolve(img, k, mode="nearest")


def _center_flow(cam: cam_mod.Camera, prev_R, prev_t, prev_depth,
                 R, t) -> np.ndarray | None:
    """Apparent image motion (du, dv) of the scene point seen at the image
    centre of the previous frame (a pinhole approximation on the host; it
    sets the motion-blur length)."""
    d0 = float(prev_depth) if prev_depth > 1e-3 else 3.0
    X_w = prev_R.T @ (np.array([0.0, 0.0, d0], np.float64) - prev_t)
    X_c = R @ X_w + t
    if X_c[2] <= 1e-6:
        return None
    fx, fy, cx, cy = (float(p) for p in cam.params[:4])
    u = fx * X_c[0] / X_c[2] + cx
    v = fy * X_c[1] / X_c[2] + cy
    return np.array([u - cx, v - cy], np.float64)


def _sensor_sequence(scene, poses, fps: float, sensor):
    """(ts, gray, depth, R, t) per pose, through ``sensor`` when given (the
    blur follows the centre flow since the previous pose)."""
    prev = None
    for i, (R, t) in enumerate(poses):
        gray, depth = scene.render(R, t)
        if sensor is not None:
            flow = None if prev is None else _center_flow(
                scene.cam, prev[0], prev[1], prev[2], R, t)
            h, w = depth.shape
            prev = (R, t, float(depth[h // 2, w // 2]))
            gray, depth = sensor.apply(gray, depth, i, bf=scene.cam.bf,
                                       flow_px=flow)
        yield i / fps, gray, depth, R, t


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


def make_line_texture(size: int = 1024,
                      rng: np.random.Generator | None = None,
                      n_bars: int = 26, n_blobs: int = 40) -> np.ndarray:
    """Low-corner-density texture dominated by long straight bars: points
    alone survive on the few blobs but drift, and the line landmarks along
    the bars tighten the pose solves."""
    rng = rng or np.random.default_rng(3)
    tex = np.full((size, size), 55.0, np.float32)
    for _ in range(n_bars):
        # a long bar through a random anchor at a random angle
        ang = rng.uniform(0, np.pi)
        cx, cy = rng.uniform(0, size, 2)
        width = float(rng.integers(3, 9))
        val = float(rng.uniform(140, 250))
        L = size * 1.5
        ts = np.linspace(-L / 2, L / 2, int(L))
        dx, dy = np.cos(ang), np.sin(ang)
        for off in np.arange(-width / 2, width / 2 + 0.5, 0.5):
            xs = (cx + ts * dx - off * dy).astype(int) % size
            ys = (cy + ts * dy + off * dx).astype(int) % size
            tex[ys, xs] = val
    # sparse weak blobs keep the point tracker alive
    xs = rng.integers(8, size - 16, n_blobs)
    ys = rng.integers(8, size - 16, n_blobs)
    for x, y in zip(xs, ys):
        w = int(rng.integers(5, 10))
        tex[y: y + w, x: x + w] = rng.uniform(90, 200)
    tex += rng.normal(size=tex.shape).astype(np.float32) * 1.5
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


def inertial_sequence(n_frames: int = 90, seed: int = 1, fps: int = 30,
                      rate: int = 300):
    """Body motion with an IMU: bench.py's RGB-D-inertial sequence
    (``bench.py:386-423``) in numpy. Gravity (0.3, 9.7, -0.4) scaled to
    9.81, gyro bias (0.002, -0.001, 0.001), gyro noise N(0, 1e-4) and
    accelerometer noise N(0, 1e-3) from ``default_rng(seed)``, ``rate``
    samples a second, the body frame the camera frame. Returns [(t, R_cw
    [3, 3], t_cw [3], samples [(t, gyro [3], acc [3])])] per frame, the
    samples those since the previous frame; the camera sees bench.py's
    wall through ``SyntheticRGBD(cam, wall_z=3.0,
    texture=make_structured_texture(2048, default_rng(11 + seed)),
    tex_scale=420.0)``."""
    g_w = np.array([0.3, 9.7, -0.4], np.float32)
    g_w = g_w / np.linalg.norm(g_w) * 9.81
    dt = 1.0 / rate
    true_bg = np.array([0.002, -0.001, 0.001], np.float32)
    R = np.eye(3, dtype=np.float32)
    p = np.zeros(3, np.float32)
    v = np.array([0.3, 0.0, 0.08], np.float32)
    frames = []
    t_now = 0.0
    rng = np.random.default_rng(seed)
    for _ in range(n_frames):
        samples = []
        for _ in range(rate // fps):
            t_now += dt
            w = np.array([0.1 * np.sin(2 * t_now), 0.15 * np.cos(t_now),
                          0.05], np.float32)
            a_w = np.array([0.25 * np.sin(3 * t_now),
                            0.2 * np.cos(2 * t_now),
                            0.15 * np.sin(t_now)], np.float32)
            f_b = R.T @ (a_w - g_w)
            samples.append((t_now, w + true_bg + rng.normal(0, 1e-4, 3)
                            .astype(np.float32),
                            f_b + rng.normal(0, 1e-3, 3).astype(np.float32)))
            p = p + v * dt + 0.5 * a_w * dt * dt
            v = v + a_w * dt
            R = R @ _so3_exp_np(w * dt)
        R_cw = R.T.copy()
        frames.append((t_now, R_cw, (-R_cw @ p).copy(), samples))
    return frames


def inertial_scene(cam: cam_mod.Camera, seed: int = 1) -> "SyntheticRGBD":
    """The wall :func:`inertial_sequence` looks at."""
    tex = make_structured_texture(2048, rng=np.random.default_rng(11 + seed))
    return SyntheticRGBD(cam, wall_z=3.0, texture=tex, tex_scale=420.0)


def _unit_z_rays(cam: cam_mod.Camera) -> np.ndarray:
    """[3, H*W] camera rays of every pixel centre, scaled to z = 1."""
    h, w = cam.height, cam.width
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    uv = torch.from_numpy(np.stack([xs, ys], -1).reshape(-1, 2))
    rays = cam_mod.unproject(cam, uv).numpy()
    return (rays / rays[:, 2:3]).T


class SyntheticRoom:
    """Four textured vertical walls forming a square room (infinite in y),
    each with its own texture, one texture period spanning a wall (a
    repeating texture would alias places one period apart).

    Walls: z = +half, z = -half, x = +half, x = -half around the origin.
    """

    # (axis, sign, u_axis, u_sign) per wall; u = horizontal texture coord
    _WALLS = (
        (2, +1.0, 0, +1.0),
        (2, -1.0, 0, -1.0),
        (0, +1.0, 2, -1.0),
        (0, -1.0, 2, +1.0),
    )

    def __init__(self, cam: cam_mod.Camera, half: float = 3.0,
                 tex_size: int = 1024, tex_scale: float | None = None,
                 seed: int = 0, structured: bool = True):
        self.cam = cam
        self.half = half
        self.tex_scale = (tex_size / (2.0 * half)
                          if tex_scale is None else tex_scale)
        make = make_structured_texture if structured else make_texture
        self.texs = [make(tex_size, np.random.default_rng(seed + i))
                     for i in range(4)]
        self._rays_c = _unit_z_rays(cam)

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

    def sequence(self, poses, fps: float = 30.0,
                 sensor: SensorModel | None = None):
        return _sensor_sequence(self, poses, fps, sensor)

    def wall_normals(self, pts: np.ndarray) -> np.ndarray:
        """Inward unit normal [N, 3] of the wall (x or z = +-half) nearest
        each room-frame point [N, 3]."""
        on_x = np.abs(pts[:, 0]) > np.abs(pts[:, 2])
        n = np.zeros_like(pts, dtype=np.float32)
        n[on_x, 0] = -np.sign(pts[on_x, 0])
        n[~on_x, 2] = -np.sign(pts[~on_x, 2])
        return n


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

    def sequence(self, poses=None, n_frames: int = 60, fps: float = 30.0,
                 sensor: SensorModel | None = None):
        """(ts, gray, depth, R, t) per pose (``default_trajectory`` of
        ``n_frames`` without poses), through ``sensor`` when given."""
        poses = poses if poses is not None else default_trajectory(n_frames)
        return _sensor_sequence(self, poses, fps, sensor)


# tests/test_stereo_rig.py's KB8 fisheye pair scaled to 640x480: (fx, fy,
# cx, cy, k1, k2, k3, k4) of the left and the right camera
RIG_KB8_LEFT = (310.0, 310.0, 320.0, 240.0, 0.02, -0.008, 0.002, -0.0005)
RIG_KB8_RIGHT = (306.0, 306.0, 322.0, 238.0, 0.019, -0.0075, 0.0021, -0.0004)


def rig_extrinsic(yaw: float = 0.017, baseline: float = 0.11) -> np.ndarray:
    """4x4 right-to-left transform of that pair: the right camera
    ``baseline`` m to the right, yawed by ``yaw`` rad."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = _so3_exp_np(np.array([0.0, yaw, 0.0]))
    T[:3, 3] = [baseline, 0.0, 0.0]
    return T


class SyntheticRig:
    """Both views of a textured wall through a calibrated stereo rig (any
    camera models): ``T_c1_c2`` maps right-camera points into the left
    camera, X_c1 = R X_c2 + t, and both cameras see one texture. The left
    camera follows the given poses."""

    def __init__(self, cam_l: cam_mod.Camera, cam_r: cam_mod.Camera,
                 T_c1_c2: np.ndarray, **wall_kw):
        self.left = SyntheticRGBD(cam_l, **wall_kw)
        self.right = SyntheticRGBD(cam_r, **{**wall_kw,
                                             "texture": self.left.tex})
        T = np.asarray(T_c1_c2, np.float32)
        self.R12, self.t12 = T[:3, :3], T[:3, 3]

    def render(self, R: np.ndarray, t: np.ndarray):
        """(left gray, right gray, left depth) at left pose (R, t)."""
        gray_l, depth_l = self.left.render(R, t)
        gray_r, _ = self.right.render(self.R12.T @ R,
                                      self.R12.T @ (t - self.t12))
        return gray_l, gray_r, depth_l

    def sequence(self, poses, fps: float = 30.0):
        """(ts, left, right, R, t) per pose."""
        for i, (R, t) in enumerate(poses):
            gray_l, gray_r, _ = self.render(R, t)
            yield i / fps, gray_l, gray_r, R, t


# -- connected-component grids (kernel K2's test inputs) ---------------------

def link_bits(mask: np.ndarray, keep: np.ndarray | None = None,
              wrap: bool = False) -> np.ndarray:
    """Undirected 8-neighbour link bits (``ops.cc_labels.SHIFTS`` order)
    between the cells of ``mask``; ``wrap`` links across the borders
    cyclically. ``keep[ci // 2]`` [H, W] optionally drops links, the same
    for both directions (a link survives when its lower-index end keeps it)."""
    from ..ops.cc_labels import SHIFTS

    h, w = mask.shape
    bits = np.zeros((h, w), np.int32)
    ys, xs = np.mgrid[0:h, 0:w]
    for ci, (sy, sx) in enumerate(SHIFTS):
        ny, nx = ys - sy, xs - sx
        if wrap:
            inside = np.ones((h, w), bool)
            ny, nx = ny % h, nx % w
        else:
            inside = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
            ny, nx = np.clip(ny, 0, h - 1), np.clip(nx, 0, w - 1)
        link = inside & mask & mask[ny, nx]
        if keep is not None:
            lo = np.minimum(ys * w + xs, ny * w + nx)
            link &= keep[ci // 2].reshape(-1)[lo]
        bits |= link.astype(np.int32) << ci
    return bits


def spiral(h: int, w: int) -> np.ndarray:
    """One corridor spiralling inward with a one-cell gap between turns."""
    m = np.zeros((h, w), bool)
    y, x, dy, dx = 0, 0, 0, 1
    m[0, 0] = True
    stuck = 0
    while stuck < 2:
        ny, nx, fy, fx = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        ahead_free = (0 <= ny < h and 0 <= nx < w and not m[ny, nx]
                      and not (0 <= fy < h and 0 <= fx < w and m[fy, fx]))
        if ahead_free:
            y, x, stuck = ny, nx, 0
            m[y, x] = True
        else:
            dy, dx, stuck = dx, -dy, stuck + 1
    return m


def cc_grids(h: int, w: int, rng: np.random.Generator):
    """(name, init, conn_bits) grids that defeat a bounded sweep count:
    the full grid, an empty one, a diagonal staircase, a spiral, random
    links, and random links that wrap across both borders. ``init`` holds
    each valid cell's index and h * w elsewhere, both [H, W] int32."""
    full = np.ones((h, w), bool)
    stair = np.zeros((h, w), bool)
    idx = np.arange(min(h, w))
    stair[idx, idx] = True
    rmask = rng.random((h, w)) < 0.55
    keep = rng.random((4, h, w)) < 0.6
    wmask = rng.random((h, w)) < 0.55
    wkeep = rng.random((4, h, w)) < 0.6
    coil = spiral(h, w)
    grids = [("full_grid", full, link_bits(full)),
             ("empty", ~full, np.zeros((h, w), np.int32)),
             ("diagonal_staircase", stair, link_bits(stair)),
             ("spiral", coil, link_bits(coil)),
             ("random_links", rmask, link_bits(rmask, keep)),
             ("random_wrapping_links", wmask,
              link_bits(wmask, wkeep, wrap=True))]
    out = []
    for name, mask, bits in grids:
        init = np.where(mask, np.arange(h * w).reshape(h, w), h * w)
        out.append((name, init.astype(np.int32), bits))
    return out
