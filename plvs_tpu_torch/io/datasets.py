"""Dataset loaders: TUM RGB-D, EuRoC stereo(-inertial) and KITTI stereo.

Counterpart of plvs_tpu/io/datasets.py. PNGs are decoded with PIL
(imported inside the reader) to the values of the JAX package's native
reader: 8-bit gray as is, 16-bit gray (depth) as its raw samples, and
colour (palette and alpha dropped) as the float32 sum 0.299 r + 0.587 g +
0.114 b, unrounded. PIL's own ``convert("L")`` rounds to integers, so
PNGs do not go through it; other formats do, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def _read_png(path: str) -> np.ndarray:
    """[H, W] float32 samples of a PNG, as the native reader decodes it."""
    from PIL import Image

    with Image.open(path) as img:
        img.load()
        if img.mode == "P":
            img = img.convert("RGBA" if "transparency" in img.info
                              else "RGB")
        if img.mode in ("L", "I;16", "I;16B", "I;16L", "I", "1"):
            return np.asarray(img.convert("L") if img.mode == "1" else img,
                              dtype=np.float32)
        if img.mode == "LA":
            return np.asarray(img.getchannel("L"), np.float32)
        rgb = np.asarray(img.convert("RGB") if img.mode != "RGB" else img)
    r, g, b = (rgb[..., i].astype(np.float32) for i in range(3))
    return (np.float32(0.299) * r + np.float32(0.587) * g
            + np.float32(0.114) * b)


def _imread_gray(path: str) -> np.ndarray:
    if path.endswith(".png"):
        return _read_png(path)
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32)


def _imread_depth(path: str, factor: float) -> np.ndarray:
    if path.endswith(".png"):
        return _read_png(path) / factor
    from PIL import Image

    return np.asarray(Image.open(path), np.float32) / factor


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association: each stamp of ``ts_a`` takes
    its nearest unused stamp of ``ts_b`` within ``max_dt``."""
    pairs = []
    used_b: set[int] = set()
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        if j in used_b:
            continue
        if abs(ts_b[j] - ta) <= max_dt:
            pairs.append((i, j))
            used_b.add(j)
    return pairs


@dataclasses.dataclass
class TumRGBD:
    """TUM RGB-D sequence directory (rgb.txt / depth.txt lists)."""

    root: str
    depth_factor: float = 5000.0

    def _read_list(self, name):
        ts, files = [], []
        with open(os.path.join(self.root, name)) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, p = line.split()[:2]
                ts.append(float(t))
                files.append(p)
        return np.asarray(ts), files

    def frames(self):
        ts_rgb, rgb = self._read_list("rgb.txt")
        ts_d, dep = self._read_list("depth.txt")
        for i, j in associate(ts_rgb, ts_d):
            gray = _imread_gray(os.path.join(self.root, rgb[i]))
            depth = _imread_depth(os.path.join(self.root, dep[j]),
                                  self.depth_factor)
            yield ts_rgb[i], gray, depth

    def groundtruth(self):
        """[N, 8] (t, tx..qz, qw) from groundtruth.txt if present."""
        p = os.path.join(self.root, "groundtruth.txt")
        if not os.path.exists(p):
            return None
        rows = []
        with open(p) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                rows.append([float(x) for x in line.split()])
        return np.asarray(rows)


@dataclasses.dataclass
class EurocStereo:
    """EuRoC MAV directory (mav0/cam0, mav0/cam1, mav0/imu0/data.csv)."""

    root: str

    def _cam_list(self, cam: str):
        d = os.path.join(self.root, "mav0", cam, "data")
        csv = os.path.join(self.root, "mav0", cam, "data.csv")
        ts, files = [], []
        with open(csv) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                t, name = line.strip().split(",")[:2]
                ts.append(int(t) * 1e-9)
                files.append(os.path.join(d, name))
        return np.asarray(ts), files

    def frames(self):
        ts0, f0 = self._cam_list("cam0")
        ts1, f1 = self._cam_list("cam1")
        for i, j in associate(ts0, ts1, max_dt=0.005):
            yield ts0[i], _imread_gray(f0[i]), _imread_gray(f1[j])

    def imu(self):
        """[N, 7]: t, wx, wy, wz, ax, ay, az."""
        csv = os.path.join(self.root, "mav0", "imu0", "data.csv")
        rows = []
        with open(csv) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                v = line.strip().split(",")
                rows.append([int(v[0]) * 1e-9] + [float(x) for x in v[1:7]])
        return np.asarray(rows)


@dataclasses.dataclass
class KittiStereo:
    """KITTI odometry sequence directory (image_0/, image_1/, times.txt)."""

    root: str

    def frames(self):
        with open(os.path.join(self.root, "times.txt")) as f:
            times = [float(x) for x in f.read().split()]
        for i, t in enumerate(times):
            l = os.path.join(self.root, "image_0", f"{i:06d}.png")
            r = os.path.join(self.root, "image_1", f"{i:06d}.png")
            yield t, _imread_gray(l), _imread_gray(r)
