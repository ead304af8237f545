"""Image-level stereo rectification: precomputed remap tables.

Counterpart of plvs_tpu/geometry/rectify.py. A calibrated non-rectified
pair is warped to a common row-aligned pinhole pair before the row-scan
stereo matcher and the dense stereo engine see it. The rectifying rotations
follow Bouguet's construction (baseline along the rectified x-axis); the
per-camera maps hold, for every rectified pixel, its source pixel through
the original camera model (radtan pinhole or KB8). The maps are built once
on the host in float32 through the port's own ``cameras.project`` and
uploaded; the per-frame warp is one bilinear gather per image.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import resolve_device
from . import cameras as cam_mod


class RectifyMaps(NamedTuple):
    """Precomputed rectification (host numpy; uploaded once)."""

    cam: cam_mod.Camera          # common rectified pinhole (bf set)
    map_l: np.ndarray            # [H, W, 2] source pixel per rectified pixel
    map_r: np.ndarray
    R_rect_l: np.ndarray         # [3, 3] cam_l -> rectified-left rotation
    R_rect_r: np.ndarray         # [3, 3] cam_r -> rectified-right rotation


def stereo_rectify(cam_l: cam_mod.Camera, cam_r: cam_mod.Camera,
                   T_c1_c2: np.ndarray, width: int | None = None,
                   height: int | None = None) -> RectifyMaps:
    """Rectification maps of a calibrated pair. ``T_c1_c2`` is the 4x4
    right-to-left transform X_c1 = R X_c2 + t."""
    T = np.asarray(T_c1_c2, np.float64)
    R_lr = T[:3, :3]
    t_lr = T[:3, 3]                      # right camera centre, left frame
    b = float(np.linalg.norm(t_lr))
    if b < 1e-9:
        raise ValueError("degenerate stereo baseline")
    e1 = t_lr / b
    e2 = np.cross(np.asarray([0.0, 0.0, 1.0]), e1)
    n2 = np.linalg.norm(e2)
    e2 = np.asarray([0.0, 1.0, 0.0]) if n2 < 1e-9 else e2 / n2
    e3 = np.cross(e1, e2)
    R_rect_l = np.stack([e1, e2, e3])    # rows: rectified axes in cam_l
    R_rect_r = R_rect_l @ R_lr

    W = int(width or cam_l.width)
    H = int(height or cam_l.height)
    fx = 0.5 * (cam_l.fx + cam_r.fx)
    fy = 0.5 * (cam_l.fy + cam_r.fy)
    f = 0.5 * (fx + fy)
    rect_cam = cam_mod.pinhole(f, f, W / 2.0, H / 2.0, width=W, height=H,
                               bf=f * b)

    def build_map(src_cam: cam_mod.Camera, R_rect: np.ndarray) -> np.ndarray:
        ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
        uv = np.stack([xs, ys], -1).reshape(-1, 2)
        rays = np.stack([(uv[:, 0] - rect_cam.cx) / rect_cam.fx,
                         (uv[:, 1] - rect_cam.cy) / rect_cam.fy,
                         np.ones(len(uv), np.float32)], -1)
        rays_src = rays @ R_rect.astype(np.float32)   # R_rect^T ray, rowwise
        uv_src = cam_mod.project(src_cam, torch.from_numpy(rays_src)).numpy()
        # behind-camera rays map far outside: the gather zeroes them
        uv_src[rays_src[:, 2] <= 1e-6] = -1e6
        return uv_src.reshape(H, W, 2).astype(np.float32)

    return RectifyMaps(rect_cam, build_map(cam_l, R_rect_l),
                       build_map(cam_r, R_rect_r),
                       R_rect_l.astype(np.float32),
                       R_rect_r.astype(np.float32))


def remap_bilinear(img: torch.Tensor, map_xy: torch.Tensor) -> torch.Tensor:
    """Warp ``img`` [H, W] by ``map_xy`` [H', W', 2] (source pixel per
    output pixel); taps outside the image read 0."""
    H, W = img.shape
    x = map_xy[..., 0]
    y = map_xy[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx_ = x - x0
    fy_ = y - y0
    # XLA's float -> int32 conversion saturates; -1e6 fits either way
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def at(yi, xi):
        ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = img[torch.clamp(yi, 0, H - 1), torch.clamp(xi, 0, W - 1)]
        return torch.where(ok, v, torch.zeros_like(v))

    v00 = at(y0i, x0i)
    v01 = at(y0i, x0i + 1)
    v10 = at(y0i + 1, x0i)
    v11 = at(y0i + 1, x0i + 1)
    return ((1 - fy_) * ((1 - fx_) * v00 + fx_ * v01)
            + fy_ * ((1 - fx_) * v10 + fx_ * v11))


class StereoRectifier:
    """Per-frame rectification front end: device-resident maps, both images
    warped by one gather each."""

    def __init__(self, cam_l: cam_mod.Camera, cam_r: cam_mod.Camera,
                 T_c1_c2: np.ndarray, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.maps = stereo_rectify(cam_l, cam_r, T_c1_c2)
        self._map_l_d = torch.from_numpy(self.maps.map_l).to(self.device)
        self._map_r_d = torch.from_numpy(self.maps.map_r).to(self.device)

    @property
    def cam(self) -> cam_mod.Camera:
        return self.maps.cam

    def __call__(self, gray_l, gray_r):
        def put(g):
            if isinstance(g, torch.Tensor):
                return g.to(self.device, torch.float32)
            return torch.from_numpy(np.asarray(g, np.float32)).to(self.device)

        return (remap_bilinear(put(gray_l), self._map_l_d),
                remap_bilinear(put(gray_r), self._map_r_d))
