"""Per-frame construction: feature extraction + depth association.

Counterpart of the RGB-D parts of plvs_tpu/slam/frame.py (``Frame``,
``FrameLines``, ``build_frame_rgbd``, ``build_frame_lines``,
``project_points``). The depth image may arrive decimated (the quantized
upload of ``System.track_rgbd`` keeps it at 1/dec resolution); consumers
nearest-sample it by scaling the gather indices, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..features import lines as lines_mod
from ..features import orb
from ..geometry import cameras as cam_mod
from ..geometry import lie


class Frame(NamedTuple):
    kp: orb.Keypoints          # fixed-capacity keypoints (xy at level-0 scale)
    uvr: torch.Tensor          # [N, 3] (u, v, uR); uR < 0 => no depth
    depth: torch.Tensor        # [N] metric depth (<= 0 invalid)
    inv_sigma2: torch.Tensor   # [N] information scale per keypoint octave
    xyz_cam: torch.Tensor      # [N, 3] back-projected camera-frame points


class FrameLines(NamedTuple):
    """Per-frame line observations with RGB-D endpoint depths."""

    kl: lines_mod.KeyLines
    nld: torch.Tensor          # [L, 3] normalized image line (nx, ny, d)
    depth_s: torch.Tensor      # [L] start-point depth (<= 0 invalid)
    depth_e: torch.Tensor      # [L] end-point depth
    Xs_cam: torch.Tensor       # [L, 3] back-projected start points
    Xe_cam: torch.Tensor       # [L, 3] back-projected end points


def _sample_depth(depth_img, xy, h, w):
    """Nearest depth at level-0 pixel xy, decimated-depth aware."""
    xi = torch.clamp(lines_mod.round_to_index(xy[:, 0]), 0, w - 1)
    yi = torch.clamp(lines_mod.round_to_index(xy[:, 1]), 0, h - 1)
    dy = h // depth_img.shape[0]
    dx = w // depth_img.shape[1]
    return depth_img[yi // dy, xi // dx]


def build_frame_rgbd(gray: torch.Tensor, depth_img: torch.Tensor,
                     cam: cam_mod.Camera, num_features: int = 1024,
                     n_levels: int = 8, scale: float = 1.2) -> Frame:
    """Grayscale [H, W] + depth (meters, <= 0 invalid) -> Frame; uR is
    synthesized from depth as u - bf / z."""
    kp = orb.extract(gray, num_features, n_levels, scale)
    d = _sample_depth(depth_img, kp.xy, gray.shape[0], gray.shape[1])
    has_depth = (d > 0.0) & kp.mask
    z_safe = torch.where(has_depth, d, 1.0)
    uR = torch.where(has_depth, kp.xy[:, 0] - cam.bf / z_safe, -1.0)
    uvr = torch.cat([kp.xy, uR[:, None]], -1)
    dz = torch.where(has_depth, d, 0.0)
    xyz = cam_mod.backproject(cam, kp.xy, dz)
    return Frame(kp, uvr, dz, orb.inv_scale_sigma2(kp.octave, scale), xyz)


def build_frame_lines(gray: torch.Tensor, depth_img: torch.Tensor,
                      cam: cam_mod.Camera, max_lines: int = 128) -> FrameLines:
    """Line extraction + endpoint depth association for one RGB-D frame."""
    kl = lines_mod.extract_lines(gray, max_lines=max_lines)
    nld = lines_mod.line_nld(kl.sp, kl.ep)
    h, w = gray.shape
    ds = _sample_depth(depth_img, kl.sp, h, w)
    de = _sample_depth(depth_img, kl.ep, h, w)
    Xs = cam_mod.backproject(cam, kl.sp, torch.where(ds > 0, ds, 0.0))
    Xe = cam_mod.backproject(cam, kl.ep, torch.where(de > 0, de, 0.0))
    return FrameLines(kl, nld, ds, de, Xs, Xe)


def project_points(cam: cam_mod.Camera, R, t, xyz, margin: float = 8.0):
    """Project world points into a frame: (uv [M, 2], z [M], valid [M])."""
    Xc = lie.se3_apply(R, t, xyz)
    uv = cam_mod.project(cam, Xc)
    z = Xc[..., 2]
    return uv, z, (z > 0.05) & cam_mod.in_image(cam, uv, margin)
