"""Per-frame construction: feature extraction + depth association.

Counterpart of plvs_tpu/slam/frame.py
(``Frame``, ``FrameLines``, ``build_frame_rgbd``, ``build_frame_mono``,
``build_frame_lines``, ``build_frame_stereo``, ``build_frame_stereo_rig``,
``build_frame_lines_stereo``, ``project_points``). Stereo images are
float32 as given (not quantized), as in JAX. The depth image of an RGB-D
frame may arrive decimated (the quantized upload of ``System.track_rgbd``
keeps it at 1/dec resolution); consumers nearest-sample it by scaling the
gather indices, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..features import lines as lines_mod
from ..features import matching, orb
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


def build_frame_mono(gray: torch.Tensor, cam: cam_mod.Camera,
                     num_features: int = 1024, n_levels: int = 8,
                     scale: float = 1.2) -> Frame:
    """Monocular frame: features only, uR = -1 and zero depth."""
    kp = orb.extract(gray, num_features, n_levels, scale)
    n = kp.xy.shape[0]
    uvr = torch.cat([kp.xy, -torch.ones((n, 1), dtype=kp.xy.dtype,
                                         device=kp.xy.device)], -1)
    z = torch.zeros((n,), dtype=gray.dtype, device=gray.device)
    return Frame(kp, uvr, z, orb.inv_scale_sigma2(kp.octave, scale),
                 torch.zeros((n, 3), dtype=gray.dtype, device=gray.device))


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


def _median_nan(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: NaN if any entry is NaN, else the
    midpoint of the two middle values."""
    s = torch.sort(x).values
    n = x.shape[0]
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(med, torch.nan),
                       med)


def build_frame_stereo(gray_l: torch.Tensor, gray_r: torch.Tensor,
                       cam: cam_mod.Camera, num_features: int = 1024,
                       n_levels: int = 8, scale: float = 1.2,
                       max_disp: float = 128.0, row_tol: float = 2.0) -> Frame:
    """Rectified stereo pair -> Frame with per-keypoint uR / depth: both
    images run the same ORB extraction, right matches come from a row- and
    disparity-gated Hamming matrix with a ratio test, and the disparity is
    refined by a parabola through bilinear SAD costs of a 1x11 strip at
    nine offsets in [-1, 1] px around the matched right keypoint."""
    kp_l = orb.extract(gray_l, num_features, n_levels, scale)
    kp_r = orb.extract(gray_r, num_features, n_levels, scale)
    f32 = torch.float32
    dev = gray_l.device
    h, w = gray_l.shape

    dv = (kp_l.xy[:, None, 1] - kp_r.xy[None, :, 1]).abs()
    tol = row_tol * torch.pow(scale, kp_l.octave.to(f32))[:, None]
    disp = kp_l.xy[:, None, 0] - kp_r.xy[None, :, 0]
    oct_ok = (kp_l.octave[:, None] - kp_r.octave[None, :]).abs() <= 1
    cand = ((dv <= tol) & (disp > 0.1) & (disp < max_disp) & oct_ok
            & kp_l.mask[:, None] & kp_r.mask[None, :])
    dist = matching.hamming(kp_l.desc, kp_r.desc)
    best, second, idx = matching._masked_best2(dist, cand)
    # strict descriptor gate + ratio test: a wrong stereo match poisons depth
    ok = (best <= matching.TH_LOW) & (best.to(f32) <= 0.8 * second.to(f32))

    uR0 = kp_r.xy[idx, 0]
    W = 5
    vi = torch.clamp(lines_mod.round_to_index(kp_l.xy[:, 1]), 0, h - 1)
    offs = torch.arange(-W, W + 1, device=dev)
    ul = torch.clamp(lines_mod.round_to_index(kp_l.xy[:, 0])[:, None]
                     + offs[None, :], 0, w - 1)
    pl = gray_l[vi[:, None], ul]  # [N, 11]

    def sad_at(du):
        u = (uR0 + du)[:, None] + offs[None, :].to(f32)
        u = torch.clamp(u, 0.0, w - 1.001)
        u0 = torch.floor(u).to(torch.int64)
        fu = u - u0
        pr = (gray_r[vi[:, None], u0] * (1 - fu)
              + gray_r[vi[:, None], u0 + 1] * fu)
        return (pl - pr).abs().sum(-1)

    deltas = torch.linspace(-1.0, 1.0, 9, device=dev)
    sads = torch.stack([sad_at(d) for d in deltas])  # [9, N]
    bidx_c = torch.clamp(torch.argmin(sads, dim=0), 1, 7)
    c0 = sads.gather(0, (bidx_c - 1)[None])[0]
    c1 = sads.gather(0, bidx_c[None])[0]
    c2 = sads.gather(0, (bidx_c + 1)[None])[0]
    denom = c0 - 2 * c1 + c2
    step = deltas[1] - deltas[0]
    sub = torch.where(denom.abs() > 1e-6, 0.5 * (c0 - c2) / denom,
                      torch.zeros_like(denom))
    uR = uR0 + deltas[bidx_c] + torch.clamp(sub, -1.0, 1.0) * step
    disparity = kp_l.xy[:, 0] - uR
    ok = ok & (disparity > 0.1) & (disparity < max_disp)
    # photometric outlier gate; like jnp.median, any non-ok keypoint makes
    # the median NaN, which turns the gate off
    sad_best = torch.minimum(torch.minimum(c0, c1), c2)
    med = _median_nan(torch.where(ok, sad_best,
                                  torch.full_like(sad_best, torch.nan)))
    med = torch.where(torch.isnan(med), torch.full_like(med, 1e9), med)
    ok = ok & (sad_best <= 2.1 * med + 1e-3)

    bf = torch.full_like(disparity, cam.bf)
    d = torch.where(ok, bf / torch.clamp(disparity, min=0.1),
                    torch.zeros_like(disparity))
    uR_out = torch.where(ok, uR, torch.full_like(uR, -1.0))
    uvr = torch.cat([kp_l.xy, uR_out[:, None]], -1)
    xyz = cam_mod.backproject(cam, kp_l.xy, d)
    return Frame(kp_l, uvr, d, orb.inv_scale_sigma2(kp_l.octave, scale), xyz)


def _midpoint(dl, dm, t_lr):
    """Two-ray midpoint triangulation in the left frame (left centre 0,
    right centre ``t_lr``; unit rays ``dl`` and ``dm``): (X, depth along
    the left ray, depth along the right ray)."""
    d11 = (dl * dl).sum(-1)
    d12 = (dl * dm).sum(-1)
    d22 = (dm * dm).sum(-1)
    b1 = dl @ t_lr
    b2 = dm @ t_lr
    det = d11 * d22 - d12 * d12
    det = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
    a = (b1 * d22 - b2 * d12) / det
    b = (b1 * d12 - b2 * d11) / det
    X = 0.5 * (a[:, None] * dl + (t_lr + b[:, None] * dm))
    return X, a, b


def _bilinear(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img`` at uv [..., 2], clamped to
    [0, size - 1.001]."""
    h, w = img.shape
    u = torch.clamp(uv[..., 0], 0.0, w - 1.001)
    v = torch.clamp(uv[..., 1], 0.0, h - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    fu, fv = u - u0, v - v0
    return ((img[v0, u0] * (1 - fu) + img[v0, u0 + 1] * fu) * (1 - fv)
            + (img[v0 + 1, u0] * (1 - fu) + img[v0 + 1, u0 + 1] * fu) * fv)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def build_frame_stereo_rig(gray_l: torch.Tensor, gray_r: torch.Tensor,
                           cam_l: cam_mod.Camera, cam_r: cam_mod.Camera,
                           R_lr: torch.Tensor, t_lr: torch.Tensor,
                           num_features: int = 1024, n_levels: int = 8,
                           scale: float = 1.2, epipolar_tol: float = 0.008,
                           reproj_tol: float = 2.0) -> Frame:
    """Non-rectified stereo rig (e.g. a KB8 fisheye pair) -> Frame.
    (R_lr, t_lr) maps right-camera points into the left camera:
    X_l = R_lr X_r + t_lr.

    Both images run the same ORB extraction; right candidates of a left
    keypoint lie on its epipolar plane (|sin| of the angle between the left
    bearing and the plane of the baseline and the right bearing at most
    ``epipolar_tol``) within one octave, matched through the Hamming matrix
    (kernel K1) with a strict gate and a ratio test. Matches are
    triangulated by the two-ray midpoint, kept if in front of both cameras
    and reprojecting within ``reproj_tol`` px (per octave) in both, refined
    by a SAD parabola over 17 steps of [-2, 2] px along the right image's
    epipolar tangent (9x9 bilinear patches) and triangulated again. Depths
    land in ``depth`` / ``xyz_cam``; uR stays -1, so pose residuals are
    monocular on the left camera."""
    kp_l = orb.extract(gray_l, num_features, n_levels, scale)
    kp_r = orb.extract(gray_r, num_features, n_levels, scale)
    f32 = torch.float32
    dev = gray_l.device

    dl = _unit(cam_mod.unproject(cam_l, kp_l.xy))
    dr = _unit(cam_mod.unproject(cam_r, kp_r.xy))
    dr_l = dr @ R_lr.T                       # right rays in the left frame
    # epipolar-plane gate: the left bearing must lie on the plane spanned
    # by the baseline and the right bearing
    n_plane = torch.linalg.cross(t_lr.expand_as(dr_l), dr_l, dim=-1)
    n_plane = n_plane / torch.clamp(
        torch.linalg.norm(n_plane, dim=-1, keepdim=True), min=1e-9)
    epi = (dl @ n_plane.T).abs()             # [N_l, N_r] |sin(angle)|
    oct_ok = (kp_l.octave[:, None] - kp_r.octave[None, :]).abs() <= 1
    cand = ((epi <= epipolar_tol) & oct_ok
            & kp_l.mask[:, None] & kp_r.mask[None, :])
    dist = matching.hamming(kp_l.desc, kp_r.desc)
    best, second, idx = matching._masked_best2(dist, cand)
    ok = (best <= matching.TH_LOW) & (best.to(f32) <= 0.8 * second.to(f32))

    dm = dr_l[idx]
    X, a, b = _midpoint(dl, dm, t_lr)
    # cheirality + reprojection in both cameras
    uv_l = cam_mod.project(cam_l, X)
    uv_r = cam_mod.project(cam_r, (X - t_lr) @ R_lr)
    err_l = torch.linalg.norm(uv_l - kp_l.xy, dim=-1)
    err_r = torch.linalg.norm(uv_r - kp_r.xy[idx], dim=-1)
    tol = reproj_tol * torch.pow(scale, kp_l.octave.to(f32))
    ok = (ok & (a > 0.05) & (b > 0.05) & (X[:, 2] > 0.05)
          & (err_l < tol) & (err_r < tol))

    # subpixel refinement along the right image's epipolar tangent
    uv_r2 = cam_mod.project(cam_r, ((1.05 * a)[:, None] * dl - t_lr) @ R_lr)
    tang = uv_r2 - uv_r
    tang = tang / torch.clamp(torch.linalg.norm(tang, dim=-1, keepdim=True),
                              min=1e-6)
    W = 4  # 9x9 SAD window
    oy, ox = torch.meshgrid(torch.arange(-W, W + 1, device=dev),
                            torch.arange(-W, W + 1, device=dev),
                            indexing="ij")
    win = torch.stack([ox, oy], -1).reshape(-1, 2).to(f32)
    patch_l = _bilinear(gray_l, kp_l.xy[:, None, :] + win[None])  # [N, 81]
    deltas = torch.linspace(-2.0, 2.0, 17, device=dev)
    sads = torch.stack([
        (patch_l - _bilinear(gray_r, (uv_r + s * tang)[:, None, :]
                             + win[None])).abs().sum(-1)
        for s in deltas])                                        # [17, N]
    bidx = torch.clamp(torch.argmin(sads, dim=0), 1, len(deltas) - 2)
    c0 = sads.gather(0, (bidx - 1)[None])[0]
    c1 = sads.gather(0, bidx[None])[0]
    c2 = sads.gather(0, (bidx + 1)[None])[0]
    denom = c0 - 2 * c1 + c2
    step = deltas[1] - deltas[0]
    sub = torch.where(denom.abs() > 1e-6, 0.5 * (c0 - c2) / denom,
                      torch.zeros_like(denom))
    shift = deltas[bidx] + torch.clamp(sub, -1.0, 1.0) * step
    uv_r_ref = uv_r + shift[:, None] * tang

    # re-triangulate with the refined right bearing
    dm2 = _unit(cam_mod.unproject(cam_r, uv_r_ref)) @ R_lr.T
    X2, a2, bb2 = _midpoint(dl, dm2, t_lr)
    refine_ok = ((a2 > 0.05) & (bb2 > 0.05) & (X2[:, 2] > 0.05)
                 & ((a2 - a).abs() < 0.3 * torch.clamp(a, min=1e-3)))
    X = torch.where(refine_ok[:, None], X2, X)

    d = torch.where(ok, X[:, 2], torch.zeros_like(a))
    xyz = torch.where(ok[:, None], X, torch.zeros_like(X))
    uvr = torch.cat([kp_l.xy, torch.full_like(kp_l.xy[:, :1], -1.0)], -1)
    return Frame(kp_l, uvr, d, orb.inv_scale_sigma2(kp_l.octave, scale), xyz)


def build_frame_lines_stereo(gray_l: torch.Tensor, gray_r: torch.Tensor,
                             cam: cam_mod.Camera, max_lines: int = 128,
                             max_disp: float = 128.0, theta_tol: float = 0.08,
                             max_hamming: int = 80) -> FrameLines:
    """Line extraction with endpoint depths from left-right line matching on
    a rectified pair: a left keyline matched to its right counterpart gets,
    at each endpoint (u, v), the disparity u - u_r(v) from the right line's
    equation at the same row. Near-horizontal lines (|nx| <= 0.15) are
    degenerate and get no depth."""
    kl_l = lines_mod.extract_lines(gray_l, max_lines=max_lines)
    kl_r = lines_mod.extract_lines(gray_r, max_lines=max_lines)
    nld_l = lines_mod.line_nld(kl_l.sp, kl_l.ep)
    nld_r = lines_mod.line_nld(kl_r.sp, kl_r.ep)

    th_l, _ = lines_mod.line_theta_d(kl_l.sp, kl_l.ep)
    th_r, _ = lines_mod.line_theta_d(kl_r.sp, kl_r.ep)
    dth = (th_l[:, None] - th_r[None, :]).abs()
    dth = torch.minimum(dth, np.pi - dth)
    # vertical-extent overlap (rows are epipolar lines)
    v_lo_l = torch.minimum(kl_l.sp[:, 1], kl_l.ep[:, 1])
    v_hi_l = torch.maximum(kl_l.sp[:, 1], kl_l.ep[:, 1])
    v_lo_r = torch.minimum(kl_r.sp[:, 1], kl_r.ep[:, 1])
    v_hi_r = torch.maximum(kl_r.sp[:, 1], kl_r.ep[:, 1])
    v_overlap = (torch.minimum(v_hi_l[:, None], v_hi_r[None, :])
                 - torch.maximum(v_lo_l[:, None], v_lo_r[None, :]))
    cand = ((dth < theta_tol) & (v_overlap > 5.0)
            & kl_l.mask[:, None] & kl_r.mask[None, :])
    dist = matching.hamming(kl_l.desc, kl_r.desc)
    best, second, idx = matching._masked_best2(dist, cand)
    ok = (best <= max_hamming) & (
        best.to(torch.float32) <= 0.9 * second.to(torch.float32))

    nr = nld_r[idx]                     # matched right line
    nx, ny, dd = nr[:, 0], nr[:, 1], nr[:, 2]
    nx_ok = nx.abs() > 0.15
    nx_safe = torch.where(nx_ok, nx, torch.ones_like(nx))

    def endpoint_depth(xy):
        u_r = -(ny * xy[:, 1] + dd) / nx_safe
        disp = xy[:, 0] - u_r
        good = ok & nx_ok & (disp > 0.3) & (disp < max_disp) & kl_l.mask
        bf = torch.full_like(disp, cam.bf)
        return torch.where(good, bf / torch.clamp(disp, min=0.3),
                           torch.zeros_like(disp))

    ds = endpoint_depth(kl_l.sp)
    de = endpoint_depth(kl_l.ep)
    # endpoint-depth consistency
    consistent = (ds > 0) & (de > 0) & (
        (ds - de).abs() < 0.5 * torch.maximum(ds, de))
    ds = torch.where(consistent, ds, torch.zeros_like(ds))
    de = torch.where(consistent, de, torch.zeros_like(de))
    Xs = cam_mod.backproject(cam, kl_l.sp, ds)
    Xe = cam_mod.backproject(cam, kl_l.ep, de)
    return FrameLines(kl_l, nld_l, ds, de, Xs, Xe)


def project_points(cam: cam_mod.Camera, R, t, xyz, margin: float = 8.0):
    """Project world points into a frame: (uv [M, 2], z [M], valid [M])."""
    Xc = lie.se3_apply(R, t, xyz)
    uv = cam_mod.project(cam, Xc)
    z = Xc[..., 2]
    return uv, z, (z > 0.05) & cam_mod.in_image(cam, uv, margin)
