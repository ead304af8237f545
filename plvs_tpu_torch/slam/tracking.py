"""Tracking front end: motion-model / local-map tracking + keyframe policy.

Counterpart of plvs_tpu/slam/tracking.py for RGB-D, stereo and monocular
tracking (a stereo frame carries per-keypoint depth like an RGB-D one, a
monocular frame none; all go through ``process_frame``, as in JAX).
The device program (guided matching + pose optimization) runs as torch ops
on the tracker's device; the state machine and map bookkeeping stay on the
host in numpy, as in the JAX package.

Differences from the JAX program, all deliberate:

* the 30 / 60 px motion-model retries (a ``lax.cond`` in JAX) are a
  Python ``if`` on the inlier count: one host read per retry;
* scatters that may receive duplicate targets (``kp_pt.at[tgt].set(src)``
  and the line association) are made deterministic: for each target the
  largest source index wins (:func:`_scatter_last`), which is what XLA on
  the CPU keeps and what ``index_put_`` on CUDA does not promise;
* images reach the device as the quantized tensors themselves (u8 gray,
  u16 millimetre depth, depth decimated on the fast path) instead of the
  JAX package's uint32 plane packing — the quantized values are identical.

A lost map earns the JAX package's grace: RECENTLY_LOST (a map of at
least ``min_kf_recently_lost`` keyframes) until ``time_recently_lost``
seconds, then LOST; every lost frame tries to relocalize against the
keyframe database (BoW candidates of the active map, descriptor matches
through K1, a 3D-3D RANSAC on the frame's depth, then a local-map match of
the candidate's window), and ``new_map_after_lost`` lost frames on a mature
map start a new map of the atlas. The relocalization RANSAC draws from a
``torch.Generator`` seeded 7 (the JAX package's ``PRNGKey(7)``). A
monocular frame has no depth: its relocalization takes the PnP branch
(``solvers/pnp.py`` on the bearings of the matched keypoints, counted in
``n_pnp_calls``), and a monocular map starts from two views
(``_initialize_mono``: a reference frame, wide-window matches, the
``solvers/two_view.py`` reconstruction scaled to median depth 1, two
keyframes). The two-view samples come from a second generator,
``_init_gen`` (the JAX package draws both from one key: its stream cannot
be replayed here anyway).

The inertial runtime (``slam/inertial.py``) drives two fields, as in the
JAX package: ``prior_info``, the information of an SE3 prior at the
predicted pose that enters both fused solves of the frame (on the deferred
path through the assembled context, and into the group key, so frames with
and without a prior never share a launch), and ``imu_coast``: once the IMU
is initialized a lost frame enters RECENTLY_LOST whatever the map's size,
and the pose coasts on the predicted motion until the grace period ends.

Deferred resolution (``pipelined``), as in the JAX package: a tracked frame
is queued and answered with the motion model's pose, extrapolated across
the frames still unresolved; ``resolve_batch`` launches the queued frames
once ``pipeline_depth`` of them wait and hands each result to
``on_resolved``. On the fast path a frame's program is launched only then:
the window's quantized images and candidate rows are stacked into one host
tensor, moved to the device with one copy, and each frame's program runs on
its row. With ``overlap_fetch`` the window's read-back is waited on by a
helper thread (``utils/fetch.py``) and the newest group may stay in flight
until the next drain. The candidate tables a queued frame uses are a
snapshot taken when it was assembled (copied on the CPU too, where a tensor
made from a numpy array shares its memory).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from ..features import lines as lines_mod
from ..features import matching
from ..geometry import cameras as cam_mod
from ..geometry import lie
from ..ops import resolve_device
from ..solvers import pnp, pose_opt, sim3_solver, two_view
from ..utils.fetch import HelperFetch
from ..utils.fetch import to_host as fetch_to_host
from . import frame as frame_mod
from .map_store import MapStore

NO_IMAGES_YET = 0
NOT_INITIALIZED = 1
OK = 2
LOST = 3
RECENTLY_LOST = 5


class PointBlock(NamedTuple):
    """Candidate map points padded to a capacity bucket (device tensors)."""

    xyz: torch.Tensor       # [M, 3]
    desc: torch.Tensor      # [M, 8] int32 words
    octave: torch.Tensor    # [M] int32
    valid: torch.Tensor     # [M] bool
    normal: torch.Tensor    # [M, 3]
    min_dist: torch.Tensor  # [M]
    max_dist: torch.Tensor  # [M]
    angle: torch.Tensor     # [M]


class LineBlock(NamedTuple):
    Xs: torch.Tensor        # [Ml, 3]
    Xe: torch.Tensor        # [Ml, 3]
    desc: torch.Tensor      # [Ml, 8] int32 words
    valid: torch.Tensor     # [Ml] bool


def _point_view_gates(R_pred, t_pred, blk: PointBlock, scale: float,
                      n_levels: int = 8):
    """Scale-invariance distance + viewing-angle gates and the predicted
    octave; points without maintained stats (max_dist == 0) pass ungated.
    Returns (gate_ok [M], pred_octave [M])."""
    C = -(R_pred.T @ t_pred)
    dvec = blk.xyz - C
    dist = torch.linalg.norm(dvec, dim=-1)
    dist_safe = torch.clamp(dist, min=1e-6)
    has_range = blk.max_dist > 1e-6
    dist_ok = (~has_range) | ((dist >= 0.8 * blk.min_dist)
                              & (dist <= 1.2 * blk.max_dist))
    has_norm = torch.linalg.norm(blk.normal, dim=-1) > 0.5
    view_cos = (dvec * blk.normal).sum(-1) / dist_safe
    view_ok = (~has_norm) | (view_cos > 0.5)
    ratio = torch.clamp(blk.max_dist, min=1e-6) / dist_safe
    log_scale = torch.log(torch.tensor(scale, dtype=torch.float32,
                                       device=ratio.device))
    lvl = torch.ceil(torch.log(torch.clamp(ratio, min=1e-6)) / log_scale)
    pred_oct = torch.where(has_range,
                           torch.clamp(lvl, 0, n_levels - 1).to(torch.int32),
                           blk.octave)
    return dist_ok & view_ok, pred_oct


def _scatter_last(n_tgt: int, tgt: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """out[j] = the largest source index i with ok[i] and tgt[i] == j, -1
    where none (out-of-range targets are dropped): the JAX package's ``full(-1).at[tgt].set(arange, mode=
    "drop")`` with duplicates resolved as XLA on the CPU resolves them."""
    src = torch.arange(tgt.shape[0], device=tgt.device)
    out = torch.full((n_tgt + 1,), -1, dtype=src.dtype, device=tgt.device)
    keep = ok & (tgt >= 0) & (tgt < n_tgt)
    out.scatter_reduce_(0, torch.where(keep, tgt, n_tgt), src, reduce="amax")
    return out[:n_tgt]


def _associate_points(cam, R_pred, t_pred, blk: PointBlock, fr, radius,
                      scale, check_rotation):
    """Project + gate + guided-match the block into the frame. Returns
    (idx [M] (-1 none), kp_pt [N] candidate row per keypoint, -1 none)."""
    uv, _, vis = frame_mod.project_points(cam, R_pred, t_pred, blk.xyz)
    gate_ok, pred_oct = _point_view_gates(R_pred, t_pred, blk, scale)
    r = radius * torch.pow(scale, pred_oct.to(torch.float32))
    idx, _ = matching.search_by_projection(
        uv, vis & gate_ok & blk.valid, blk.desc, pred_oct,
        fr.kp.xy, fr.kp.desc, fr.kp.octave, fr.kp.mask, radius=r,
        kp_angle=fr.kp.angle, map_angle=blk.angle,
        check_rotation=check_rotation)
    return idx, _scatter_last(fr.kp.xy.shape[0], idx, idx >= 0)


def _match_and_optimize(cam, R_pred, t_pred, blk: PointBlock, fr, radius,
                        scale: float = 1.2, check_rotation: bool = False,
                        prior_info=None, prior_R=None, prior_t=None):
    """Project candidates into the predicted pose, guided-match, and
    pose-optimize. Returns (R, t, match_idx [M], n_inliers, kp_inlier [N],
    kp_pt [N])."""
    idx, kp_pt = _associate_points(cam, R_pred, t_pred, blk, fr, radius,
                                   scale, check_rotation)
    obs_mask = kp_pt >= 0
    Xw = blk.xyz[torch.clamp(kp_pt, 0, blk.xyz.shape[0] - 1)]
    obs = pose_opt.make_pose_obs(Xw, fr.uvr, fr.inv_sigma2,
                                 obs_mask & fr.kp.mask)
    if prior_info is not None and prior_R is None:
        prior_R, prior_t = R_pred, t_pred
    R, t, inl, _, n_inl = pose_opt.pose_optimize(
        cam, R_pred, t_pred, obs, prior_R=prior_R, prior_t=prior_t,
        prior_info=prior_info)
    return R, t, idx, n_inl, inl & obs_mask, kp_pt


def _match_and_optimize_pl(cam, R_pred, t_pred, blk: PointBlock,
                           lblk: LineBlock, fr, fl, radius,
                           scale: float = 1.2, line_weight: float = 1.0,
                           theta_tol: float = 0.08, d_tol: float = 20.0,
                           check_rotation: bool = False, prior_info=None,
                           prior_R=None, prior_t=None):
    """Joint point+line guided matching and one pose optimization carrying
    both point and line unary terms. Returns (R, t, n_inliers, kp_pt [N],
    kl_ln [Nl]) with the associations pruned to pose-solve inliers."""
    _, kp_pt = _associate_points(cam, R_pred, t_pred, blk, fr, radius, scale,
                                 check_rotation)
    kl = fl.kl
    # -- line association ((theta, d) window + extent overlap) -------------
    Xs_c = lie.se3_apply(R_pred, t_pred, lblk.Xs)
    Xe_c = lie.se3_apply(R_pred, t_pred, lblk.Xe)
    uv_s = cam_mod.project(cam, Xs_c)
    uv_e = cam_mod.project(cam, Xe_c)
    front = (Xs_c[..., 2] > 0.05) & (Xe_c[..., 2] > 0.05)
    in_img = (cam_mod.in_image(cam, uv_s, -40.0)
              | cam_mod.in_image(cam, uv_e, -40.0))
    th_p, d_p = lines_mod.line_theta_d(uv_s, uv_e)
    th_m, d_m = lines_mod.line_theta_d(kl.sp, kl.ep)
    dth = (th_p[:, None] - th_m[None, :]).abs()
    dth = torch.minimum(dth, np.pi - dth)
    dd = (d_p[:, None] - d_m[None, :]).abs()
    mdir = kl.ep - kl.sp
    mlen = torch.linalg.norm(mdir, dim=-1)
    mdirn = mdir / torch.clamp(mlen, min=1e-6)[..., None]
    t_ms = (mdirn * kl.sp).sum(-1)
    t_me = (mdirn * kl.ep).sum(-1)
    m_lo = torch.minimum(t_ms, t_me)
    m_hi = torch.maximum(t_ms, t_me)
    t_ps = uv_s @ mdirn.T
    t_pe = uv_e @ mdirn.T
    p_lo = torch.minimum(t_ps, t_pe)
    p_hi = torch.maximum(t_ps, t_pe)
    overlap = (torch.minimum(p_hi, m_hi[None]) - torch.maximum(p_lo, m_lo[None]))
    ov_ok = overlap > torch.clamp(0.3 * mlen[None], min=8.0)
    lcand = ((dth < theta_tol) & (dd < d_tol) & ov_ok
             & (lblk.valid & front & in_img)[:, None] & kl.mask[None, :])
    ldist = matching.hamming(lblk.desc, kl.desc)
    lbest, lsecond, lidx = matching._masked_best2(ldist, lcand)
    lok = (lbest <= 100) & (lbest.float() <= 0.85 * lsecond.float())
    kl_ln = _scatter_last(kl.sp.shape[0], lidx, lok)

    # -- joint pose optimization -------------------------------------------
    obs_mask = kp_pt >= 0
    Xw = blk.xyz[torch.clamp(kp_pt, 0, blk.xyz.shape[0] - 1)]
    l_mask = kl_ln >= 0
    l_safe = torch.clamp(kl_ln, 0, lblk.Xs.shape[0] - 1)
    obs = pose_opt.make_pose_obs(
        Xw, fr.uvr, fr.inv_sigma2, obs_mask & fr.kp.mask,
        line_Xs=lblk.Xs[l_safe], line_Xe=lblk.Xe[l_safe],
        line_nld=lines_mod.line_nld(kl.sp, kl.ep),
        line_inv_sigma2=torch.clamp((mlen / 40.0) ** 2, 0.1, 4.0),
        line_mask=l_mask & kl.mask)
    if prior_info is not None and prior_R is None:
        prior_R, prior_t = R_pred, t_pred
    R, t, inl, l_inl, n_inl = pose_opt.pose_optimize(
        cam, R_pred, t_pred, obs, line_weight=line_weight, prior_R=prior_R,
        prior_t=prior_t, prior_info=prior_info)
    kp_pt = torch.where(inl & obs_mask, kp_pt, -1)
    kl_ln = torch.where(l_inl & l_mask, kl_ln, -1)
    return R, t, n_inl, kp_pt, kl_ln


def _track_frame_fused(cam, R_pred, t_pred, b1: PointBlock, b2: PointBlock,
                       fr, fl=None, lblk: LineBlock | None = None,
                       scale: float = 1.2, line_weight: float = 1.0,
                       check_rotation: bool = False, prior_info=None):
    """The whole visual tracking step: motion-model match + pose solve
    against the last frame's points, widened to 30 and then 60 px while it
    finds fewer than 20 inliers, then the local-map match + pose solve —
    joint with lines when ``fl`` is given (the JAX package's
    ``_track_frame_fused_pl`` / ``_pts``). Returns (R2, t2, n1, n2,
    kp_pt_local [N], kl_ln_local [Nl] or None)."""
    def step1(radius):
        R, t, _, n, _, _ = _match_and_optimize(
            cam, R_pred, t_pred, b1, fr, radius, scale, check_rotation,
            prior_info)
        return R, t, n

    R1, t1, n1 = step1(15.0)
    for radius in (30.0, 60.0):
        if int(n1) < 20:
            R1, t1, n1 = step1(radius)
    # the prior stays anchored at the predicted pose in both solves
    if fl is None:
        R2, t2, _, n2, kp_inl, kp_pt = _match_and_optimize(
            cam, R1, t1, b2, fr, 4.0, scale, check_rotation, prior_info,
            prior_R=R_pred, prior_t=t_pred)
        return R2, t2, n1, n2, torch.where(kp_inl, kp_pt, -1), None
    R2, t2, n2, kp_pt, kl_ln = _match_and_optimize_pl(
        cam, R1, t1, b2, lblk, fr, fl, 4.0, scale, line_weight,
        check_rotation=check_rotation, prior_info=prior_info,
        prior_R=R_pred, prior_t=t_pred)
    return R2, t2, n1, n2, kp_pt, kl_ln


def _block_from_tables(tbl, ids: torch.Tensor) -> PointBlock:
    """Device-side candidate gather from the resident landmark tables; -1
    ids become invalid rows."""
    xyz, desc, normal, min_d, max_d, angle, mask = tbl
    safe = torch.clamp(ids, 0, xyz.shape[0] - 1)
    return PointBlock(xyz[safe], desc[safe],
                      torch.zeros(ids.shape, dtype=torch.int32,
                                  device=ids.device),
                      (ids >= 0) & mask[safe], normal[safe], min_d[safe],
                      max_d[safe], angle[safe])


def _pack_track_out(R2, t2, n1, n2, kp_pt_local, kl_ln_local=None):
    """All tracking outputs in one int32 vector, so the host reads them
    with one device-to-host copy:
    [R2 bits (9) | t2 bits (3) | n1 | n2 | kp_pt_local | kl_ln_local]."""
    dev = kp_pt_local.device
    parts = [R2.reshape(-1).contiguous().view(torch.int32),
             t2.contiguous().view(torch.int32),
             torch.stack([torch.as_tensor(n1, device=dev),
                          torch.as_tensor(n2, device=dev)]).to(torch.int32),
             kp_pt_local.to(torch.int32)]
    if kl_ln_local is not None:
        parts.append(kl_ln_local.to(torch.int32))
    return torch.cat(parts)


def _unpack_track_out(buf: np.ndarray, n_kp: int, n_kl: int | None):
    """Host-side inverse of _pack_track_out (buf: int32 numpy)."""
    R2 = buf[:9].view(np.float32).reshape(3, 3).copy()
    t2 = buf[9:12].view(np.float32).copy()
    n1, n2 = int(buf[12]), int(buf[13])
    kp_pt_local = buf[14:14 + n_kp]
    if n_kl is None:
        return R2, t2, n1, n2, kp_pt_local, None
    return R2, t2, n1, n2, kp_pt_local, buf[14 + n_kp: 14 + n_kp + n_kl]


def _unpack_meta(meta: torch.Tensor, icap: int, lcap: int):
    """[2*icap + lcap + 12] int32 -> (ids12 [2, icap], lids [lcap], R, t):
    both candidate id sets, the line ids and the predicted pose (float32
    bits) arrive in one host-to-device copy."""
    ids12 = meta[: 2 * icap].reshape(2, icap).to(torch.int64)
    lids = meta[2 * icap: 2 * icap + lcap].to(torch.int64)
    Rt = meta[2 * icap + lcap:].contiguous().view(torch.float32)
    return ids12, lids, Rt[:9].reshape(3, 3), Rt[9:]


def _decompress_packed(g8: torch.Tensor, d16: torch.Tensor):
    """Quantized planes -> (gray [h, w] float32, depth float32 metres). The
    depth stays at its upload resolution; consumers nearest-sample it by
    index scaling."""
    return g8.to(torch.float32), d16.to(torch.float32) * 0.001


def _track_frame_tables(cam, meta, pt_tbl, ln_tbl, fr, fl, icap: int,
                        lcap: int, scale: float = 1.2,
                        line_weight: float = 1.0,
                        check_rotation: bool = False, prior_info=None):
    """Candidate gather from the resident tables + the fused tracking step
    for already built frame arrays; returns the packed output."""
    ids12, lids, R_pred, t_pred = _unpack_meta(meta, icap, lcap)
    b1 = _block_from_tables(pt_tbl, ids12[0])
    b2 = _block_from_tables(pt_tbl, ids12[1])
    lblk = None
    if fl is not None:
        Xs_t, Xe_t, ldesc_t, lmask_t = ln_tbl
        lsafe = torch.clamp(lids, 0, Xs_t.shape[0] - 1)
        lblk = LineBlock(Xs_t[lsafe], Xe_t[lsafe], ldesc_t[lsafe],
                         (lids >= 0) & lmask_t[lsafe])
    R2, t2, n1, n2, kp_pt, kl_ln = _track_frame_fused(
        cam, R_pred, t_pred, b1, b2, fr, fl, lblk, scale, line_weight,
        check_rotation, prior_info)
    return _pack_track_out(R2, t2, n1, n2, kp_pt, kl_ln)


def _frame_track_rgbd_pl(cam, g8, d16, meta, pt_tbl, ln_tbl,
                         num_features: int, n_levels: int, scale: float,
                         max_lines: int | None, icap: int, lcap: int,
                         line_weight: float = 1.0,
                         check_rotation: bool = False, prior_info=None):
    """The per-frame RGB-D program: decompression + ORB extraction + line
    extraction (``max_lines=None``: points only) + guided matching + joint
    pose solve. Returns (packed_track_out, Frame, FrameLines | None), all
    on the device."""
    gray, depth = _decompress_packed(g8, d16)
    fr = frame_mod.build_frame_rgbd(gray, depth, cam, num_features,
                                    n_levels, scale)
    fl = (None if max_lines is None
          else frame_mod.build_frame_lines(gray, depth, cam, max_lines))
    out = _track_frame_tables(cam, meta, pt_tbl, ln_tbl, fr, fl, icap, lcap,
                              scale, line_weight, check_rotation, prior_info)
    return out, fr, fl


def to_host(x):
    """Device NamedTuple (Frame / FrameLines / KeyLines...) -> numpy, with
    descriptor words viewed as the store's uint32."""
    if isinstance(x, tuple):
        return type(x)(*(to_host(v) for v in x))
    a = x.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 and a.ndim == 2 \
        and a.shape[1] == 8 else a


@dataclasses.dataclass
class TrackResult:
    state: int
    R: np.ndarray
    t: np.ndarray
    n_inliers: int
    kp_pt_id: np.ndarray | None  # [N] global map-point id per keypoint
    is_keyframe: bool = False
    kf_id: int = -1
    kl_ln_id: np.ndarray | None = None  # [Nl] line-landmark id per keyline


class Tracker:
    """Host-side tracking state machine (RGB-D, stereo or monocular)."""

    def __init__(self, cam: cam_mod.Camera, store: MapStore,
                 num_features: int = 1024, local_pts_cap: int = 4096,
                 min_kf_inliers: int = 30, kf_ratio: float = 0.75,
                 max_kf_interval: int = 10, max_depth_factor: float = 40.0,
                 use_lines: bool = False, local_lines_cap: int = 512,
                 sensor: str = "rgbd", fov_centers_kf: bool = False,
                 max_fov_centers_distance: float = 0.4,
                 min_init_pts: int = 300, line_track_weight: float = 2.0,
                 kfdb=None, new_map_after_lost: int = 150,
                 device: str | torch.device = "cuda"):
        if sensor not in ("rgbd", "stereo", "mono"):
            raise ValueError(f"unknown sensor {sensor!r}")
        self.device = resolve_device(device)
        self.cam = cam
        self.store = store
        self._tbl_cache = None  # device-resident landmark tables
        # deferred resolution (set by the System): queued frames, launched
        # groups [(group, future | None, outs)] and the helper-thread
        # fetcher; each resolved frame goes to on_resolved
        self.pipelined = False
        self.pipeline_depth = 1
        self._pending = []
        self.overlap_fetch = False
        self._inflight = []
        self._fetch_pool = None
        self.on_resolved = None
        self.timing = None  # optional list of (fetch_s, finish_s, n)
        self.fixed_shapes = False
        self.num_features = num_features
        self.local_pts_cap = local_pts_cap
        self.min_kf_inliers = min_kf_inliers
        self.kf_ratio = kf_ratio
        self.max_kf_interval = max_kf_interval
        self.use_lines = use_lines
        self.local_lines_cap = local_lines_cap
        self.line_track_weight = line_track_weight
        self.check_rotation = True
        self.scale = 1.2
        self.n_levels = 8
        self.max_keylines = 128
        self.depth_decimation = 1
        self.kfdb = kfdb  # KeyFrameDatabase, for relocalization
        self.sensor = sensor
        # RANSAC samples: relocalization's (the JAX package's PRNGKey(7))
        # and the monocular initializer's two-view
        self._reloc_gen = torch.Generator(device=self.device).manual_seed(7)
        self._init_gen = torch.Generator(device=self.device).manual_seed(7)
        self._init_frame = None  # monocular initializer reference frame
        self.n_pnp_calls = 0     # relocalization PnP RANSACs run
        self.max_depth = max_depth_factor * (cam.bf / float(cam.params[0]))
        self.line_max_depth = max(20.0, 2.0 * self.max_depth)
        self.state = NO_IMAGES_YET
        self.R = np.eye(3, dtype=np.float32)
        self.t = np.zeros(3, np.float32)
        self.vel_R = np.eye(3, dtype=np.float32)  # motion model: T_curr_last
        self.vel_t = np.zeros(3, np.float32)
        self._vel_warm = 0
        self.last_frame = None
        self.last_kp_pt_id = None
        self.ref_kf = -1
        self.ref_kf_npts = 0
        self.frames_since_kf = 0
        self.frame_id = 0
        # after this many consecutive LOST frames on a map of >= 5
        # keyframes, park it and start a new one (0 disables)
        self.new_map_after_lost = new_map_after_lost
        self.lost_frames = 0
        self.maps_created = 0
        # RECENTLY_LOST grace period (seconds), for maps of enough keyframes
        self.time_recently_lost = 5.0
        self.min_kf_recently_lost = 10
        # set by the System once the IMU is initialized: RECENTLY_LOST
        # without the keyframe gate, coasting on the predicted motion
        self.imu_coast = False
        self._lost_ts = 0.0
        # [6, 6] information of an SE3 prior at the predicted pose, set per
        # frame by the inertial runtime (None: vision-only solves)
        self.prior_info: np.ndarray | None = None
        self.only_tracking = False
        self.fov_centers_kf = fov_centers_kf
        self.max_fov_centers_distance = max_fov_centers_distance
        self._kf_fov_center: dict[int, np.ndarray] = {}
        self.min_init_pts = min_init_pts

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _snapshot(self, a) -> torch.Tensor:
        """A device copy of store rows that later store writes leave
        alone: on the CPU ``_t`` would share the numpy array's memory, and
        a frame launched frames after its assembly would read the changed
        rows."""
        t = self._t(a)
        return t.clone() if t.device.type == "cpu" else t

    # ------------------------------------------------------------------
    def process_frame(self, fr: frame_mod.Frame, timestamp: float,
                      fl=None) -> TrackResult:
        if (self._pending or self._inflight) and self.state != OK:
            # queued frames are outstanding while the state left OK: finish
            # them first
            self.resolve_batch(force=True)
        if self.state in (NO_IMAGES_YET, NOT_INITIALIZED):
            res = (self._initialize_mono(fr, timestamp)
                   if self.sensor == "mono"
                   else self._initialize_depth(fr, timestamp, fl))
        elif self.state == RECENTLY_LOST:
            res = self._relocalize(fr, timestamp)
            if res.state != OK:
                if self.imu_coast:
                    # publish the predicted pose while the grace lasts
                    self.R = (self.vel_R @ self.R).astype(np.float32)
                    self.t = (self.vel_R @ self.t + self.vel_t).astype(
                        np.float32)
                if timestamp - self._lost_ts > self.time_recently_lost:
                    self.state = LOST
                res = TrackResult(self.state, self.R, self.t, res.n_inliers,
                                  res.kp_pt_id)
        elif self.state == LOST:
            res = self._relocalize(fr, timestamp)
            if res.state != OK:
                self.lost_frames += 1
                if (self.new_map_after_lost
                        and self.lost_frames >= self.new_map_after_lost
                        and len(self.store.kfs_of_map(
                            self.store.active_map)) >= 5):
                    self._create_map_in_atlas()
            else:
                self.lost_frames = 0
        else:
            res = self._track(fr, timestamp, fl)
            self.lost_frames = 1 if res.state == LOST else 0
        self.last_frame = fr
        self.frame_id += 1
        return res

    def _create_map_in_atlas(self):
        """Park the current map in the atlas and start a new one; the next
        frame initializes it."""
        self.store.create_map()
        self.maps_created += 1
        self._reset_tracking()

    def _reset_tracking(self):
        self.state = NOT_INITIALIZED
        self.R = np.eye(3, dtype=np.float32)
        self.t = np.zeros(3, np.float32)
        self.vel_R = np.eye(3, dtype=np.float32)
        self.vel_t = np.zeros(3, np.float32)
        self._vel_warm = 0
        self.ref_kf = -1
        self.ref_kf_npts = 0
        self.frames_since_kf = 0
        self.lost_frames = 0
        self._init_frame = None
        self.last_kp_pt_id = None

    def reset_state(self):
        """Back to the pre-initialization state without touching the map;
        queued frames are resolved first (dropped only when that fails)."""
        if self._pending or self._inflight:
            try:
                self.resolve_batch(force=True)
            except Exception:
                pass
        self._pending = []
        self._inflight = []
        self._reset_tracking()
        self._kf_fov_center.clear()

    def _relocalize(self, fr: frame_mod.Frame, timestamp: float) -> TrackResult:
        """Recover a lost frame against the keyframe database: candidates
        of the active map, descriptor matches to each (K1), a 3D-3D SE3
        RANSAC from the frame's back-projected keypoints to the matched
        landmarks (15 matches with depth, 15 inliers) or, without depth, a
        PnP RANSAC on their bearings (12 and 12), then a local-map match
        of the candidate's window from that pose; the first candidate with
        30 inliers wins. Runs under the store's lock."""
        with self.store.lock:
            return self._relocalize_locked(fr, timestamp)

    def _relocalize_locked(self, fr: frame_mod.Frame,
                           timestamp: float) -> TrackResult:
        st = self.store
        empty = np.full((fr.kp.xy.shape[0],), -1, np.int64)
        if self.kfdb is None:
            return TrackResult(self.state, self.R, self.t, 0, empty)
        cands = self.kfdb.relocalization_candidates(fr.kp.desc, fr.kp.mask)
        cands = [(k, s) for k, s in cands if st.kf_map[k] == st.active_map]
        depth = to_host(fr.depth)
        for kf_id, _score in cands:
            m_kf = st.kf_kp_mask[kf_id] & (st.kf_kp_pt[kf_id] >= 0)
            idx, _ = matching.match_nn_ratio(
                fr.kp.desc, self._t(st.kf_kp_desc[kf_id].view(np.int32)),
                fr.kp.mask, self._t(m_kf), max_dist=64, ratio=0.85)
            idx = idx.cpu().numpy()
            sel = np.nonzero((idx >= 0) & (depth > 0))[0]
            if len(sel) >= 15:
                P = fr.xyz_cam[self._t(sel)]                   # camera frame
                Q = self._t(st.pt_xyz[st.kf_kp_pt[kf_id][idx[sel]]])  # world
                res = sim3_solver.sim3_ransac(
                    P, Q, torch.ones((len(sel),), dtype=torch.bool,
                                     device=self.device),
                    self._reloc_gen, with_scale=False, inlier_thresh=0.10)
                if int(res.n_inliers) < 15:
                    continue
                Rwc = res.R.cpu().numpy()
                twc = res.t.cpu().numpy()
                R0 = Rwc.T.astype(np.float32)
                t0 = (-Rwc.T @ twc).astype(np.float32)
            else:
                # no per-keypoint depth (monocular): 2D-3D PnP RANSAC on
                # the bearings of the matched keypoints
                sel = np.nonzero(idx >= 0)[0]
                if len(sel) < 12:
                    continue
                Xw = self._t(st.pt_xyz[st.kf_kp_pt[kf_id][idx[sel]]])
                rays = cam_mod.unproject(self.cam, fr.kp.xy[self._t(sel)])
                uvn = rays[:, :2] / torch.clamp(rays[:, 2:3], min=1e-9)
                self.n_pnp_calls += 1
                res = pnp.pnp_ransac(
                    Xw, uvn, torch.ones((len(sel),), dtype=torch.bool,
                                        device=self.device),
                    self._reloc_gen, inlier_thresh=4.0 / float(self.cam.fx))
                if int(res.n_inliers) < 12:
                    continue
                R0 = res.R.cpu().numpy().astype(np.float32)
                t0 = res.t.cpu().numpy().astype(np.float32)
            # refine with the candidate's local map
            covis, _ = st.covisibility(kf_id, min_weight=5)
            window = np.concatenate([[kf_id], covis[:10]])
            pts = st.points_in_kfs(window)
            pts = pts[st.pt_mask[pts]]
            R2, t2, n2, kp_pt2 = self._match_step(fr, R0, t0, pts, radius=8.0)
            if n2 < 30:
                continue
            self.R, self.t = R2, t2
            self.vel_R = np.eye(3, dtype=np.float32)
            self.vel_t = np.zeros(3, np.float32)
            self._vel_warm = 0
            self.state = OK
            self.ref_kf = kf_id
            self.ref_kf_npts = -1
            self.last_kp_pt_id = kp_pt2
            return TrackResult(OK, R2, t2, int(n2), kp_pt2)
        return TrackResult(self.state, self.R, self.t, 0, empty)

    # ------------------------------------------------------------------
    def _initialize_mono(self, fr: frame_mod.Frame,
                         timestamp: float) -> TrackResult:
        """Monocular initialization: a reference frame (>= 100 features),
        then wide-window matches to a later frame (>= 100, else that frame
        becomes the reference) and the two-view reconstruction; the map is
        scaled to median depth 1, KF0 sits at the origin and KF1 at the
        recovered pose, both observing the triangulated points."""
        with self.store.lock:
            return self._initialize_mono_locked(fr, timestamp)

    def _initialize_mono_locked(self, fr: frame_mod.Frame,
                                timestamp: float) -> TrackResult:
        st = self.store
        n_kp = fr.kp.xy.shape[0]
        empty = np.full((n_kp,), -1, np.int64)
        n_feat = int(fr.kp.mask.sum())
        if self._init_frame is None:
            if n_feat >= 100:
                self._init_frame = (fr, timestamp)
            return TrackResult(NOT_INITIALIZED, self.R, self.t, 0, empty)
        fr0, ts0 = self._init_frame
        if n_feat < 100:
            self._init_frame = None
            return TrackResult(NOT_INITIALIZED, self.R, self.t, 0, empty)
        idx, _ = matching.search_for_initialization(
            fr0.kp.xy, fr0.kp.desc, fr0.kp.mask, fr.kp.xy, fr.kp.desc,
            fr.kp.mask)
        idx = idx.cpu().numpy()
        sel = np.nonzero(idx >= 0)[0]
        if len(sel) < 100:
            self._init_frame = (fr, timestamp)  # reference too old; restart
            return TrackResult(NOT_INITIALIZED, self.R, self.t, 0, empty)
        p0 = cam_mod.unproject(self.cam, fr0.kp.xy[self._t(sel)])[:, :2]
        p1 = cam_mod.unproject(self.cam, fr.kp.xy[self._t(idx[sel])])[:, :2]
        res = two_view.reconstruct(
            p0.contiguous(), p1.contiguous(),
            torch.ones((len(sel),), dtype=torch.bool, device=self.device),
            self._init_gen, sigma=1.0 / float(self.cam.fx), min_good=80)
        success, inl, X, R21, t21 = fetch_to_host(
            (res.success, res.inliers, res.points3d, res.R21, res.t21))
        if not bool(success):
            return TrackResult(NOT_INITIALIZED, self.R, self.t, 0, empty)
        # scale: median depth -> 1
        med = max(float(np.median(X[inl, 2])), 1e-6)
        X = X / med
        t21 = t21 / med
        self.R = np.eye(3, dtype=np.float32)
        self.t = np.zeros(3, np.float32)
        kf0, _ = self._create_keyframe(fr0, ts0, np.full((n_kp,), -1))
        pt_ids = st.alloc_pts(int(inl.sum()))
        st.version += 1
        st.pt_xyz[pt_ids] = X[inl]
        st.pt_desc[pt_ids] = to_host(fr0.kp.desc)[sel[inl]]
        st.pt_mask[pt_ids] = True
        st.pt_ref_kf[pt_ids] = kf0
        st.pt_first_kf[pt_ids] = kf0
        st.pt_visible[pt_ids] = 1
        st.pt_found[pt_ids] = 1
        st.add_observations(kf0, pt_ids, sel[inl])
        self.R = R21.astype(np.float32)
        self.t = t21.astype(np.float32)
        kf1, _ = self._create_keyframe(fr, timestamp, empty.copy())
        st.add_observations(kf1, pt_ids, idx[sel[inl]])
        st.kf_kp_pt[kf1, idx[sel[inl]]] = pt_ids
        self.state = OK
        self.ref_kf = kf1
        self.ref_kf_npts = -1
        self.frames_since_kf = 0
        self.last_kp_pt_id = np.asarray(st.kf_kp_pt[kf1]).copy()
        self._init_frame = None
        return TrackResult(OK, self.R, self.t, int(inl.sum()),
                           self.last_kp_pt_id, True, kf1)

    # ------------------------------------------------------------------
    def _initialize_depth(self, fr: frame_mod.Frame, timestamp: float,
                          fl=None) -> TrackResult:
        """The first frame with enough features and depth points becomes the
        map origin."""
        n_feat = int(fr.kp.mask.sum())
        n_depth = int((fr.depth > 0).sum())
        enough = (n_depth >= self.min_init_pts
                  or (n_feat >= self.min_init_pts and n_depth >= 50))
        n_kp = fr.kp.xy.shape[0]
        if not enough:
            return TrackResult(self.state, self.R, self.t, 0,
                               np.full((n_kp,), -1))
        self.R = np.eye(3, dtype=np.float32)
        self.t = np.zeros(3, np.float32)
        kf_id, pt_ids = self._create_keyframe(
            fr, timestamp, np.full((n_kp,), -1), fl, None)
        self.state = OK
        self.ref_kf = kf_id
        self.ref_kf_npts = -1  # baselined on the first tracked frame
        self.frames_since_kf = 0
        kp_pt = np.asarray(self.store.kf_kp_pt[kf_id]).copy()
        self.last_kp_pt_id = kp_pt
        return TrackResult(self.state, self.R, self.t, len(pt_ids), kp_pt,
                           True, kf_id)

    # ------------------------------------------------------------------
    def _assemble_fused(self, use_pl: bool):
        """Candidates + motion-model prediction for the fused program, or
        None when there is nothing to match yet. The prediction extrapolates
        the motion model across the queued and in-flight frames (self.R and
        the velocity describe the last resolved frame). The store is read
        under its lock: the mapper actor mutates it from its own thread."""
        with self.store.lock:
            return self._assemble_fused_locked(use_pl)

    def _assemble_fused_locked(self, use_pl: bool):
        lag = 0
        if self.pipelined:
            lag = len(self._pending) + sum(
                len(g) for g, _f, _o in self._inflight)
        R_pred, t_pred = self.R, self.t
        for _ in range(lag + 1):
            t_pred = (self.vel_R @ t_pred + self.vel_t).astype(np.float32)
            R_pred = (self.vel_R @ R_pred).astype(np.float32)
        last_ids = self.last_kp_pt_id
        if last_ids is None:
            return None
        cand = np.unique(last_ids[last_ids >= 0])
        local_pts = self._local_points()
        if len(cand) == 0 or len(local_pts) == 0:
            return None
        cand1 = cand[: self.local_pts_cap]
        cand2 = local_pts[: self.local_pts_cap]
        m2 = len(cand2)
        icap = self._cap_bucket(max(len(cand1), m2), self.local_pts_cap,
                                lo=2048 if self.fixed_shapes else 512)
        pt_tbl, ln_tbl = self._device_tables()
        Rt_bits = np.concatenate([R_pred.ravel(), t_pred]).view(np.int32)
        cand_lines = np.zeros((0,), np.int64)
        ml = lcap = 0
        if use_pl:
            local_lns = self._local_lines()
            lcap = self._cap_bucket(max(len(local_lns), 1),
                                    self.local_lines_cap, lo=128)
            ml = min(len(local_lns), lcap)
            cand_lines = local_lns[:ml]
        meta = np.full((2 * icap + lcap + 12,), -1, np.int32)
        meta[:len(cand1)] = cand1
        meta[icap: icap + m2] = cand2
        meta[2 * icap: 2 * icap + ml] = cand_lines
        meta[2 * icap + lcap:] = Rt_bits
        prior = (None if self.prior_info is None else torch.tensor(
            np.asarray(self.prior_info, np.float32), device=self.device))
        return dict(meta=meta, icap=icap, lcap=lcap, pt_tbl=pt_tbl,
                    ln_tbl=ln_tbl, cand=cand, cand2=cand2, m2=m2,
                    cand_lines=cand_lines, ml=ml, local_pts=local_pts,
                    R_pred=R_pred, t_pred=t_pred, prior=prior)

    def _ctx_from(self, asm, fr, fl, timestamp, use_pl):
        return dict(asm, fr=fr, fl=fl, timestamp=timestamp, use_pl=use_pl,
                    n_kp=int(fr.kp.xy.shape[0]),
                    n_kl=int(fl.kl.sp.shape[0]) if use_pl else None,
                    seq=self.frame_id)

    def _prepare_fused_packed(self, g8: np.ndarray, d16: np.ndarray,
                              timestamp: float):
        """Assemble the fast path's context without touching the device:
        one host row [gray u8 | depth u16 | candidate meta int32], as bytes,
        uploaded with the rest of its window when the window is launched."""
        use_pl = self.use_lines
        asm = self._assemble_fused(use_pl)
        if asm is None:
            return None
        row = np.concatenate([np.ascontiguousarray(g8).reshape(-1),
                              np.ascontiguousarray(d16).view(np.uint8)
                              .reshape(-1), asm["meta"].view(np.uint8)])
        return dict(asm, out=None, fr=None, fl=None, row=row,
                    g8_shape=g8.shape, d16_shape=d16.shape,
                    timestamp=timestamp, use_pl=use_pl, seq=self.frame_id)

    def _launch_group(self, group):
        """Stack the group's rows into one host tensor, move it to the
        device with one copy and run each frame's program on its row (fills
        the contexts' out / fr / fl)."""
        rows = torch.from_numpy(np.stack([c["row"] for c in group])).to(
            self.device)
        for row, c in zip(rows, group):
            n_g = int(np.prod(c["g8_shape"]))
            n_d = 2 * int(np.prod(c["d16_shape"]))
            g8 = row[:n_g].view(c["g8_shape"])
            d16 = (row[n_g:n_g + n_d].view(torch.int16).to(torch.int32)
                   & 0xFFFF).view(c["d16_shape"])
            meta = row[n_g + n_d:].view(torch.int32)
            out, fr, fl = _frame_track_rgbd_pl(
                self.cam, g8, d16, meta, c["pt_tbl"], c["ln_tbl"],
                num_features=self.num_features, n_levels=self.n_levels,
                scale=self.scale,
                max_lines=self.max_keylines if c["use_pl"] else None,
                icap=c["icap"], lcap=c["lcap"],
                line_weight=self.line_track_weight,
                check_rotation=self.check_rotation, prior_info=c["prior"])
            c.update(out=out, fr=fr, fl=fl, n_kp=int(fr.kp.xy.shape[0]),
                     n_kl=int(fl.kl.sp.shape[0]) if c["use_pl"] else None)

    @staticmethod
    def _group_key(c):
        """Shape signature of a queued frame: consecutive frames that share
        it are launched and fetched together."""
        if c.get("row") is None:
            return ("dispatched", tuple(c["out"].shape))
        return ("packed", c["use_pl"], len(c["row"]), c["icap"], c["lcap"],
                tuple(c["g8_shape"]), c["pt_tbl"][0].shape[0],
                c["ln_tbl"][0].shape[0] if c["use_pl"] else 0,
                c["prior"] is None)

    def process_frame_packed(self, g8: np.ndarray, d16: np.ndarray,
                             timestamp: float):
        """Fast path for the steady OK state: the whole frame (decompress +
        extract + match + solve) is one device program fed the quantized
        image planes. Returns a TrackResult (a provisional one when
        pipelined), or None when the caller must take the separate-build
        path (non-OK state, no candidates)."""
        if self.state != OK:
            return None
        ctx = self._prepare_fused_packed(g8, d16, timestamp)
        if ctx is None:
            return None
        self.last_frame = None  # the frame's arrays exist once launched
        if self.pipelined:
            self._pending.append(ctx)
            self.frame_id += 1
            return TrackResult(OK, ctx["R_pred"], ctx["t_pred"], -1, None)
        self._launch_group([ctx])
        res = self._finish_fused(ctx["out"].cpu().numpy(), ctx)
        self.last_frame = ctx["fr"]
        self.lost_frames = 1 if res.state == LOST else 0
        self.frame_id += 1
        return res

    def _finish_fused(self, buf: np.ndarray, ctx) -> TrackResult:
        """Interpret the fused program's packed output (under the store's
        lock: the visibility counters, the keyframe decision and creation
        read and write the map)."""
        with self.store.lock:
            return self._finish_fused_locked(buf, ctx)

    def _finish_fused_locked(self, buf: np.ndarray, ctx) -> TrackResult:
        st = self.store
        fr, fl = ctx["fr"], ctx["fl"]
        timestamp = ctx["timestamp"]
        m2, cand2 = ctx["m2"], ctx["cand2"]
        R2, t2, n1, n2, kp_pt_local, kl_ln_local = _unpack_track_out(
            buf, ctx["n_kp"], ctx["n_kl"])
        kl_ln_id = None
        if ctx["use_pl"]:
            ml, cand_lines = ctx["ml"], ctx["cand_lines"]
            kl_ln_id = np.full((fl.kl.sp.shape[0],), -1, np.int64)
            okl = (kl_ln_local >= 0) & (kl_ln_local < ml)
            kl_ln_id[okl] = cand_lines[kl_ln_local[okl]]
            if not self.only_tracking and ml and n1 >= 20:
                # "visible" gated on the midpoint being in the frustum
                seen = np.unique(kl_ln_id[kl_ln_id >= 0])
                st.ln_found[seen] += 1
                mid = 0.5 * (st.ln_Xs[cand_lines] + st.ln_Xe[cand_lines])
                st.ln_visible[cand_lines[self._in_frustum(mid, R2, t2)]] += 1
        kp_pt2 = np.full((fr.kp.xy.shape[0],), -1, np.int64)
        okp = (kp_pt_local >= 0) & (kp_pt_local < m2)
        kp_pt2[okp] = cand2[kp_pt_local[okp]]
        if n1 < 20:
            return self._track_slow(fr, timestamp, fl, ctx["cand"],
                                    ctx["local_pts"], ctx["R_pred"],
                                    ctx["t_pred"])
        return self._track_tail(fr, timestamp, fl, R2, t2, n2, kp_pt2,
                                kl_ln_id, ctx["local_pts"])

    def resolve_batch(self, force: bool = False,
                      dispatch_at: int | None = None) -> int:
        """Deferred resolution: once ``pipeline_depth`` frames (or
        ``dispatch_at``) are queued, or on ``force``, launch every queued
        frame (one stacked upload per group of equal shape signature) and
        finish the launched groups in FIFO order, handing each result to
        ``on_resolved``. With ``overlap_fetch`` each group's read-back is
        waited on by the helper thread, and unless forced the newest group
        stays in flight while its fetch is not done. Returns the number of
        frames resolved."""
        depth = (self.pipeline_depth if dispatch_at is None
                 else max(1, dispatch_at))
        if self._pending and (force or len(self._pending) >= depth):
            pending, self._pending = self._pending, []
            i = 0
            while i < len(pending):
                j = i + 1
                key = self._group_key(pending[i])
                while (j < len(pending)
                       and self._group_key(pending[j]) == key):
                    j += 1
                group = pending[i:j]
                deferred = [c for c in group if c["out"] is None]
                if deferred:
                    self._launch_group(deferred)
                outs = tuple(c["out"] for c in group)
                fut = None
                if self.overlap_fetch:
                    if self._fetch_pool is None:
                        self._fetch_pool = HelperFetch(self.device, 1,
                                                       "plvs-fetch")
                    fut = self._fetch_pool(outs)
                self._inflight.append((group, fut, outs))
                i = j
        done = 0
        while self._inflight:
            if (not force and self.overlap_fetch
                    and len(self._inflight) <= 1
                    and not self._inflight[0][1].done()):
                break
            group, fut, outs = self._inflight.pop(0)
            t0 = time.perf_counter()
            bufs = fut.result() if fut is not None else fetch_to_host(outs)
            t1 = time.perf_counter()
            for c, buf in zip(group, bufs):
                res = self._finish_fused(buf, c)
                if self.on_resolved is not None:
                    self.on_resolved(res, c["timestamp"], c["seq"])
                done += 1
            if self.timing is not None:
                self.timing.append((t1 - t0, time.perf_counter() - t1,
                                    len(group)))
        return done

    def _track(self, fr: frame_mod.Frame, timestamp: float,
               fl=None) -> TrackResult:
        use_pl = self.use_lines and fl is not None
        asm = self._assemble_fused(use_pl)
        if asm is None:
            # the slow path needs a fully resolved tracker state
            self.resolve_batch(force=True)
            R_pred = self.vel_R @ self.R
            t_pred = self.vel_R @ self.t + self.vel_t
            last_ids = self.last_kp_pt_id
            cand = np.unique(last_ids[last_ids >= 0])
            with self.store.lock:
                return self._track_slow(fr, timestamp, fl, cand,
                                        self._local_points(), R_pred, t_pred)
        ctx = self._ctx_from(asm, fr, fl, timestamp, use_pl)
        ctx["out"] = _track_frame_tables(
            self.cam, self._t(asm["meta"]), asm["pt_tbl"], asm["ln_tbl"], fr,
            fl if use_pl else None, asm["icap"], asm["lcap"], self.scale,
            self.line_track_weight, self.check_rotation, asm["prior"])
        if self.pipelined:
            # queued: the frame resolves with its window; the caller gets
            # the motion model's pose
            self._pending.append(ctx)
            return TrackResult(OK, ctx["R_pred"], ctx["t_pred"], -1, None)
        return self._finish_fused(ctx["out"].cpu().numpy(), ctx)

    def _in_frustum(self, X_w: np.ndarray, R: np.ndarray, t: np.ndarray,
                    margin: float = 0.0) -> np.ndarray:
        """Host-side pinhole frustum test for visibility accounting."""
        Xc = X_w @ R.T + t
        z = Xc[:, 2]
        ok = z > 0.05
        fx, fy, cx, cy = (float(p) for p in self.cam.params[:4])
        zs = np.where(ok, z, 1.0)
        u = fx * Xc[:, 0] / zs + cx
        v = fy * Xc[:, 1] / zs + cy
        return (ok & (u >= -margin) & (u < self.cam.width + margin)
                & (v >= -margin) & (v < self.cam.height + margin))

    def _track_slow(self, fr, timestamp, fl, cand, local_pts,
                    R_pred, t_pred) -> TrackResult:
        """Rare slow path: the motion model failed (or there was nothing to
        match) — host-orchestrated fallback with the reference-KF matcher."""
        use_pl = self.use_lines and fl is not None
        kl_ln_id = None
        R1, t1, n1x, kp_pt1 = self._match_step(
            fr, R_pred, t_pred, cand, radius=30.0)
        if n1x < 20 and self.ref_kf >= 0:
            Rr, tr, nr, kp_ptr = self._track_reference_kf(fr, self.R, self.t)
            if nr > n1x:
                R1, t1, n1x, kp_pt1 = Rr, tr, nr, kp_ptr
        if use_pl:
            R2, t2, n2, kp_pt2, kl_ln_id = self._match_step_pl(
                fr, fl, R1, t1, local_pts, self._local_lines(), radius=4.0)
        else:
            R2, t2, n2, kp_pt2 = self._match_step(fr, R1, t1, local_pts,
                                                  radius=4.0)
        return self._track_tail(fr, timestamp, fl, R2, t2, int(n2), kp_pt2,
                                kl_ln_id, local_pts)

    def _track_tail(self, fr, timestamp, fl, R2, t2, n2, kp_pt2, kl_ln_id,
                    local_pts) -> TrackResult:
        """Common epilogue: lost handling, motion model, visibility
        counters, keyframe decision + creation."""
        st = self.store
        if n2 < 10:
            # a mature map, or an initialized IMU, earns the RECENTLY_LOST
            # grace period
            if (self.imu_coast
                    or st.num_keyframes >= self.min_kf_recently_lost):
                self.state = RECENTLY_LOST
                self._lost_ts = timestamp
            else:
                self.state = LOST
            return TrackResult(self.state, self.R, self.t, int(n2), kp_pt2)

        R_last, t_last = self.R, self.t
        self.R, self.t = R2, t2
        Rl_inv, tl_inv = R_last.T, -R_last.T @ t_last
        self.vel_R = (R2 @ Rl_inv).astype(np.float32)
        self.vel_t = (R2 @ tl_inv + t2).astype(np.float32)
        self._vel_warm = 0 if n2 < 50 else self._vel_warm + 1

        if not self.only_tracking:
            seen = np.unique(kp_pt2[kp_pt2 >= 0])
            st.pt_found[seen] += 1
            vis = local_pts[self._in_frustum(st.pt_xyz[local_pts], R2, t2)]
            st.pt_visible[vis] += 1

        self.frames_since_kf += 1
        self.last_kp_pt_id = kp_pt2
        if self.ref_kf_npts < 0:
            self.ref_kf_npts = int(n2)

        need_kf = (n2 < self.kf_ratio * max(self.ref_kf_npts, 1)
                   or self.frames_since_kf >= self.max_kf_interval)
        if self.fov_centers_kf and not need_kf:
            c = self._fov_center(to_host(fr.depth), R2, t2)
            if c is not None and self.ref_kf in self._kf_fov_center:
                d = np.linalg.norm(c - self._kf_fov_center[self.ref_kf])
                need_kf = d > self.max_fov_centers_distance
        need_kf = (need_kf and n2 >= self.min_kf_inliers
                   and not self.only_tracking)
        kf_id = -1
        if need_kf:
            kf_id, _ = self._create_keyframe(
                fr, timestamp, kp_pt2, fl, kl_ln_id if self.use_lines else None)
            self.ref_kf = kf_id
            self.ref_kf_npts = -1  # re-baselined on the next tracked frame
            self.frames_since_kf = 0
            self.last_kp_pt_id = np.asarray(st.kf_kp_pt[kf_id]).copy()
        self.state = OK
        return TrackResult(self.state, self.R, self.t, int(n2), kp_pt2,
                           need_kf, kf_id, kl_ln_id)

    # ------------------------------------------------------------------
    def _track_reference_kf(self, fr, R_init, t_init):
        """Descriptor-NN match against the reference KF's landmarks, then a
        pose-only optimization."""
        st = self.store
        kf = self.ref_kf
        kf_pt = st.kf_kp_pt[kf]
        m2 = self._t(st.kf_kp_mask[kf] & (kf_pt >= 0)
                     & st.pt_mask[np.maximum(kf_pt, 0)])
        idx, _ = matching.match_nn_ratio(
            fr.kp.desc, self._t(st.kf_kp_desc[kf].view(np.int32)),
            fr.kp.mask, m2, max_dist=64, ratio=0.8)
        idx = idx.cpu().numpy()
        n_kp = fr.kp.xy.shape[0]
        kp_pt_id = np.full((n_kp,), -1, np.int64)
        ok = idx >= 0
        kp_pt_id[ok] = kf_pt[idx[ok]]
        if ok.sum() < 10:
            return np.asarray(R_init), np.asarray(t_init), 0, kp_pt_id
        Xw = np.zeros((n_kp, 3), np.float32)
        Xw[ok] = st.pt_xyz[kp_pt_id[ok]]
        obs = pose_opt.make_pose_obs(self._t(Xw), fr.uvr, fr.inv_sigma2,
                                     self._t(ok) & fr.kp.mask)
        R, t, inl, _, n_inl = pose_opt.pose_optimize(
            self.cam, self._t(np.asarray(R_init, np.float32)),
            self._t(np.asarray(t_init, np.float32)), obs)
        kp_pt_id[~inl.cpu().numpy()] = -1
        return R.cpu().numpy(), t.cpu().numpy(), int(n_inl), kp_pt_id

    @staticmethod
    def _fov_center(depth: np.ndarray, R, t) -> np.ndarray | None:
        """World point at the median keypoint depth on the optical axis."""
        d = depth[depth > 0]
        if len(d) < 10:
            return None
        z = float(np.median(d))
        Rwc = np.asarray(R).T
        twc = -Rwc @ np.asarray(t)
        return (twc + Rwc @ np.array([0.0, 0.0, z], np.float32)).astype(
            np.float32)

    # ------------------------------------------------------------------
    def _gather_point_block(self, cand_ids: np.ndarray, cap: int) -> PointBlock:
        """The candidates' SoA columns padded to ``cap`` rows, uploaded."""
        st = self.store
        m = len(cand_ids)
        with st.lock:
            cols = [(st.pt_xyz, (cap, 3), np.float32),
                    (st.pt_desc.view(np.int32), (cap, 8), np.int32),
                    (None, (cap,), np.int32),
                    (st.pt_mask, (cap,), bool),
                    (st.pt_normal, (cap, 3), np.float32),
                    (st.pt_min_dist, (cap,), np.float32),
                    (st.pt_max_dist, (cap,), np.float32),
                    (st.pt_angle, (cap,), np.float32)]
            out = []
            for src, shape, dt in cols:
                a = np.zeros(shape, dt)
                if src is not None:
                    a[:m] = src[cand_ids]
                out.append(self._t(a))
        return PointBlock(*out)

    def _device_tables(self):
        """Device-resident landmark tables (points + lines), re-uploaded
        only when the store's landmark version moved or a capacity bucket
        grew."""
        st = self.store
        key = (st.version,
               self._cap_bucket(max(st._n_pt, 1), st.max_pts,
                                lo=8192 if self.fixed_shapes else 1024),
               self._cap_bucket(max(st._n_ln, 1), st.max_lines,
                                lo=1024 if self.fixed_shapes else 256))
        if self._tbl_cache is not None and self._tbl_cache[0] == key:
            return self._tbl_cache[1], self._tbl_cache[2]
        P, L = key[1], key[2]
        with st.lock:
            pt_tbl = tuple(self._snapshot(a[:P]) for a in (
                st.pt_xyz, st.pt_desc.view(np.int32), st.pt_normal,
                st.pt_min_dist, st.pt_max_dist, st.pt_angle, st.pt_mask))
            ln_tbl = tuple(self._snapshot(a[:L]) for a in (
                st.ln_Xs, st.ln_Xe, st.ln_desc.view(np.int32), st.ln_mask))
        self._tbl_cache = (key, pt_tbl, ln_tbl)
        return pt_tbl, ln_tbl

    def _gather_line_block(self, cand_lines: np.ndarray):
        """Candidate line landmarks padded to the line capacity. Returns
        (LineBlock, kept ids, count)."""
        st = self.store
        lcap = self.local_lines_cap
        ml = min(len(cand_lines), lcap)
        cand_lines = cand_lines[:ml]
        Xs = np.zeros((lcap, 3), np.float32)
        Xe = np.zeros((lcap, 3), np.float32)
        ldesc = np.zeros((lcap, 8), np.int32)
        lvalid = np.zeros((lcap,), bool)
        if ml:
            with st.lock:
                Xs[:ml] = st.ln_Xs[cand_lines]
                Xe[:ml] = st.ln_Xe[cand_lines]
                ldesc[:ml] = st.ln_desc.view(np.int32)[cand_lines]
                lvalid[:ml] = st.ln_mask[cand_lines]
        return (LineBlock(self._t(Xs), self._t(Xe), self._t(ldesc),
                          self._t(lvalid)), cand_lines, ml)

    @staticmethod
    def _cap_bucket(m: int, cap: int, lo: int = 512) -> int:
        """Smallest power-of-two bucket >= m (bounded by cap)."""
        b = lo
        while b < m and b < cap:
            b *= 2
        return min(b, cap)

    def _match_step(self, fr, R_pred, t_pred, cand_ids: np.ndarray,
                    radius: float):
        m = len(cand_ids)
        if m == 0:
            return (np.asarray(R_pred), np.asarray(t_pred), 0,
                    np.full((fr.kp.xy.shape[0],), -1, np.int64))
        if m > self.local_pts_cap:
            cand_ids = cand_ids[: self.local_pts_cap]
            m = self.local_pts_cap
        blk = self._gather_point_block(cand_ids,
                                       self._cap_bucket(m, self.local_pts_cap))
        R, t, _, n_inl, kp_inl, kp_pt_local = _match_and_optimize(
            self.cam, self._t(np.asarray(R_pred, np.float32)),
            self._t(np.asarray(t_pred, np.float32)), blk, fr, radius,
            self.scale, self.check_rotation)
        kp_inl = kp_inl.cpu().numpy()
        kp_pt_local = kp_pt_local.cpu().numpy()
        kp_pt_id = np.full((fr.kp.xy.shape[0],), -1, np.int64)
        ok = (kp_pt_local >= 0) & (kp_pt_local < m) & kp_inl
        kp_pt_id[ok] = cand_ids[kp_pt_local[ok]]
        return R.cpu().numpy(), t.cpu().numpy(), int(n_inl), kp_pt_id

    def _match_step_pl(self, fr, fl, R_pred, t_pred, cand_ids: np.ndarray,
                       cand_lines: np.ndarray, radius: float):
        """Joint point+line local-map step (one pose optimization)."""
        st = self.store
        m = min(len(cand_ids), self.local_pts_cap)
        if m == 0:
            return (np.asarray(R_pred), np.asarray(t_pred), 0,
                    np.full((fr.kp.xy.shape[0],), -1, np.int64),
                    np.full((fl.kl.sp.shape[0],), -1, np.int64))
        cand_ids = cand_ids[:m]
        blk = self._gather_point_block(cand_ids,
                                       self._cap_bucket(m, self.local_pts_cap))
        lblk, cand_lines, ml = self._gather_line_block(cand_lines)
        R, t, n_inl, kp_pt_local, kl_ln_local = _match_and_optimize_pl(
            self.cam, self._t(np.asarray(R_pred, np.float32)),
            self._t(np.asarray(t_pred, np.float32)), blk, lblk, fr, fl,
            radius, self.scale, line_weight=self.line_track_weight,
            check_rotation=self.check_rotation)
        kp_pt_local = kp_pt_local.cpu().numpy()
        kl_ln_local = kl_ln_local.cpu().numpy()
        kp_pt_id = np.full((fr.kp.xy.shape[0],), -1, np.int64)
        ok = (kp_pt_local >= 0) & (kp_pt_local < m)
        kp_pt_id[ok] = cand_ids[kp_pt_local[ok]]
        kl_ln_id = np.full((fl.kl.sp.shape[0],), -1, np.int64)
        okl = (kl_ln_local >= 0) & (kl_ln_local < ml)
        kl_ln_id[okl] = cand_lines[kl_ln_local[okl]]
        if not self.only_tracking and ml:
            seen = np.unique(kl_ln_id[kl_ln_id >= 0])
            st.ln_found[seen] += 1
            st.ln_visible[cand_lines] += 1
        return R.cpu().numpy(), t.cpu().numpy(), int(n_inl), kp_pt_id, kl_ln_id

    # ------------------------------------------------------------------
    def _local_window(self, max_k1: int = 10, max_k2: int = 3) -> np.ndarray:
        """Two-hop covisible keyframe neighbourhood of the reference KF."""
        st = self.store
        if self.ref_kf < 0:
            return np.zeros((0,), np.int64)
        covis, _ = st.covisibility(self.ref_kf, min_weight=5)
        k1 = covis[:max_k1]
        window = [np.asarray([self.ref_kf]), k1]
        for nb in k1[:5]:
            covis2, _ = st.covisibility(int(nb), min_weight=5)
            window.append(covis2[:max_k2])
        return np.unique(np.concatenate(window))

    def _local_points(self) -> np.ndarray:
        st = self.store
        window = self._local_window()
        if len(window) == 0:
            return np.zeros((0,), np.int64)
        pts = st.points_in_kfs(window)
        return pts[st.pt_mask[pts]]

    def _local_lines(self) -> np.ndarray:
        st = self.store
        window = self._local_window()
        if len(window) == 0:
            return np.zeros((0,), np.int64)
        cand = st.lines_in_kfs(window)
        return cand[st.ln_mask[cand]]

    # ------------------------------------------------------------------
    def _create_keyframe(self, fr, timestamp: float, kp_pt_id: np.ndarray,
                         fl=None, kl_ln_id=None):
        """Snapshot the frame as a keyframe; create map points (and line
        landmarks) from depth for unmatched features."""
        with self.store.lock:
            return self._create_keyframe_locked(fr, timestamp, kp_pt_id, fl,
                                                kl_ln_id)

    def _create_keyframe_locked(self, fr, timestamp: float,
                                kp_pt_id: np.ndarray, fl=None, kl_ln_id=None):
        st = self.store
        kf = st.alloc_kf()
        fr = to_host(fr)
        fl = None if fl is None else to_host(fl)
        st.kf_R[kf] = self.R
        st.kf_t[kf] = self.t
        c = self._fov_center(fr.depth, self.R, self.t)
        if c is not None:
            self._kf_fov_center[kf] = c
        st.kf_mask[kf] = True
        st.kf_timestamp[kf] = timestamp
        st.kf_frame_id[kf] = self.frame_id
        st.kf_kp_xy[kf] = fr.kp.xy
        st.kf_kp_uvr[kf] = fr.uvr
        st.kf_kp_desc[kf] = fr.kp.desc
        st.kf_kp_octave[kf] = fr.kp.octave
        st.kf_kp_angle[kf] = fr.kp.angle
        st.kf_kp_mask[kf] = fr.kp.mask
        st.kf_kp_pt[kf] = -1

        exist = np.nonzero(kp_pt_id >= 0)[0]
        if len(exist):
            st.add_observations(kf, kp_pt_id[exist], exist)

        # new map points from valid-depth unmatched keypoints: all close
        # points, topped up with the closest far ones to >= 100
        depth = fr.depth
        valid = (kp_pt_id < 0) & fr.kp.mask & (depth > 0)
        close = valid & (depth < self.max_depth)
        new_sel = np.nonzero(close)[0]
        if len(new_sel) < 100:
            far = np.nonzero(valid & ~close)[0]
            far = far[np.argsort(depth[far])][: 100 - len(new_sel)]
            new_sel = np.concatenate([new_sel, far])
        pt_ids = np.zeros((0,), np.int64)
        if len(new_sel):
            Rwc = self.R.T
            twc = -Rwc @ self.t
            xyz_w = fr.xyz_cam[new_sel] @ Rwc.T + twc
            pt_ids = st.alloc_pts(len(new_sel))
            st.version += 1
            st.pt_xyz[pt_ids] = xyz_w
            st.pt_desc[pt_ids] = fr.kp.desc[new_sel]
            st.pt_mask[pt_ids] = True
            st.pt_ref_kf[pt_ids] = kf
            st.pt_first_kf[pt_ids] = kf
            st.pt_n_obs[pt_ids] = 0
            st.pt_visible[pt_ids] = 1
            st.pt_found[pt_ids] = 1
            dirs = xyz_w - twc
            dist = np.linalg.norm(dirs, axis=-1)
            st.pt_normal[pt_ids] = dirs / (dist[:, None] + 1e-9)
            octv = fr.kp.octave[new_sel]
            max_d = dist * (self.scale ** octv)
            st.pt_max_dist[pt_ids] = max_d
            st.pt_min_dist[pt_ids] = max_d / (self.scale ** (self.n_levels - 1))
            st.pt_angle[pt_ids] = fr.kp.angle[new_sel]
            st.add_observations(kf, pt_ids, new_sel)

        # lines: snapshot keylines; line landmarks from endpoint depths
        if fl is not None and self.use_lines:
            n_fl = min(st.n_kl, int(fl.kl.sp.shape[0]))
            st.kf_kl_sp[kf, :n_fl] = fl.kl.sp[:n_fl]
            st.kf_kl_ep[kf, :n_fl] = fl.kl.ep[:n_fl]
            st.kf_kl_desc[kf, :n_fl] = fl.kl.desc[:n_fl]
            st.kf_kl_mask[kf, :n_fl] = fl.kl.mask[:n_fl]
            st.kf_kl_depth[kf, :n_fl, 0] = fl.depth_s[:n_fl]
            st.kf_kl_depth[kf, :n_fl, 1] = fl.depth_e[:n_fl]
            st.kf_kl_line[kf] = -1
            if kl_ln_id is None:
                kl_ln_id = np.full((int(fl.kl.sp.shape[0]),), -1, np.int64)
            exist_l = np.nonzero(kl_ln_id[:n_fl] >= 0)[0]
            if len(exist_l):
                st.add_line_observations(kf, kl_ln_id[exist_l], exist_l)
            ds = fl.depth_s[:n_fl]
            de = fl.depth_e[:n_fl]
            new_l = np.nonzero(
                (kl_ln_id[:n_fl] < 0) & fl.kl.mask[:n_fl]
                & (ds > 0) & (ds < self.line_max_depth)
                & (de > 0) & (de < self.line_max_depth)
                & (np.abs(ds - de) < 0.5 * np.maximum(ds, de)))[0]
            if len(new_l):
                Rwc = self.R.T
                twc = -Rwc @ self.t
                ln_ids = st.alloc_lines(len(new_l))
                st.version += 1
                st.ln_Xs[ln_ids] = fl.Xs_cam[new_l] @ Rwc.T + twc
                st.ln_Xe[ln_ids] = fl.Xe_cam[new_l] @ Rwc.T + twc
                st.ln_desc[ln_ids] = fl.kl.desc[new_l]
                st.ln_mask[ln_ids] = True
                st.ln_ref_kf[ln_ids] = kf
                st.ln_first_kf[ln_ids] = kf
                st.ln_n_obs[ln_ids] = 0
                st.ln_visible[ln_ids] = 1
                st.ln_found[ln_ids] = 1
                st.add_line_observations(kf, ln_ids, new_l)
        return kf, pt_ids
