"""System facade for RGB-D, stereo and monocular SLAM with points and
lines, loop closing, relocalization, dense TSDF mapping (with
``dense_segmentation`` the incremental 3D segmentation), planar map objects
and, with ``use_imu``, the inertial path. A stereo pair is rectified
(row-aligned), or a calibrated non-rectified rig (``cam2`` / ``T_c1_c2``,
e.g. a KB8 fisheye pair) matched across its epipolar geometry, or — with
``rectify`` — warped to a common rectified pinhole pair first. With
``image_scale`` != 1 every input image is resized to the working
resolution first (gray linear, depth nearest, as the JAX package does) and
the camera scaled with it.

Counterpart of plvs_tpu/slam/system.py: ``SystemConfig`` keeps every field
and default of the JAX package. With ``sharded_backend`` on a machine with
more than one visible CUDA device the global BA and the essential-graph
solve run sharded over a mesh of all of them (``parallel/``); with one
device, as with one TPU in the JAX package, ``System.mesh`` stays None. Depth
maps grow from depth at every keyframe; a monocular map starts from two
views and grows by triangulation in the local mapper. The keyframe
database (place recognition) is always built: relocalization needs it.

The per-keyframe backend is ``_backend_stages``, a generator: with
``local_ba`` the local mapper (culling, line triangulation, fuse, landmark
maintenance, the windowed local BA, keyframe culling), then with
``dense_mapping`` the dense stage (depth — from stereo through kernel K3 on
the stereo path —, filter, TSDF integration and the incremental mesh) at
the keyframe's adjusted pose, then with ``loop_closing`` the loop closer
(else the keyframe is only indexed). A closed loop is followed by the
global BA (``global_ba_on_loop`` with ``local_ba``: dispatched, yielded,
applied) and the dense map's rebuild at the corrected poses. It runs one of
three ways, as in the JAX package:

* synchronously, drained after each keyframe (``pipelined=False``, or
  ``interleaved_backend=False``); the tracker then continues from the
  keyframe's stored pose;
* interleaved (``pipelined`` with ``interleaved_backend``): a FIFO of
  keyframe generators whose head advances one stage at a time between
  frames, its fetches waited on by two helper threads; a stage resumes when
  its fetch is done or after ``BACKEND_STAGE_DEADLINE`` polls, the backlog
  is held to ``MAX_BACKEND_BACKLOG`` by forced steps, and a loop correction
  is folded into the tracker's pose when its keyframe finishes;
* on the mapper actor's thread (``async_mapping``,
  ``slam/async_runtime.py``).

With ``use_imu`` the inertial runtime (``slam/inertial.py``) runs around
every frame, as in the JAX package: before the frame the samples are
queued, the gap since the last frame is preintegrated and the motion model
replaced by the IMU prediction (with the per-frame pose prior once the IMU
is initialized, a gyro-only rotation before); after a tracked frame the
velocity estimate is refreshed; after a keyframe (synchronously, after its
backend, or when it is queued on the actor) the keyframe gap is recorded,
the staged initialization runs, and once initialized the VI local BA,
coasting through RECENTLY_LOST and the 4-DoF loop correction are on. The
pipeline is at most 2 deep under the IMU, the interleaved backend is off,
and the frame clock never moves backwards (a late resolve must not make
the next gap re-consume samples).

With ``pipelined`` the tracker resolves frames late (``slam/tracking.py``):
``track_rgbd`` / ``track_stereo`` return the motion model's pose, the
trajectory records the resolved poses, and ``_finish_frame`` bounds the
window by the observed rotation rate. ``flush()`` settles everything;
the trajectory exports, ``time_stats`` and ``shutdown`` call it. All
device work goes to the device's default stream, shared by every thread.

A session ends with ``shutdown``, which can save the atlas and the dense
volume (``io/serialization.py``, files either package reads); ``load_map``
reuses a saved atlas, its keyframes frozen, tracking from
``RELOCALIZE_IN_LOADED_MAP``; ``reset`` rebuilds the System from its
constructor's arguments, keeping the trajectory log.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..dense.mapping import DenseMapper
from ..dense.meshing import IncrementalMesher
from ..features import pyramid
from ..geometry import cameras as cam_mod
from ..geometry import lie
from ..geometry.rectify import StereoRectifier
from ..io import serialization
from ..io import trajectory as traj_io
from ..ops import resolve_device
from ..utils.fetch import HelperFetch, SyncFetch, to_host
from ..utils.profiling import Stopwatch
from ..vocab import bow
from . import frame as frame_mod
from . import tracking
from .inertial import InertialRuntime
from .keyframe_database import KeyFrameDatabase
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
from .map_objects import ObjectStore, ObjectTemplate
from .map_store import MapStore
from .tracking import OK, Tracker


def _quantize(gray: np.ndarray, depth: np.ndarray, dec: int = 1):
    """Sensor-precision quantization of one frame: u8 gray and u16
    millimetre depth decimated by ``dec`` (the JAX package's upload
    format; its values feed every later stage)."""
    g8 = np.ascontiguousarray(np.asarray(gray))
    if g8.dtype != np.uint8:
        g8 = np.clip(g8, 0, 255).astype(np.uint8)
    d = np.asarray(depth, np.float32)[::dec, ::dec]
    d16 = (np.clip(d, 0.0, 65.0) * 1000.0).astype(np.uint16)
    return g8, np.ascontiguousarray(d16)


def _root_span(name: str, per_frame: bool = False):
    """Time a public call of the System as the root scope ``name``; a
    tracking call's carries its frame's sequence number (``frame``, the
    tracker's counter, which every scope of the frame carries up to its
    resolution). The scope stays on the stopwatch installed when the call
    began (``reset`` installs a new one)."""
    def deco(fn):
        @functools.wraps(fn)
        def call(self, *args, **kwargs):
            attrs = {"frame": self.tracker.frame_id} if per_frame else {}
            with self.stopwatch.scope(name, **attrs):
                return fn(self, *args, **kwargs)
        return call
    return deco


def _pack_rgbd(gray: np.ndarray, depth: np.ndarray, dec: int = 1):
    """Quantized planes for the fast path (depth decimated by ``dec``), or
    None on geometry the JAX package's plane packing does not take."""
    h, w = np.shape(gray)
    if h % 4 or h % dec or w % dec or (h // dec) % 2:
        return None
    return _quantize(gray, depth, dec)


@dataclasses.dataclass
class SystemConfig:
    num_features: int = 1024
    n_levels: int = 8
    scale: float = 1.2
    max_kf: int = 512
    max_pts: int = 65536
    local_ba: bool = True
    loop_closing: bool = True
    dense_mapping: bool = False
    dense_voxel_size: float = 0.02
    dense_segmentation: bool = False
    dense_mesh_every: int = 1
    use_lines: bool = False
    max_lines: int = 128
    sensor: str = "rgbd"  # "rgbd" | "stereo" | "mono"
    use_imu: bool = False
    min_kf_inliers: int = 30
    kf_ratio: float = 0.75
    max_kf_interval: int = 10
    new_map_after_lost: int = 150
    vocabulary_path: Optional[str] = None
    image_scale: float = 1.0
    only_tracking: bool = False
    fov_centers_kf: bool = False
    max_fov_centers_distance: float = 0.4
    global_ba_on_loop: bool = True
    async_mapping: bool = False
    pipelined: bool = False
    pipeline_depth: int = 1
    pipeline_overlap: bool = True
    interleaved_backend: bool = True
    sharded_backend: bool = False
    backend_fixed_shapes: bool = False
    depth_upload_decimation: int = 2
    rectify: bool = False


class System:
    """RGB-D / stereo / monocular SLAM on one device (optional keyframe
    backend, loop closing, dense mapping, map objects, deferred resolution
    and the interleaved or threaded backend)."""

    # interleaved backend: queued keyframe generators beyond this force
    # catch-up steps (see _enqueue_backend)
    MAX_BACKEND_BACKLOG = 2
    # a stage whose fetch is still pending after this many _step_backend
    # polls (2 per frame) is resumed anyway, blocking on the fetch: stage
    # advancement is gated on the frame count, not on wall time
    BACKEND_STAGE_DEADLINE = 10

    def __init__(self, cam: cam_mod.Camera, config: SystemConfig | None = None,
                 device: str | torch.device = "cuda", cam2=None, T_c1_c2=None,
                 imu_calib=None, imu_T_b_c=None):
        """``cam2`` / ``T_c1_c2`` declare a non-rectified stereo rig:
        T_c1_c2 is the 4x4 right-to-left transform X_c1 = T X_c2. With
        ``config.rectify`` the pair is warped to a common rectified pinhole
        instead (``self.cam`` becomes it).

        ``imu_calib`` (``imu.preintegration.ImuCalib`` noise densities)
        and ``imu_T_b_c`` (4x4 camera-in-body extrinsic, X_b = T X_c)
        configure the inertial runtime when ``config.use_imu`` is set."""
        # the constructor's arguments, so reset() rebuilds the same system
        # (rig, IMU calibration and device included)
        self._ctor_args = dict(cam=cam, config=config, device=device,
                               cam2=cam2, T_c1_c2=T_c1_c2,
                               imu_calib=imu_calib, imu_T_b_c=imu_T_b_c)
        self.config = c = config or SystemConfig()
        if c.sensor not in ("rgbd", "stereo", "mono"):
            raise ValueError(f"unknown sensor {c.sensor!r}")
        self.device = resolve_device(device)
        if c.image_scale != 1.0:
            cam = cam_mod.scale_camera(cam, c.image_scale)
            if cam2 is not None:
                cam2 = cam_mod.scale_camera(cam2, c.image_scale)
        self.rectifier = None
        if c.rectify and cam2 is not None and T_c1_c2 is not None:
            self.rectifier = StereoRectifier(
                cam, cam2, np.asarray(T_c1_c2, np.float32),
                device=self.device)
            cam = self.rectifier.cam       # common row-aligned pinhole
            cam2 = T_c1_c2 = None          # downstream sees rectified stereo
        self.cam = cam
        self.cam2 = cam2
        self.R_lr = self.t_lr = None
        if T_c1_c2 is not None:
            T = np.asarray(T_c1_c2, np.float32)
            self.R_lr = T[:3, :3].copy()
            self.t_lr = T[:3, 3].copy()
            self._rig_d = (torch.from_numpy(self.R_lr).to(self.device),
                           torch.from_numpy(self.t_lr).to(self.device))
        self.store = MapStore(max_kf=c.max_kf, max_pts=c.max_pts,
                              n_kp=c.num_features)
        self.kfdb = KeyFrameDatabase(self.store, device=self.device)
        if c.vocabulary_path:
            # .txt / .bin (DBoW2), .npz (a regular or a general tree)
            self.kfdb.voc = bow.load_vocabulary(c.vocabulary_path)
        self.tracker = Tracker(
            cam, self.store, num_features=c.num_features,
            min_kf_inliers=c.min_kf_inliers, kf_ratio=c.kf_ratio,
            max_kf_interval=c.max_kf_interval, use_lines=c.use_lines,
            sensor=c.sensor, fov_centers_kf=c.fov_centers_kf,
            max_fov_centers_distance=c.max_fov_centers_distance,
            # a non-rectified rig triangulates fewer (verified) matches
            min_init_pts=(max(80, int(round(120 * c.image_scale ** 2)))
                          if cam2 is not None
                          else max(100, int(round(300 * c.image_scale ** 2)))),
            kfdb=self.kfdb, new_map_after_lost=c.new_map_after_lost,
            device=self.device)
        tr = self.tracker
        tr.only_tracking = c.only_tracking
        tr.scale = c.scale
        tr.n_levels = c.n_levels
        tr.max_keylines = c.max_lines
        tr.depth_decimation = c.depth_upload_decimation
        tr.fixed_shapes = c.backend_fixed_shapes
        tr.pipelined = c.pipelined
        # shallow under the IMU: the per-frame prediction starts from the
        # last resolved pose
        tr.pipeline_depth = max(1, min(c.pipeline_depth, 2) if c.use_imu
                                else c.pipeline_depth)
        tr.overlap_fetch = c.pipeline_overlap
        tr.on_resolved = self._on_resolved
        # dense payloads of queued frames, by the tracker's frame counter
        self._pending_payloads = {}
        if self.cam2 is not None and self.t_lr is not None:
            # a rig camera has no rectified bf: the close/far depth gate is
            # 40 baselines
            tr.max_depth = 40.0 * float(np.linalg.norm(self.t_lr))
        self.local_mapper = LocalMapper(
            cam, self.store, scale=c.scale, n_levels=c.n_levels,
            use_lines=c.use_lines, kfdb=self.kfdb,
            triangulate_new_points=(c.sensor == "mono"),
            fixed_shapes=c.backend_fixed_shapes, device=self.device)
        # the loop closer keeps fix_scale=True on a monocular map too, as
        # the JAX package's System constructs it
        self.loop_closer = (LoopCloser(self.store, kfdb=self.kfdb, cam=cam,
                                       device=self.device)
                            if c.loop_closing else None)
        # the sharded backend's mesh over every visible card; none on one
        # card (or on the CPU), where the solves run unsharded
        self.mesh = None
        if (c.sharded_backend and self.device.type == "cuda"
                and torch.cuda.device_count() > 1):
            from ..parallel import sharded_ba

            self.mesh = sharded_ba.make_mesh(torch.cuda.device_count())
            self.local_mapper.mesh = self.mesh
            if self.loop_closer is not None:
                self.loop_closer.mesh = self.mesh
        self.loops_closed = []  # (kf_id, info) per closed loop
        self.dense_mapper = None
        if c.dense_mapping:
            self.dense_mapper = DenseMapper(
                cam, voxel_size=c.dense_voxel_size,
                use_segmentation=c.dense_segmentation,
                mesh_every=c.dense_mesh_every,
                fixed_shapes=c.backend_fixed_shapes, device=self.device)
        # interleaved backend: the FIFO of staged keyframe generators and
        # the helper threads that wait on the stages' fetches
        self._backend_q = collections.deque()
        self._backend_pool = None
        # per-stage timing (host clock; no synchronisation unless the
        # caller installs a stopwatch with a sync device)
        self.set_stopwatch(Stopwatch())
        self.trajectory = []  # (timestamp, R, t) world-to-camera
        # (timestamp, ref_kf_uid, R_rel, t_rel): T_frame_w = T_rel * T_ref_w,
        # so the export follows any later change of the keyframe poses
        self._traj_rel = []
        self._last_frame_ts = None
        self._last_kf_ts = None
        self.inertial = None
        if c.use_imu:
            kwargs = {}
            if imu_calib is not None:
                kwargs["calib"] = imu_calib
            if imu_T_b_c is not None:
                T = np.asarray(imu_T_b_c, np.float32)
                R_bc, t_bc = T[:3, :3], T[:3, 3]
                kwargs["R_cb"] = np.ascontiguousarray(R_bc.T)
                kwargs["t_cb"] = (-R_bc.T @ t_bc).astype(np.float32)
            # a monocular map is born up to scale: the inertial
            # initialization estimates the metric scale and rescales it
            self.inertial = InertialRuntime(fix_scale=c.sensor != "mono",
                                            device=self.device, **kwargs)
            # keyframe culling goes through the inertial re-chaining gate
            self.local_mapper.inertial = self.inertial
        # planar map objects (add_map_object): detected at each keyframe,
        # refined in the backend, moved by loop corrections
        self.object_store = None
        self.actor = None
        if c.async_mapping:
            from .async_runtime import MapperActor

            self.actor = MapperActor(self)

    def set_stopwatch(self, stopwatch: Stopwatch):
        """Time the system's stages, the tracker's, the local mapper's and
        the dense mapper's through ``stopwatch``."""
        self.stopwatch = stopwatch
        self.tracker.stopwatch = stopwatch
        self.local_mapper.stopwatch = stopwatch
        if self.loop_closer is not None:
            self.loop_closer.stopwatch = stopwatch
        if self.dense_mapper is not None:
            self.dense_mapper.stopwatch = stopwatch

    def time_stats(self) -> dict:
        """Per-stage timing statistics (mean / std / median / total ms and
        count per stage over the run), after a flush."""
        self.flush()
        return self.stopwatch.stats()

    def print_time_stats(self) -> str:
        """Print and return the per-stage timing table."""
        self.flush()
        report = self.stopwatch.report()
        print(report)
        return report

    # -- mode and lifecycle -----------------------------------------------
    def activate_localization_mode(self):
        """Track against the map without changing it."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.tracker.only_tracking = False

    @_root_span("system.reset")
    def reset(self):
        """Drop every map and restart, rebuilt from the constructor's
        arguments (the rig, the IMU calibration and the device survive).
        The trajectory log survives too, its poses frozen at their
        retro-corrected values. Queued frames and backend stages are
        settled and the mapper actor and helper threads stopped first."""
        self._freeze_traj_rel()  # the old store's uids die with it
        self._stop_threads()
        traj, traj_rel = self.trajectory, self._traj_rel
        self.__init__(**self._ctor_args)
        self.trajectory = traj
        self._traj_rel = traj_rel

    def reset_active_map(self):
        """Clear only the active map's keyframes and points; the atlas's
        other maps survive."""
        self.flush()
        st = self.store
        with st.lock:
            for k in st.kfs_of_map(st.active_map):
                st.remove_keyframe(int(k))
            pts = st.points_of_map(st.active_map)
            st.remove_points(pts[st.pt_mask[pts]])
        self.tracker.reset_state()

    # -- image scaling ----------------------------------------------------
    def _gray_to_device(self, img: np.ndarray) -> torch.Tensor:
        """A gray image on the device as float32, resized to the working
        resolution when ``image_scale`` != 1 (JAX's linear antialiased
        resampler, ``pyramid.resize_linear``)."""
        g = torch.from_numpy(np.ascontiguousarray(img, np.float32)).to(
            self.device)
        if self.config.image_scale == 1.0:
            return g
        return pyramid.resize_linear(g, (self.cam.height, self.cam.width))

    def _maybe_scale(self, img: np.ndarray, nearest: bool = False):
        """A host image resized to the working resolution: gray through
        :meth:`_gray_to_device` (read back), depth with
        ``jax.image.resize``'s "nearest" rule — source index
        floor((i + 0.5) * in / out), evaluated in float32."""
        if self.config.image_scale == 1.0:
            return img
        if not nearest:
            return self._gray_to_device(img).cpu().numpy()
        out = np.asarray(img)
        f32 = np.float32
        for axis, n in ((0, self.cam.height), (1, self.cam.width)):
            m = out.shape[axis]
            if m == n:
                continue
            src = np.floor((np.arange(n, dtype=f32) + f32(0.5)) * f32(m)
                           / f32(n)).astype(np.int64)
            out = np.take(out, src, axis=axis)
        return out

    def _build_frames(self, gray: np.ndarray, depth: np.ndarray):
        """Full-resolution quantized upload + separate frame build (the
        initialization / fallback path)."""
        g8, d16 = _quantize(gray, depth)
        gray_d, depth_d = tracking._decompress_packed(
            torch.from_numpy(g8).to(self.device),
            torch.from_numpy(d16.astype(np.int32)).to(self.device))
        c = self.config
        fr = frame_mod.build_frame_rgbd(gray_d, depth_d, self.cam,
                                        c.num_features, c.n_levels, c.scale)
        fl = (frame_mod.build_frame_lines(gray_d, depth_d, self.cam,
                                          c.max_lines)
              if c.use_lines else None)
        return fr, fl

    @_root_span("system.track_rgbd", per_frame=True)
    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float,
                   imu_samples=None):
        """Track one RGB-D frame (gray [H, W], depth [H, W] metres; with
        ``use_imu``, ``imu_samples`` [(t, gyro[3], acc[3])] up to the
        frame); returns (state, Rcw, tcw)."""
        with self.stopwatch.scope("frame.pack"):
            gray = self._maybe_scale(gray)
            depth = self._maybe_scale(depth, nearest=True)
        self._imu_pre_frame(timestamp, imu_samples)
        if self.actor is not None:
            self.actor.apply_pending_correction()
        self._resolve_pipeline()
        res = None
        if self.tracker.state == OK:
            with self.stopwatch.scope("frame.pack"):
                planes = _pack_rgbd(gray, depth,
                                    self.config.depth_upload_decimation)
            if planes is not None:
                with self.stopwatch.scope("track"):
                    res = self.tracker.process_frame_packed(*planes,
                                                            timestamp)
        if res is None:
            with self.stopwatch.scope("frame_build"):
                fr, fl = self._build_frames(gray, depth)
            with self.stopwatch.scope("track"):
                res = self.tracker.process_frame(fr, timestamp, fl)
        payload = ("rgbd", gray, depth) if self.dense_mapper else None
        return self._finish_frame(res, timestamp, payload)

    @_root_span("system.track_stereo", per_frame=True)
    def track_stereo(self, gray_l: np.ndarray, gray_r: np.ndarray,
                     timestamp: float, imu_samples=None):
        """Track one stereo pair (gray [H, W] each, float32 as given —
        stereo images are not quantized; ``imu_samples`` as for
        ``track_rgbd``: stereo-inertial): rectified, or warped first
        (``rectify``), or matched across the rig's epipolar geometry;
        returns (state, Rcw, tcw)."""
        if self.rectifier is not None:
            gl, gr = self.rectifier(gray_l, gray_r)
        else:
            gl = self._gray_to_device(gray_l)
            gr = self._gray_to_device(gray_r)
        self._imu_pre_frame(timestamp, imu_samples)
        if self.actor is not None:
            self.actor.apply_pending_correction()
        self._resolve_pipeline()
        c = self.config
        sw, seq = self.stopwatch, self.tracker.frame_id
        with sw.scope("frame_build"):
            with sw.scope("frame.stereo_points", frame=seq):
                if self.cam2 is not None and self.R_lr is not None:
                    fr = frame_mod.build_frame_stereo_rig(
                        gl, gr, self.cam, self.cam2, *self._rig_d,
                        c.num_features, c.n_levels, c.scale)
                else:
                    fr = frame_mod.build_frame_stereo(
                        gl, gr, self.cam, c.num_features, c.n_levels,
                        c.scale)
            fl = None
            if c.use_lines:
                with sw.scope("frame.stereo_lines", frame=seq):
                    fl = frame_mod.build_frame_lines_stereo(
                        gl, gr, self.cam, c.max_lines)
        with self.stopwatch.scope("track"):
            res = self.tracker.process_frame(fr, timestamp, fl)
        payload = ("stereo", gl, gr) if self.dense_mapper else None
        return self._finish_frame(res, timestamp, payload)

    @_root_span("system.track_monocular", per_frame=True)
    def track_monocular(self, gray: np.ndarray, timestamp: float,
                        imu_samples=None):
        """Track one monocular frame (gray [H, W]; ``imu_samples`` as for
        ``track_rgbd``: monocular-inertial); returns (state, Rcw, tcw). The
        map and the trajectory are up to scale until an inertial
        initialization resolves it."""
        g = self._gray_to_device(gray)
        self._imu_pre_frame(timestamp, imu_samples)
        if self.actor is not None:
            self.actor.apply_pending_correction()
        self._resolve_pipeline()
        c = self.config
        with self.stopwatch.scope("frame_build"):
            fr = frame_mod.build_frame_mono(g, self.cam, c.num_features,
                                            c.n_levels, c.scale)
        with self.stopwatch.scope("track"):
            res = self.tracker.process_frame(fr, timestamp)
        return self._finish_frame(res, timestamp)

    # -- planar map objects ------------------------------------------------
    def add_map_object(self, gray: np.ndarray, metric_width: float) -> int:
        """Register a planar object from its reference image (spanning
        ``metric_width`` in x): detected at every new keyframe, its Sim3
        pose refined against its observations."""
        if self.object_store is None:
            self.object_store = ObjectStore(self.cam, device=self.device)
            if self.loop_closer is not None:
                self.loop_closer.object_store = self.object_store
        tpl = ObjectTemplate.from_image(
            np.asarray(gray, np.float32), metric_width,
            object_id=len(self.object_store.objects), device=self.device)
        return self.object_store.add_template(tpl)

    def _detect_objects(self, kf_id: int):
        st = self.store
        with self.stopwatch.scope("map_objects.detect"):
            self.object_store.detect_in_frame(
                st.kf_kp_xy[kf_id], st.kf_kp_desc[kf_id],
                st.kf_kp_mask[kf_id], st.kf_R[kf_id], st.kf_t[kf_id],
                kf_id=kf_id)

    # -- the inertial path -------------------------------------------------
    def _imu_pre_frame(self, timestamp: float, imu_samples):
        """Queue the samples and replace the motion model by the IMU
        prediction: the full state once initialized (with the per-frame
        pose prior), the gyro's rotation before."""
        if self.inertial is None:
            return
        iner, tr = self.inertial, self.tracker
        tr.prior_info = None
        if imu_samples is not None:
            iner.add_samples(imu_samples)
        if self._last_frame_ts is None:
            return
        if tr.state not in (OK, tracking.RECENTLY_LOST):
            return
        p = iner.preintegrate_frame_gap(self._last_frame_ts, timestamp)
        if p is None:
            return
        pred = iner.predict_state(tr.R, tr.t, p)
        if pred is not None:
            R_pred, t_pred = pred
            tr.vel_R = (R_pred @ tr.R.T).astype(np.float32)
            tr.vel_t = (t_pred - tr.vel_R @ tr.t).astype(np.float32)
            if iner.per_frame_prior:
                tr.prior_info = iner.pose_prior_info(p)
        else:
            R_pred = iner.predict_rotation(tr.R, p)
            tr.vel_R = (R_pred @ tr.R.T).astype(np.float32)

    def _imu_post_frame(self, state: int, timestamp: float):
        """Refresh the velocity estimate from a tracked frame's pose."""
        if self.inertial is None or state != OK:
            return
        self.inertial.note_frame_pose(self.tracker.R, self.tracker.t,
                                      timestamp)

    def _imu_post_kf(self, kf_id: int, timestamp: float):
        """Record the keyframe gap (and initialize when due); once
        initialized, the VI local BA, coasting and the 4-DoF loop
        correction."""
        if self.inertial is None:
            return
        self.inertial.on_keyframe(kf_id, self._last_kf_ts, timestamp,
                                  self.store)
        self._last_kf_ts = timestamp
        s = self.inertial.consume_scale_correction()
        if s is not None:
            # the monocular-inertial initialization rescaled the map: the
            # tracker state and the recorded trajectories follow
            tr = self.tracker
            tr.t = (tr.t * s).astype(np.float32)
            tr.vel_t = (tr.vel_t * s).astype(np.float32)
            self.trajectory = [(ts, R, (t * s).astype(np.float32))
                               for ts, R, t in self.trajectory]
            self._traj_rel = [(ts, uid, R, (t * s).astype(np.float32))
                              for ts, uid, R, t in self._traj_rel]
        if self.inertial.initialized:
            self.inertial.vi_local_ba(self.cam, self.store, kf_id)
            self.tracker.imu_coast = True
            if self.loop_closer is not None:
                self.loop_closer.gravity_w = self.inertial.gravity

    # -- deferred resolution ----------------------------------------------
    def _on_resolved(self, res, ts: float, seq=None):
        """Tracker callback: a queued frame resolved; run its post-track
        path with the dense payload kept under its frame counter."""
        self._post_track(res, ts, self._pending_payloads.pop(seq, None))

    def _resolve_pipeline(self, force: bool = False):
        """Resolve the queued frames when the window is full (or on
        ``force``, which also settles the interleaved backend)."""
        with self.stopwatch.scope("resolve"):
            self.tracker.resolve_batch(force=force)
        if force:
            self._drain_backend()

    @_root_span("system.flush")
    def flush(self):
        """Finish every queued frame and backend stage (the end of a
        sequence; the trajectory exports and ``shutdown`` call it)."""
        self._resolve_pipeline(force=True)
        self._drain_backend()
        if self.actor is not None:
            self.actor.wait_idle(60.0)

    def _finish_frame(self, res, timestamp: float, dense_payload=None):
        """Route a Track* result: provisional (the frame is queued) or final
        (its post-track path runs now). Two interleaved-backend stages run
        per frame, after the frame's own dispatch."""
        tr = self.tracker
        if tr._pending:
            self._pending_payloads[tr._pending[-1]["seq"]] = dense_payload
            self._last_frame_ts = timestamp
            # the window extrapolates the motion model up to its depth;
            # bound it by the observed rotation rate, and resolve every
            # frame while the motion model is cold
            if tr._vel_warm < 3:
                eff_depth, force = 1, True
            else:
                ang = float(np.arccos(np.clip(
                    (np.trace(tr.vel_R) - 1.0) * 0.5, -1.0, 1.0)))
                if ang > 0.10:
                    eff_depth, force = 1, True
                elif ang > 0.03:
                    # launch every frame, the newest group left in flight
                    eff_depth, force = 1, False
                else:
                    eff_depth, force = tr.pipeline_depth, False
            if len(tr._pending) >= eff_depth:
                with self.stopwatch.scope("resolve"):
                    tr.resolve_batch(force=force, dispatch_at=eff_depth)
            self._step_backend()
            self._step_backend()
            return res.state, res.R, res.t
        out = self._post_track(res, timestamp, dense_payload)
        self._step_backend()
        self._step_backend()
        return out

    def _post_track(self, res, timestamp: float, dense_payload=None):
        """Common tail of every resolved frame: the trajectory entries and,
        on a keyframe, the backend (on the actor, queued on the interleaved
        backend, or inline)."""
        st = self.store
        ref = self.tracker.ref_kf
        with st.lock:
            if 0 <= ref < st.max_kf and st.kf_mask[ref] and st.kf_uid[ref] >= 0:
                R_ref, t_ref = st.kf_R[ref], st.kf_t[ref]
                R_rel = (res.R @ R_ref.T).astype(np.float32)
                t_rel = (res.t - R_rel @ t_ref).astype(np.float32)
                self._traj_rel.append((timestamp, int(st.kf_uid[ref]), R_rel,
                                       t_rel))
            else:
                self._traj_rel.append((timestamp, -1, res.R.copy(),
                                       res.t.copy()))
        if res.is_keyframe and res.kf_id >= 0:
            if self.object_store is not None:
                self._detect_objects(res.kf_id)
            if self.actor is not None:
                self.actor.insert_keyframe(res.kf_id, dense_payload)
                self._imu_post_kf(res.kf_id, timestamp)
            elif self._interleaved:
                self._enqueue_backend(res.kf_id, dense_payload)
                self._imu_post_kf(res.kf_id, timestamp)
            else:
                self._backend_keyframe(res.kf_id, dense_payload)
                self._imu_post_kf(res.kf_id, timestamp)
                # keep the tracker's pose consistent with the adjusted (and
                # VI-refined) keyframe
                self.tracker.R = st.kf_R[res.kf_id].copy()
                self.tracker.t = st.kf_t[res.kf_id].copy()
        self._imu_post_frame(res.state, timestamp)
        # never move the frame clock backwards: resolves trail dispatches
        if self._last_frame_ts is None or timestamp > self._last_frame_ts:
            self._last_frame_ts = timestamp
        self.trajectory.append((timestamp, res.R.copy(), res.t.copy()))
        return res.state, res.R, res.t

    # -- the per-keyframe backend -----------------------------------------
    def _backend_keyframe(self, kf_id: int, dense_payload=None):
        """The backend of one keyframe run to its end with inline fetches
        (the drain of :meth:`_backend_stages`); returns the loop's info or
        None."""
        gen = self._backend_stages(kf_id, dense_payload)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value

    def _backend_stages(self, kf_id: int, dense_payload=None, submit=None):
        """The per-keyframe backend as a generator: the local mapper's
        stages, the dense stage at the keyframe's pose after bundle
        adjustment, then the loop closer (or the keyframe database alone);
        after a closure the global BA (dispatched, yielded, applied) and
        the dense rebuild. Each ``yield`` hands the caller the future the
        next stage waits on. ``submit`` (fn(outs) -> future) takes the
        fetches; None fetches inline. The keyframe's BoW descent is queued
        first and rides the local mapper's first fetch."""
        fetch = submit if submit is not None else SyncFetch()
        st = self.store
        uid = int(st.kf_uid[kf_id])
        words_out = (self.kfdb.dispatch_quantize(st.kf_kp_desc[kf_id])
                     if self.loop_closer is not None else None)
        words = None
        if self.config.local_ba:
            lm_gen = self.local_mapper.process_keyframe_stages(
                kf_id, extra_fetch=words_out, submit=submit)
            while True:
                try:
                    with self.stopwatch.scope("local_mapping", kf=uid):
                        wait = next(lm_gen)
                except StopIteration as stop:
                    words = stop.value
                    break
                yield wait
        elif words_out is not None:
            words = to_host(words_out)
        if self.object_store is not None:
            with self.stopwatch.scope("map_objects"):
                self.object_store.refine(st)
        if self.dense_mapper is not None and dense_payload is not None:
            kind, a, b = dense_payload
            d_gen = self.dense_mapper.insert_stages(
                kind, kf_id, a, b, st.kf_R[kf_id], st.kf_t[kf_id], fetch)
            while True:
                try:
                    with self.stopwatch.scope("dense_mapping", kf=uid):
                        wait = next(d_gen)
                except StopIteration:
                    break
                yield wait
        if self.loop_closer is None:
            self.kfdb.add(kf_id)
            return None
        with self.stopwatch.scope("loop_closing", kf=uid):
            info = self.loop_closer.process_keyframe(kf_id, words=words)
        if info is None:
            return None
        self.loops_closed.append((kf_id, info))
        if info.get("merge") and self.inertial is not None \
                and self.inertial.initialized:
            # refine the welded region with inertial factors over a wider
            # temporal window
            self.inertial.vi_local_ba(self.cam, st, kf_id, window=16)
        if self.config.global_ba_on_loop and self.config.local_ba:
            lm = self.local_mapper
            with self.stopwatch.scope("global_ba", kf=uid):
                gctx = lm.global_ba_dispatch()
            info["global_ba"] = None
            if gctx is not None:
                gfut = fetch(lm.ba_outs(gctx))
                yield gfut
                with self.stopwatch.scope("global_ba", kf=uid):
                    info["global_ba"] = lm.ba_finish(gctx, gfut.result())
        if self.dense_mapper is not None:
            with self.stopwatch.scope("dense.rebuild", kf=uid):
                self.dense_mapper.rebuild(
                    lambda k: (st.kf_R[k], st.kf_t[k])
                    if st.kf_mask[k] else (None, None))
        return info

    # -- the interleaved backend -------------------------------------------
    @property
    def _interleaved(self) -> bool:
        # visual runs only: the inertial runtime's per-keyframe init and VI
        # BA assume a settled backend
        return (self.config.interleaved_backend and self.actor is None
                and self.config.pipelined and not self.config.use_imu)

    def _submit_backend_fetch(self, outs):
        """Hand a stage's fetch to the two backend helper threads (the mesh
        gather and the local BA are independent; one thread would
        serialize them)."""
        if self._backend_pool is None:
            self._backend_pool = HelperFetch(self.device, 2,
                                             "plvs-backend-fetch")
        return self._backend_pool(outs)

    def _ref_snapshot(self):
        st = self.store
        ref = self.tracker.ref_kf
        with st.lock:
            if 0 <= ref < st.max_kf and st.kf_mask[ref]:
                return ref, st.kf_R[ref].copy(), st.kf_t[ref].copy()
        return None

    def _enqueue_backend(self, kf_id: int, dense_payload=None):
        """Queue the staged backend of a new keyframe. Generators run
        strictly in keyframe order (only the head is stepped); a backlog
        beyond MAX_BACKEND_BACKLOG forces catch-up steps."""
        gen = self._backend_stages(kf_id, dense_payload,
                                   submit=self._submit_backend_fetch)
        self._backend_q.append({"gen": gen, "wait": None, "age": 0,
                                "snap": (self._ref_snapshot(),
                                         len(self.loops_closed))})
        while len(self._backend_q) > self.MAX_BACKEND_BACKLOG:
            self._step_backend(force=True)
        self._step_backend()

    def _step_backend(self, force: bool = False):
        """Run one stage of the FIFO head. A stage whose fetch is not done
        is left until the next poll, unless ``force`` or its deadline."""
        if not self._backend_q:
            return
        head = self._backend_q[0]
        w = head["wait"]
        if w is not None and not force and not w.done():
            head["age"] += 1
            if head["age"] < self.BACKEND_STAGE_DEADLINE:
                return
        head["age"] = 0
        head["wait"] = None
        try:
            head["wait"] = next(head["gen"])
        except StopIteration:
            if self._backend_q and self._backend_q[0] is head:
                self._backend_q.popleft()
            self._fold_backend_correction(head["snap"])

    def _drain_backend(self):
        while self._backend_q:
            self._step_backend(force=True)

    def _fold_backend_correction(self, snap_entry):
        """A loop closure during the staged backend moved the map under the
        tracker: fold T_ref_old^-1 * T_ref_new into the tracker's pose (the
        scheme of MapperActor.apply_pending_correction), then re-snapshot
        the queued keyframes so later folds measure later corrections
        only."""
        snap, n_loops = snap_entry
        if snap is None or len(self.loops_closed) <= n_loops:
            return
        ref, R_old, t_old = snap
        st = self.store
        with st.lock:
            if not st.kf_mask[ref]:
                return
            R_new, t_new = st.kf_R[ref].copy(), st.kf_t[ref].copy()
        dR = R_old.T @ R_new
        dt = R_old.T @ (t_new - t_old)
        tr = self.tracker
        R_f, t_f = tr.R, tr.t
        tr.R = (R_f @ dR).astype(np.float32)
        tr.t = (R_f @ dt + t_f).astype(np.float32)
        self._refresh_backend_snaps()

    def _refresh_backend_snaps(self):
        snap = self._ref_snapshot()
        for entry in self._backend_q:
            entry["snap"] = (snap, len(self.loops_closed))

    def _stop_threads(self):
        """Stop the mapper actor and the helper threads."""
        if self.actor is not None:
            self.actor.shutdown()
        for pool in (self._backend_pool, self.tracker._fetch_pool):
            if pool is not None:
                pool.shutdown()
        self._backend_pool = self.tracker._fetch_pool = None

    def shutdown(self, save_map_path: str | None = None,
                 save_dense_path: str | None = None):
        """Finish the session: settle every queued frame and stage, stop the
        mapper actor and the helper threads, then optionally save the atlas
        (with the vocabulary) and the dense volume."""
        self.flush()
        self._stop_threads()
        if save_map_path:
            serialization.save_atlas(save_map_path, self.store,
                                     self.kfdb.voc if self.kfdb else None)
        if save_dense_path and self.dense_mapper is not None:
            serialization.save_dense(save_dense_path,
                                     self.dense_mapper.volume)

    def load_map(self, path: str, freeze: bool = True,
                 force_relocalization: bool = True,
                 dense_path: str | None = None):
        """Reuse a saved atlas: it replaces the current store in the
        tracker, the mapper and the loop closer, the keyframe database is
        rebuilt over it, and frame numbering carries on after it. With
        ``freeze`` the loaded keyframes stay fixed in every later
        optimization and are never culled, so the session only extends the
        map. The tracker starts in ``RELOCALIZE_IN_LOADED_MAP`` (it never
        initializes a fresh map), or ``LOST`` without
        ``force_relocalization``. ``dense_path`` loads a saved volume onto
        the System's device."""
        expected = self.kfdb.voc if self.config.vocabulary_path else None
        self._freeze_traj_rel()  # the old store's uids die with it
        store, voc = serialization.load_atlas(path, expected_vocab=expected)
        store.ensure_uids()
        if freeze:
            store.kf_fixed[store.kf_mask] = True
        self.store = store
        if voc is not None and self.kfdb.voc is None:
            self.kfdb.voc = voc
        self.kfdb.store = store
        self.kfdb.rebuild()
        self.tracker.store = store
        self.tracker._tbl_cache = None
        self.local_mapper.store = store
        if self.loop_closer is not None:
            self.loop_closer.store = store
        if dense_path and self.dense_mapper is not None:
            dm = self.dense_mapper
            dm.volume = serialization.load_dense(dense_path, self.cam,
                                                 device=self.device)
            dm.mesher = IncrementalMesher(dm.volume)
        live = np.nonzero(store.kf_mask)[0]
        if len(live):
            self.tracker.frame_id = int(store.kf_frame_id[live].max()) + 1
        self.tracker.state = (tracking.RELOCALIZE_IN_LOADED_MAP
                              if force_relocalization else tracking.LOST)
        self.tracker.ref_kf = int(live[-1]) if len(live) else -1
        self.tracker.last_kp_pt_id = None

    def retro_trajectory(self):
        """(ts, R_cw, t_cw) per frame, reconstructed through the current
        keyframe poses (through the tombstones of culled keyframes); frames
        without a reference keyframe keep their tracked pose. Flushes
        first."""
        self.flush()
        out = []
        st = self.store
        with st.lock:
            for i, (ts, R_raw, t_raw) in enumerate(self.trajectory):
                rel = self._traj_rel[i] if i < len(self._traj_rel) else None
                pose = (st.resolve_kf_pose(rel[1])
                        if rel is not None and rel[1] >= 0 else None)
                if pose is None:
                    out.append((ts, R_raw, t_raw))
                else:
                    _, _, R_rel, t_rel = rel
                    R_ref, t_ref = pose
                    out.append((ts, (R_rel @ R_ref).astype(np.float32),
                                (R_rel @ t_ref + t_rel).astype(np.float32)))
        return out

    def trajectory_tum(self) -> np.ndarray:
        """[T, 8] rows (t, tx, ty, tz, qx, qy, qz, qw) of camera-in-world."""
        rows = []
        for ts, R, t in self.retro_trajectory():
            Rwc = R.T
            twc = -Rwc @ t
            q = lie.rotmat_to_quat(torch.from_numpy(
                np.ascontiguousarray(Rwc))).numpy()  # (w, x, y, z)
            rows.append([ts, *twc, q[1], q[2], q[3], q[0]])
        return np.asarray(rows)

    def _freeze_traj_rel(self):
        """Bake the retro-corrected poses into absolute entries, before the
        store is replaced or reset (its uids would dangle, or collide with
        the new store's)."""
        frozen = self.retro_trajectory()
        self.trajectory = [(ts, R, t) for ts, R, t in frozen]
        self._traj_rel = [(ts, -1, R, t) for ts, R, t in frozen]

    def save_trajectory_tum(self, path: str):
        np.savetxt(path, self.trajectory_tum(), fmt="%.6f")

    def save_trajectory_kitti(self, path: str):
        """Flattened 3x4 [R_wc | t_wc] per frame."""
        traj_io.write_kitti(path, self.retro_trajectory())

    def save_trajectory_euroc(self, path: str):
        traj_io.write_euroc(path, self.retro_trajectory())

    def keyframe_trajectory(self):
        """(ts, R_cw, t_cw) of the live keyframes, by timestamp."""
        st = self.store
        live = np.nonzero(st.kf_mask)[0]
        order = live[np.argsort(st.kf_timestamp[live])]
        return [(float(st.kf_timestamp[k]), st.kf_R[k].copy(),
                 st.kf_t[k].copy()) for k in order]

    def save_keyframe_trajectory_tum(self, path: str):
        traj_io.write_tum(path, self.keyframe_trajectory())

    def save_keyframe_trajectory_euroc(self, path: str):
        traj_io.write_euroc(path, self.keyframe_trajectory())

    def map_statistics(self):
        return {
            "keyframes": self.store.num_keyframes,
            "points": self.store.num_points,
            "lines": self.store.num_lines,
            "frames": len(self.trajectory),
            "maps": self.store.n_maps,
        }
