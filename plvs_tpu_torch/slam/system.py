"""System facade for synchronous RGB-D and rectified-stereo SLAM with
points and lines, loop closing, relocalization and dense TSDF mapping.

Counterpart of plvs_tpu/slam/system.py for the ported slices:
``SystemConfig`` keeps every field and default of the JAX package, and the
settings whose machinery is not ported yet raise ``NotImplementedError``
naming the ROADMAP.md item that ports them — none of them gets a stand-in.
New map points and line landmarks come from depth at every keyframe. The
keyframe database (place recognition) is always built: relocalization
needs it. After each keyframe the synchronous backend runs inline, as the
JAX package's does: with ``local_ba`` the local mapper (culling, line
triangulation, fuse, landmark maintenance, the windowed local BA, keyframe
culling), then with ``dense_mapping`` the dense stage (depth — from stereo
through kernel K3 on the stereo path —, filter, TSDF integration and the
incremental mesh) at the keyframe's adjusted pose, then with
``loop_closing`` the loop closer (else the keyframe is only indexed). A
closed loop is followed by the global BA (``global_ba_on_loop`` with
``local_ba``) and the dense map's rebuild at the corrected poses. The
tracker then continues from the keyframe's stored pose.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..dense.mapping import DenseMapper
from ..geometry import cameras as cam_mod
from ..geometry import lie
from ..ops import resolve_device
from ..utils.profiling import Stopwatch
from ..vocab import bow
from . import frame as frame_mod
from . import tracking
from .keyframe_database import KeyFrameDatabase
from .local_mapping import LocalMapper
from .loop_closing import LoopCloser
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


# settings outside this slice -> (value that is in the slice, ROADMAP item)
_NOT_IN_SLICE = {
    "dense_segmentation": (False, "queue 1 item 7, segmentation"),
    "pipelined": (False, "queue 1 item 4, pipelined runtime"),
    "async_mapping": (False, "queue 1 item 4, pipelined runtime"),
    "use_imu": (False, "queue 1 item 5, inertial"),
    "rectify": (False, "queue 1 item 6, stereo rectification"),
    "sharded_backend": (False, "queue 1 item 8, multi-device"),
    "image_scale": (1.0, "queue 1 item 7, mono and the rest"),
}


class System:
    """RGB-D / rectified-stereo SLAM on one device (synchronous, optional
    keyframe backend and dense mapping)."""

    def __init__(self, cam: cam_mod.Camera, config: SystemConfig | None = None,
                 device: str | torch.device = "cuda", cam2=None, T_c1_c2=None):
        self.config = c = config or SystemConfig()
        for name, (ok_value, item) in _NOT_IN_SLICE.items():
            if getattr(c, name) != ok_value:
                raise NotImplementedError(
                    f"SystemConfig.{name}={getattr(c, name)!r} is not in the "
                    f"ported slice; ROADMAP.md {item} ports it")
        if c.sensor not in ("rgbd", "stereo"):
            raise NotImplementedError(
                f"SystemConfig.sensor={c.sensor!r}: RGB-D and rectified "
                "stereo are ported; mono is ROADMAP.md queue 1 item 7")
        if cam2 is not None or T_c1_c2 is not None:
            raise NotImplementedError(
                "cam2 / T_c1_c2: the non-rectified stereo rig is ROADMAP.md "
                "queue 1 item 6 (stereo rig)")
        self.device = resolve_device(device)
        self.cam = cam
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
            min_init_pts=max(100, int(round(300 * c.image_scale ** 2))),
            kfdb=self.kfdb, new_map_after_lost=c.new_map_after_lost,
            device=self.device)
        tr = self.tracker
        tr.only_tracking = c.only_tracking
        tr.scale = c.scale
        tr.n_levels = c.n_levels
        tr.max_keylines = c.max_lines
        tr.depth_decimation = c.depth_upload_decimation
        tr.fixed_shapes = c.backend_fixed_shapes
        self.local_mapper = LocalMapper(
            cam, self.store, scale=c.scale, n_levels=c.n_levels,
            use_lines=c.use_lines, kfdb=self.kfdb,
            fixed_shapes=c.backend_fixed_shapes, device=self.device)
        self.loop_closer = (LoopCloser(self.store, kfdb=self.kfdb, cam=cam,
                                       device=self.device)
                            if c.loop_closing else None)
        self.loops_closed = []  # (kf_id, info) per closed loop
        self.dense_mapper = None
        if c.dense_mapping:
            self.dense_mapper = DenseMapper(
                cam, voxel_size=c.dense_voxel_size,
                mesh_every=c.dense_mesh_every, device=self.device)
        # per-stage timing (host clock; no synchronisation unless the
        # caller installs a stopwatch with a sync device)
        self.set_stopwatch(Stopwatch())
        self.trajectory = []  # (timestamp, R, t) world-to-camera
        # (timestamp, ref_kf_uid, R_rel, t_rel): T_frame_w = T_rel * T_ref_w,
        # so the export follows any later change of the keyframe poses
        self._traj_rel = []

    def set_stopwatch(self, stopwatch: Stopwatch):
        """Time the system's stages, the local mapper's and the dense
        mapper's through ``stopwatch``."""
        self.stopwatch = stopwatch
        self.local_mapper.stopwatch = stopwatch
        if self.loop_closer is not None:
            self.loop_closer.stopwatch = stopwatch
        if self.dense_mapper is not None:
            self.dense_mapper.stopwatch = stopwatch

    def time_stats(self) -> dict:
        """Per-stage timing statistics (mean / std / median / total ms and
        count per stage over the run)."""
        return self.stopwatch.stats()

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

    def track_rgbd(self, gray: np.ndarray, depth: np.ndarray, timestamp: float,
                   imu_samples=None):
        """Track one RGB-D frame (gray [H, W], depth [H, W] metres); returns
        (state, Rcw, tcw)."""
        if imu_samples is not None:
            raise NotImplementedError(
                "imu_samples: the inertial path is ROADMAP.md queue 1 item 5")
        res = None
        if self.tracker.state == OK:
            planes = _pack_rgbd(gray, depth, self.config.depth_upload_decimation)
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
        return self._post_track(res, timestamp, payload)

    def track_stereo(self, gray_l: np.ndarray, gray_r: np.ndarray,
                     timestamp: float, imu_samples=None):
        """Track one rectified stereo pair (gray [H, W] each, float32 as
        given — stereo images are not quantized); returns (state, Rcw,
        tcw)."""
        if imu_samples is not None:
            raise NotImplementedError(
                "imu_samples: the inertial path is ROADMAP.md queue 1 item 5")
        c = self.config
        gl = torch.from_numpy(np.asarray(gray_l, np.float32)).to(self.device)
        gr = torch.from_numpy(np.asarray(gray_r, np.float32)).to(self.device)
        fr = frame_mod.build_frame_stereo(gl, gr, self.cam, c.num_features,
                                          c.n_levels, c.scale)
        fl = (frame_mod.build_frame_lines_stereo(gl, gr, self.cam,
                                                 c.max_lines)
              if c.use_lines else None)
        res = self.tracker.process_frame(fr, timestamp, fl)
        payload = ("stereo", gl, gr) if self.dense_mapper else None
        return self._post_track(res, timestamp, payload)

    def _post_track(self, res, timestamp: float, dense_payload=None):
        """Common tail of every Track* entry point; on a keyframe, the dense
        stage runs inline."""
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
            self._backend_keyframe(res.kf_id, dense_payload)
            # keep the tracker's pose consistent with the adjusted keyframe
            self.tracker.R = st.kf_R[res.kf_id].copy()
            self.tracker.t = st.kf_t[res.kf_id].copy()
        self.trajectory.append((timestamp, res.R.copy(), res.t.copy()))
        return res.state, res.R, res.t

    def _backend_keyframe(self, kf_id: int, dense_payload=None):
        """The synchronous per-keyframe backend: the local mapper, the dense
        stage at the keyframe's pose after bundle adjustment, then the loop
        closer (or the keyframe database alone); after a closure the global
        BA and the dense rebuild."""
        st = self.store
        if self.config.local_ba:
            with self.stopwatch.scope("local_mapping"):
                self.local_mapper.process_keyframe(kf_id)
        if self.dense_mapper is not None and dense_payload is not None:
            kind, a, b = dense_payload
            with self.stopwatch.scope("dense_mapping"):
                self.dense_mapper.insert_keyframe(kind, kf_id, a, b,
                                                  st.kf_R[kf_id],
                                                  st.kf_t[kf_id])
        if self.loop_closer is None:
            self.kfdb.add(kf_id)
            return None
        with self.stopwatch.scope("loop_closing"):
            info = self.loop_closer.process_keyframe(kf_id)
        if info is None:
            return None
        self.loops_closed.append((kf_id, info))
        if self.config.global_ba_on_loop and self.config.local_ba:
            with self.stopwatch.scope("global_ba"):
                info["global_ba"] = self.local_mapper._solve(
                    self.local_mapper.global_ba_dispatch())
        if self.dense_mapper is not None:
            with self.stopwatch.scope("dense.rebuild"):
                self.dense_mapper.rebuild(
                    lambda k: (st.kf_R[k], st.kf_t[k])
                    if st.kf_mask[k] else (None, None))
        return info

    def retro_trajectory(self):
        """(ts, R_cw, t_cw) per frame, reconstructed through the current
        keyframe poses (through the tombstones of culled keyframes); frames
        without a reference keyframe keep their tracked pose."""
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

    def map_statistics(self):
        return {
            "keyframes": self.store.num_keyframes,
            "points": self.store.num_points,
            "lines": self.store.num_lines,
            "frames": len(self.trajectory),
            "maps": self.store.n_maps,
        }
