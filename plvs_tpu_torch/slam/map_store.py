"""Host-side map store: fixed-capacity numpy SoA arrays for keyframes,
landmarks and observations.

Counterpart of the parts of plvs_tpu/slam/map_store.py that tracking
touches: allocation (with capacity growth), point and line observations,
the covisibility query (the numpy path; the port does not use the JAX
package's native host engine), ``points_in_kfs`` / ``lines_in_kfs``, the
keyframe uid layer the trajectory export resolves through, and the store
lock. Descriptor columns stay ``np.uint32`` as in the JAX package; the
tracker views them as int32 when it uploads them. Landmark maintenance
(``_distinctive_rows``) and removal/culling belong to the keyframe-backend
slice.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np


@dataclasses.dataclass
class MapStore:
    max_kf: int = 512
    max_pts: int = 65536
    max_obs: int = 524288
    n_kp: int = 1024   # keypoint capacity per keyframe
    max_lines: int = 8192
    max_lobs: int = 65536
    n_kl: int = 128    # keyline capacity per keyframe

    def __post_init__(self):
        K, P, O, N = self.max_kf, self.max_pts, self.max_obs, self.n_kp
        self.kf_R = np.zeros((K, 3, 3), np.float32)
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_mask = np.zeros((K,), bool)
        self.kf_timestamp = np.zeros((K,), np.float64)
        self.kf_frame_id = np.zeros((K,), np.int64)
        self.kf_map = np.zeros((K,), np.int64)
        self.active_map = 0
        self.n_maps = 1
        self.kf_uid = np.full((K,), -1, np.int64)
        self._next_kf_uid = 0
        self.uid_slot: dict[int, int] = {}
        self.kf_kp_xy = np.zeros((K, N, 2), np.float32)
        self.kf_kp_uvr = np.full((K, N, 3), -1.0, np.float32)
        self.kf_kp_desc = np.zeros((K, N, 8), np.uint32)
        self.kf_kp_octave = np.zeros((K, N), np.int32)
        self.kf_kp_angle = np.zeros((K, N), np.float32)
        self.kf_kp_mask = np.zeros((K, N), bool)
        self.kf_kp_pt = np.full((K, N), -1, np.int64)
        self.pt_xyz = np.zeros((P, 3), np.float32)
        self.pt_desc = np.zeros((P, 8), np.uint32)
        self.pt_normal = np.zeros((P, 3), np.float32)
        self.pt_min_dist = np.zeros((P,), np.float32)
        self.pt_max_dist = np.zeros((P,), np.float32)
        self.pt_angle = np.zeros((P,), np.float32)
        self.pt_mask = np.zeros((P,), bool)
        self.pt_ref_kf = np.full((P,), -1, np.int64)
        self.pt_first_kf = np.full((P,), -1, np.int64)
        self.pt_n_obs = np.zeros((P,), np.int32)
        self.pt_visible = np.zeros((P,), np.int32)
        self.pt_found = np.zeros((P,), np.int32)
        self.obs_kf = np.zeros((O,), np.int64)
        self.obs_pt = np.zeros((O,), np.int64)
        self.obs_kp = np.zeros((O,), np.int64)
        self.obs_mask = np.zeros((O,), bool)
        Lm, Ol, Nl = self.max_lines, self.max_lobs, self.n_kl
        self.ln_Xs = np.zeros((Lm, 3), np.float32)
        self.ln_Xe = np.zeros((Lm, 3), np.float32)
        self.ln_desc = np.zeros((Lm, 8), np.uint32)
        self.ln_mask = np.zeros((Lm,), bool)
        self.ln_ref_kf = np.full((Lm,), -1, np.int64)
        self.ln_first_kf = np.full((Lm,), -1, np.int64)
        self.ln_n_obs = np.zeros((Lm,), np.int32)
        self.ln_visible = np.zeros((Lm,), np.int32)
        self.ln_found = np.zeros((Lm,), np.int32)
        self.kf_kl_sp = np.zeros((K, Nl, 2), np.float32)
        self.kf_kl_ep = np.zeros((K, Nl, 2), np.float32)
        self.kf_kl_desc = np.zeros((K, Nl, 8), np.uint32)
        self.kf_kl_mask = np.zeros((K, Nl), bool)
        self.kf_kl_line = np.full((K, Nl), -1, np.int64)
        self.kf_kl_depth = np.zeros((K, Nl, 2), np.float32)
        self.lobs_kf = np.zeros((Ol,), np.int64)
        self.lobs_line = np.zeros((Ol,), np.int64)
        self.lobs_kl = np.zeros((Ol,), np.int64)
        self.lobs_mask = np.zeros((Ol,), bool)
        self._n_kf = 0
        self._n_pt = 0
        self._n_ln = 0
        self._obs_top = 0
        self._lobs_top = 0
        # landmark mutation counter: the tracker's device-resident landmark
        # tables are re-uploaded only when it moves (a keyframe-rate event)
        self.version = 0
        self.lock = threading.RLock()

    # -- allocation ---------------------------------------------------------

    @staticmethod
    def _grown(arr: np.ndarray, new_cap: int, fill=None) -> np.ndarray:
        shape = (new_cap,) + arr.shape[1:]
        out = np.zeros(shape, arr.dtype) if fill is None \
            else np.full(shape, fill, arr.dtype)
        out[: arr.shape[0]] = arr
        return out

    def _grow_kfs(self):
        new = self.max_kf * 2
        for name in ("kf_R", "kf_t", "kf_mask", "kf_timestamp", "kf_frame_id",
                     "kf_map", "kf_kp_xy", "kf_kp_desc", "kf_kp_octave",
                     "kf_kp_angle", "kf_kp_mask", "kf_kl_sp", "kf_kl_ep",
                     "kf_kl_desc", "kf_kl_mask", "kf_kl_depth"):
            setattr(self, name, self._grown(getattr(self, name), new))
        self.kf_kp_uvr = self._grown(self.kf_kp_uvr, new, fill=-1.0)
        self.kf_kp_pt = self._grown(self.kf_kp_pt, new, fill=-1)
        self.kf_kl_line = self._grown(self.kf_kl_line, new, fill=-1)
        self.kf_uid = self._grown(self.kf_uid, new, fill=-1)
        self.max_kf = new

    def _grow_points(self):
        new = self.max_pts * 2
        for name in ("pt_xyz", "pt_desc", "pt_normal", "pt_min_dist",
                     "pt_max_dist", "pt_angle", "pt_mask", "pt_n_obs",
                     "pt_visible", "pt_found"):
            setattr(self, name, self._grown(getattr(self, name), new))
        self.pt_ref_kf = self._grown(self.pt_ref_kf, new, fill=-1)
        self.pt_first_kf = self._grown(self.pt_first_kf, new, fill=-1)
        self.max_pts = new

    def _grow_lines(self):
        new = self.max_lines * 2
        for name in ("ln_Xs", "ln_Xe", "ln_desc", "ln_mask", "ln_n_obs",
                     "ln_visible", "ln_found"):
            setattr(self, name, self._grown(getattr(self, name), new))
        self.ln_ref_kf = self._grown(self.ln_ref_kf, new, fill=-1)
        self.ln_first_kf = self._grown(self.ln_first_kf, new, fill=-1)
        self.max_lines = new

    def alloc_kf(self) -> int:
        free = np.nonzero(~self.kf_mask[: self._n_kf])[0]
        if len(free):
            k = int(free[0])
        else:
            if self._n_kf >= self.max_kf:
                self._grow_kfs()
            k = self._n_kf
            self._n_kf += 1
        self.kf_map[k] = self.active_map
        uid = self._next_kf_uid
        self._next_kf_uid += 1
        self.kf_uid[k] = uid
        self.uid_slot[uid] = k
        return k

    def resolve_kf_pose(self, uid: int):
        """Current world-to-camera pose of keyframe ``uid`` (None when it is
        gone; keyframe culling and its tombstones come with the backend)."""
        slot = self.uid_slot.get(uid)
        if slot is not None and self.kf_mask[slot]:
            return self.kf_R[slot].copy(), self.kf_t[slot].copy()
        return None

    def alloc_pts(self, n: int) -> np.ndarray:
        free = np.nonzero(~self.pt_mask[: self._n_pt])[0][:n]
        need = n - len(free)
        self.version += 1
        if need <= 0:
            return free
        while self._n_pt + need > self.max_pts:
            self._grow_points()
        fresh = np.arange(self._n_pt, self._n_pt + need)
        self._n_pt += need
        return np.concatenate([free, fresh])

    def add_observations(self, kf: int, pt_ids: np.ndarray, kp_ids: np.ndarray):
        n = len(pt_ids)
        if n == 0:
            return
        if self._obs_top + n > self.max_obs:
            self.compact_observations()
            while self._obs_top + n > self.max_obs:
                new = self.max_obs * 2
                for name in ("obs_kf", "obs_pt", "obs_kp", "obs_mask"):
                    setattr(self, name, self._grown(getattr(self, name), new))
                self.max_obs = new
        sl = slice(self._obs_top, self._obs_top + n)
        self.obs_kf[sl] = kf
        self.obs_pt[sl] = pt_ids
        self.obs_kp[sl] = kp_ids
        self.obs_mask[sl] = True
        self._obs_top += n
        self.kf_kp_pt[kf, kp_ids] = pt_ids
        np.add.at(self.pt_n_obs, pt_ids, 1)

    def compact_observations(self):
        live = self.obs_mask[: self._obs_top]
        n = int(live.sum())
        for a in (self.obs_kf, self.obs_pt, self.obs_kp):
            a[:n] = a[: self._obs_top][live]
        self.obs_mask[:n] = True
        self.obs_mask[n:] = False
        self._obs_top = n

    def alloc_lines(self, n: int) -> np.ndarray:
        free = np.nonzero(~self.ln_mask[: self._n_ln])[0][:n]
        need = n - len(free)
        self.version += 1
        if need <= 0:
            return free
        while self._n_ln + need > self.max_lines:
            self._grow_lines()
        fresh = np.arange(self._n_ln, self._n_ln + need)
        self._n_ln += need
        return np.concatenate([free, fresh])

    def add_line_observations(self, kf: int, line_ids: np.ndarray,
                              kl_ids: np.ndarray):
        n = len(line_ids)
        if n == 0:
            return
        if self._lobs_top + n > self.max_lobs:
            self.compact_line_observations()
            while self._lobs_top + n > self.max_lobs:
                new = self.max_lobs * 2
                for name in ("lobs_kf", "lobs_line", "lobs_kl", "lobs_mask"):
                    setattr(self, name, self._grown(getattr(self, name), new))
                self.max_lobs = new
        sl = slice(self._lobs_top, self._lobs_top + n)
        self.lobs_kf[sl] = kf
        self.lobs_line[sl] = line_ids
        self.lobs_kl[sl] = kl_ids
        self.lobs_mask[sl] = True
        self._lobs_top += n
        self.kf_kl_line[kf, kl_ids] = line_ids
        np.add.at(self.ln_n_obs, line_ids, 1)

    def compact_line_observations(self):
        live = self.lobs_mask[: self._lobs_top]
        n = int(live.sum())
        for a in (self.lobs_kf, self.lobs_line, self.lobs_kl):
            a[:n] = a[: self._lobs_top][live]
        self.lobs_mask[:n] = True
        self.lobs_mask[n:] = False
        self._lobs_top = n

    # -- derived structures -------------------------------------------------

    def live_obs(self):
        m = self.obs_mask[: self._obs_top]
        return (self.obs_kf[: self._obs_top][m], self.obs_pt[: self._obs_top][m],
                self.obs_kp[: self._obs_top][m])

    def live_line_obs(self):
        m = self.lobs_mask[: self._lobs_top]
        return (self.lobs_kf[: self._lobs_top][m],
                self.lobs_line[: self._lobs_top][m],
                self.lobs_kl[: self._lobs_top][m])

    def covisibility(self, kf: int, min_weight: int = 15):
        """KF ids sharing >= min_weight map points with ``kf``, sorted by
        weight desc (stable), with their weights."""
        okf, opt, _ = self.live_obs()
        my_pts = opt[okf == kf]
        if len(my_pts) == 0:
            return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
        sel = np.isin(opt, my_pts) & (okf != kf)
        counts = np.bincount(okf[sel], minlength=self.max_kf)
        ids = np.nonzero(counts >= min_weight)[0]
        ids = ids[np.argsort(-counts[ids], kind="stable")]
        return ids, counts[ids]

    def points_in_kfs(self, kf_ids: np.ndarray) -> np.ndarray:
        okf, opt, _ = self.live_obs()
        return np.unique(opt[np.isin(okf, kf_ids)])

    def lines_in_kfs(self, kf_ids: np.ndarray) -> np.ndarray:
        okf, oln, _ = self.live_line_obs()
        return np.unique(oln[np.isin(okf, kf_ids)])

    @property
    def num_keyframes(self):
        return int(self.kf_mask.sum())

    @property
    def num_points(self):
        return int(self.pt_mask.sum())

    @property
    def num_lines(self):
        return int(self.ln_mask.sum())
