"""Host-side map store: fixed-capacity numpy SoA arrays for keyframes,
landmarks and observations.

Counterpart of plvs_tpu/slam/map_store.py: allocation (with capacity
growth), point and line observations, the covisibility query (numpy;
neighbours ordered by a stable sort of their weights, as in the JAX
package), ``points_in_kfs`` / ``lines_in_kfs``, the keyframe uid layer and
the tombstones of culled keyframes that the trajectory export resolves
through, landmark and keyframe removal and merging, landmark maintenance,
the multi-map atlas operations (``create_map``, ``points_of_map``,
``merge_map_into``, ``ensure_uids``), the full weighted covisibility graph
of loop closing (``covis_graph_full``), and the store lock. Descriptor
columns stay ``np.uint32`` as in the JAX package; the tracker views them
as int32 when it uploads them.

``covis_graph`` and ``spanning_tree`` are numpy copies of the JAX
package's native engine (plvs_tpu/native/src/plvs_native.cpp): the same
edges, weights and parents in the same order. The native graph collects its
weights in a libstdc++ ``std::unordered_map<int64, int32>`` reserved for
1 << 16 entries (key = i * max_kf + j) and emits them in that table's
iteration order: a key opening an empty bucket goes to the front of the
table's list, a key joining a bucket goes to the front of that bucket's
run, and a rehash (when the table is full) re-inserts the list in its
order into the larger table. ``covis_graph`` replays that order with the
table's bucket counts (g++ 12's libstdc++).
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from ..ops import hamming as hamming_ops


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (as uint32), through a byte table."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    pop = hamming_ops._POP8.to(x.device)
    return sum(pop[(x >> s) & 0xFF] for s in (0, 8, 16, 24))


def _distinctive_rows(desc: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """[P, M, 8] int32 descriptor words + [P, M] validity -> [P] index of the
    row with the least median Hamming distance to the other valid rows
    (self-distance excluded; the first such row on ties, as jnp.argmin).
    A popcount-and-sort vote in plain PyTorch: the JAX package computes it
    with jnp, outside any Pallas kernel."""
    d = _popcount32(desc[:, :, None, :] ^ desc[:, None, :, :]).sum(
        -1).to(torch.int32)
    M = desc.shape[1]
    eye = torch.eye(M, dtype=torch.bool, device=desc.device)[None]
    valid = mask[:, :, None] & mask[:, None, :] & ~eye
    BIG = 4096
    d = torch.where(valid, d, BIG)
    d_sorted = torch.sort(d, dim=-1).values
    cnt = valid.sum(-1)
    mid = torch.clamp(torch.div(cnt - 1, 2, rounding_mode="floor"), 0, M - 1)
    med = d_sorted.gather(-1, mid[..., None])[..., 0]
    med = torch.where(mask & (cnt > 0), med, BIG)
    return torch.argmin(med, dim=-1)


# bucket counts of the native covisibility table, a libstdc++
# std::unordered_map<int64_t, int32_t> after reserve(1 << 16): it rehashes
# to the next count when an insert finds it holding as many keys as buckets
_COVIS_BUCKETS = (67307, 136607, 277261, 562841, 1142821, 2320627, 4712381,
                  9569143, 19431899, 39460231)


def _table_order(keys: np.ndarray, n_buckets: int) -> np.ndarray:
    """Iteration order (indices into ``keys``) of a libstdc++ hash table
    after inserting the distinct ``keys`` in order into an empty table of
    ``n_buckets`` buckets: buckets newest-opened first, and within a bucket
    keys newest-inserted first."""
    bucket = keys % n_buckets
    bsort = np.argsort(bucket, kind="stable")
    bstart = np.r_[0, np.nonzero(np.diff(bucket[bsort]))[0] + 1]
    opened = np.empty(len(keys), np.int64)
    opened[bsort] = np.repeat(bsort[bstart], np.diff(np.r_[bstart,
                                                           len(bsort)]))
    return np.lexsort((-np.arange(len(keys)), -opened))


def covis_graph(obs_kf: np.ndarray, obs_pt: np.ndarray, obs_mask: np.ndarray,
                max_kf: int, max_pts: int, min_weight: int = 15):
    """Full weighted covisibility graph as COO edges (i < j, weight), in the
    native engine's order (module docstring)."""
    obs_kf = np.asarray(obs_kf, np.int64)
    obs_pt = np.asarray(obs_pt, np.int64)
    ok = (np.asarray(obs_mask, bool) & (obs_pt >= 0) & (obs_pt < max_pts)
          & (obs_kf >= 0) & (obs_kf < max_kf))
    order = np.argsort(obs_pt[ok], kind="stable")
    pt, kf = obs_pt[ok][order], obs_kf[ok][order]
    n = len(pt)
    empty = np.zeros((0,), np.int32)
    if n < 2:
        return empty, empty, empty
    # every pair (x, y), x < y, of one landmark's observations, in the
    # native loop's order: landmark, then x, then y
    starts = np.r_[0, np.nonzero(pt[1:] != pt[:-1])[0] + 1]
    ends = np.r_[starts[1:], n]
    partners = np.repeat(ends, ends - starts) - np.arange(n) - 1
    xs = np.repeat(np.arange(n), partners)
    ys = xs + 1 + (np.arange(len(xs))
                   - np.repeat(np.cumsum(partners) - partners, partners))
    i, j = kf[xs], kf[ys]
    keep = i != j
    key = np.minimum(i, j)[keep] * max_kf + np.maximum(i, j)[keep]
    if len(key) == 0:
        return empty, empty, empty
    uniq, first, w = np.unique(key, return_index=True, return_counts=True)
    ins = np.argsort(first)          # distinct keys in insertion order
    keys, w = uniq[ins], w[ins]
    # the table's list: each rehash re-inserts the list so far, then the
    # keys up to the next rehash go in
    it = np.zeros((0,), np.int64)
    done = 0
    for b, nxt in zip(_COVIS_BUCKETS, _COVIS_BUCKETS[1:] + (None,)):
        upto = len(keys) if nxt is None else min(len(keys), b)
        seq = np.r_[it, np.arange(done, upto)]
        it = seq[_table_order(keys[seq], b)]
        done = upto
        if done == len(keys):
            break
    it = it[w[it] >= min_weight]
    return ((keys[it] // max_kf).astype(np.int32),
            (keys[it] % max_kf).astype(np.int32), w[it].astype(np.int32))


def spanning_tree(ei: np.ndarray, ej: np.ndarray, w: np.ndarray,
                  max_kf: int) -> np.ndarray:
    """Parent per keyframe (-1 for roots): for each j, the i of the first
    edge (i, j) in edge order with the largest positive weight (the native
    engine's strict-greater scan)."""
    ei, ej, w = (np.asarray(a, np.int64) for a in (ei, ej, w))
    parent = np.full((max_kf,), -1, np.int32)
    pos = np.nonzero(w > 0)[0]
    if len(pos) == 0:
        return parent
    order = pos[np.lexsort((pos, -w[pos], ej[pos]))]
    head = np.r_[True, ej[order][1:] != ej[order][:-1]]
    parent[ej[order][head]] = ei[order][head]
    return parent


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
        # frozen keyframes (a loaded map's): never culled, fixed in every BA
        self.kf_fixed = np.zeros((K,), bool)
        self.kf_timestamp = np.zeros((K,), np.float64)
        self.kf_frame_id = np.zeros((K,), np.int64)
        self.kf_map = np.zeros((K,), np.int64)
        self.active_map = 0
        self.n_maps = 1
        self.kf_uid = np.full((K,), -1, np.int64)
        self._next_kf_uid = 0
        self.uid_slot: dict[int, int] = {}
        # culled keyframes: uid -> (parent_uid, R_cp, t_cp, R_abs, t_abs),
        # the pose relative to the strongest surviving covisible anchor;
        # parent_uid < 0 means no anchor (the absolute pose is final)
        self.kf_tombstone: dict = {}
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
        # slot generation, bumped at each allocation: a solve dispatched
        # before a cull writes back only to slots still holding its landmark
        self.pt_gen = np.zeros((P,), np.int64)
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
        self.ln_gen = np.zeros((Lm,), np.int64)
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
        for name in ("kf_R", "kf_t", "kf_mask", "kf_fixed", "kf_timestamp",
                     "kf_frame_id",
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
                     "pt_visible", "pt_found", "pt_gen"):
            setattr(self, name, self._grown(getattr(self, name), new))
        self.pt_ref_kf = self._grown(self.pt_ref_kf, new, fill=-1)
        self.pt_first_kf = self._grown(self.pt_first_kf, new, fill=-1)
        self.max_pts = new

    def _grow_lines(self):
        new = self.max_lines * 2
        for name in ("ln_Xs", "ln_Xe", "ln_desc", "ln_mask", "ln_n_obs",
                     "ln_visible", "ln_found", "ln_gen"):
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
        """Current world-to-camera pose of keyframe ``uid``, composing
        through the tombstones of culled keyframes; None when unresolvable."""
        R_acc = np.eye(3, dtype=np.float32)
        t_acc = np.zeros(3, np.float32)
        for _ in range(4096):  # bounded tombstone chain
            slot = self.uid_slot.get(uid)
            if slot is not None and self.kf_mask[slot]:
                return ((R_acc @ self.kf_R[slot]).astype(np.float32),
                        (R_acc @ self.kf_t[slot] + t_acc).astype(np.float32))
            tomb = self.kf_tombstone.get(uid)
            if tomb is None:
                return None
            parent, R_cp, t_cp, R_abs, t_abs = tomb
            if parent < 0:
                return ((R_acc @ R_abs).astype(np.float32),
                        (R_acc @ t_abs + t_acc).astype(np.float32))
            t_acc = (R_acc @ t_cp + t_acc).astype(np.float32)
            R_acc = (R_acc @ R_cp).astype(np.float32)
            uid = parent
        return None

    def ensure_uids(self):
        """Assign uids to live keyframes that lack one."""
        for k in np.nonzero(self.kf_mask & (self.kf_uid < 0))[0]:
            uid = self._next_kf_uid
            self._next_kf_uid += 1
            self.kf_uid[k] = uid
            self.uid_slot[uid] = int(k)

    # -- multi-map atlas -----------------------------------------------------

    def create_map(self) -> int:
        """Start a fresh map; later keyframes belong to it."""
        self.active_map = self.n_maps
        self.n_maps += 1
        return self.active_map

    def kfs_of_map(self, map_id: int) -> np.ndarray:
        return np.nonzero(self.kf_mask & (self.kf_map == map_id))[0]

    def points_of_map(self, map_id: int) -> np.ndarray:
        """Live points whose reference keyframe lies in ``map_id``."""
        pts = np.nonzero(self.pt_mask)[0]
        ref = self.pt_ref_kf[pts]
        ok = (ref >= 0) & (self.kf_map[np.clip(ref, 0, self.max_kf - 1)]
                           == map_id)
        return pts[ok]

    def merge_map_into(self, src_map: int, dst_map: int, G_R: np.ndarray,
                       G_t: np.ndarray, G_s: float = 1.0):
        """Weld ``src_map`` into ``dst_map``'s frame: X_dst = s G_R X_src +
        G_t for every landmark, T_kf' = T_kf o G^-1 for every keyframe."""
        kfs = self.kfs_of_map(src_map)
        pts = self.points_of_map(src_map)
        self.pt_xyz[pts] = (
            G_s * self.pt_xyz[pts] @ G_R.T + G_t).astype(np.float32)
        lns = np.nonzero(self.ln_mask)[0]
        if len(lns):
            ref = self.ln_ref_kf[lns]
            sel = lns[(ref >= 0)
                      & (self.kf_map[np.clip(ref, 0, self.max_kf - 1)]
                         == src_map)]
            for arr in (self.ln_Xs, self.ln_Xe):
                arr[sel] = (G_s * arr[sel] @ G_R.T + G_t).astype(np.float32)
        # a camera centre maps like any world point (C' = s G_R C + G_t),
        # so R' = R G_R^T and t' = s t - R' G_t
        for k in kfs:
            Rn = self.kf_R[k] @ G_R.T
            self.kf_t[k] = (G_s * self.kf_t[k] - Rn @ G_t).astype(np.float32)
            self.kf_R[k] = Rn.astype(np.float32)
        self.kf_map[kfs] = dst_map
        if self.active_map == src_map:
            self.active_map = dst_map
        self.version += 1

    def alloc_pts(self, n: int) -> np.ndarray:
        free = np.nonzero(~self.pt_mask[: self._n_pt])[0][:n]
        need = n - len(free)
        self.version += 1
        if need > 0:
            while self._n_pt + need > self.max_pts:
                self._grow_points()
            fresh = np.arange(self._n_pt, self._n_pt + need)
            self._n_pt += need
            free = np.concatenate([free, fresh])
        self.pt_gen[free] += 1
        return free

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
        if need > 0:
            while self._n_ln + need > self.max_lines:
                self._grow_lines()
            fresh = np.arange(self._n_ln, self._n_ln + need)
            self._n_ln += need
            free = np.concatenate([free, fresh])
        self.ln_gen[free] += 1
        return free

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

    # -- removal and merging ------------------------------------------------

    def remove_lines(self, line_ids: np.ndarray):
        if len(line_ids) == 0:
            return
        self.ln_mask[line_ids] = False
        top = self._lobs_top
        sel = np.isin(self.lobs_line[:top], line_ids) & self.lobs_mask[:top]
        self.kf_kl_line[self.lobs_kf[:top][sel], self.lobs_kl[:top][sel]] = -1
        self.lobs_mask[:top][sel] = False
        self.ln_n_obs[line_ids] = 0
        self.version += 1

    def remove_points(self, pt_ids: np.ndarray):
        if len(pt_ids) == 0:
            return
        self.pt_mask[pt_ids] = False
        top = self._obs_top
        sel = np.isin(self.obs_pt[:top], pt_ids) & self.obs_mask[:top]
        self.kf_kp_pt[self.obs_kf[:top][sel], self.obs_kp[:top][sel]] = -1
        self.obs_mask[:top][sel] = False
        self.pt_n_obs[pt_ids] = 0
        self.version += 1

    def replace_point(self, loser: int, winner: int):
        """Merge landmark ``loser`` into ``winner``: observations move over
        unless the winner is already observed in that keyframe. A Python
        loop over the loser's observations, as in the JAX package: its
        order decides which observation survives."""
        if loser == winner:
            return
        top = self._obs_top
        lrows = np.nonzero((self.obs_pt[:top] == loser)
                           & self.obs_mask[:top])[0]
        wkfs = set(self.obs_kf[:top][(self.obs_pt[:top] == winner)
                                     & self.obs_mask[:top]].tolist())
        for r in lrows:
            kf, kp = self.obs_kf[r], self.obs_kp[r]
            if int(kf) in wkfs:
                self.obs_mask[r] = False
                self.kf_kp_pt[kf, kp] = -1
            else:
                self.obs_pt[r] = winner
                self.kf_kp_pt[kf, kp] = winner
                self.pt_n_obs[winner] += 1
                wkfs.add(int(kf))
        self.pt_mask[loser] = False
        self.pt_n_obs[loser] = 0
        self.pt_visible[winner] += self.pt_visible[loser]
        self.pt_found[winner] += self.pt_found[loser]
        self.version += 1

    def replace_line(self, loser: int, winner: int):
        """Merge line landmark ``loser`` into ``winner`` (as
        :meth:`replace_point`)."""
        if loser == winner:
            return
        top = self._lobs_top
        lrows = np.nonzero((self.lobs_line[:top] == loser)
                           & self.lobs_mask[:top])[0]
        wkfs = set(self.lobs_kf[:top][(self.lobs_line[:top] == winner)
                                      & self.lobs_mask[:top]].tolist())
        for r in lrows:
            kf, kl = self.lobs_kf[r], self.lobs_kl[r]
            if int(kf) in wkfs:
                self.lobs_mask[r] = False
                self.kf_kl_line[kf, kl] = -1
            else:
                self.lobs_line[r] = winner
                self.kf_kl_line[kf, kl] = winner
                self.ln_n_obs[winner] += 1
                wkfs.add(int(kf))
        self.ln_mask[loser] = False
        self.ln_n_obs[loser] = 0
        self.ln_visible[winner] += self.ln_visible[loser]
        self.ln_found[winner] += self.ln_found[loser]
        self.version += 1

    def remove_keyframe(self, kf: int):
        """Cull a keyframe: leave a tombstone (its pose relative to the
        strongest surviving covisible anchor, else to the first other
        keyframe of its map) and drop its point and line observations."""
        uid = int(self.kf_uid[kf])
        if uid >= 0:
            covis, _ = self.covisibility(kf, min_weight=1)
            anchor = next((int(c) for c in covis if self.kf_mask[c]), None)
            if anchor is None:
                others = np.nonzero(self.kf_mask
                                    & (self.kf_map == self.kf_map[kf]))[0]
                others = others[others != kf]
                anchor = int(others[0]) if len(others) else None
            R_c, t_c = self.kf_R[kf].copy(), self.kf_t[kf].copy()
            if anchor is not None and self.kf_uid[anchor] >= 0:
                R_p, t_p = self.kf_R[anchor], self.kf_t[anchor]
                R_cp = (R_c @ R_p.T).astype(np.float32)
                t_cp = (t_c - R_cp @ t_p).astype(np.float32)
                self.kf_tombstone[uid] = (int(self.kf_uid[anchor]),
                                          R_cp, t_cp, R_c, t_c)
            else:
                self.kf_tombstone[uid] = (-1, None, None, R_c, t_c)
            self.uid_slot.pop(uid, None)
            self.kf_uid[kf] = -1
        self.kf_mask[kf] = False
        top = self._obs_top
        sel = (self.obs_kf[:top] == kf) & self.obs_mask[:top]
        pts = self.obs_pt[:top][sel]
        self.obs_mask[:top][sel] = False
        np.add.at(self.pt_n_obs, pts, -1)
        self.kf_kp_pt[kf] = -1
        ltop = self._lobs_top
        lsel = (self.lobs_kf[:ltop] == kf) & self.lobs_mask[:ltop]
        lns = self.lobs_line[:ltop][lsel]
        self.lobs_mask[:ltop][lsel] = False
        np.add.at(self.ln_n_obs, lns, -1)
        self.kf_kl_line[kf] = -1

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

    def covis_graph_full(self, min_weight: int = 15):
        """The full weighted covisibility graph in one pass over the
        observation table: COO edges (i, j, w), i < j, over keyframe slots,
        in the JAX package's native order."""
        top = self._obs_top
        return covis_graph(self.obs_kf[:top], self.obs_pt[:top],
                           self.obs_mask[:top], self.max_kf, self.max_pts,
                           min_weight=min_weight)

    def rescale_map(self, s: float, map_id: int | None = None):
        """Multiply one map's metric scale by ``s``: keyframe translations,
        points (and their scale range) and line endpoints; rotations are
        scale-free (the monocular-inertial initialization's rescale)."""
        with self.lock:
            if map_id is None:
                map_id = self.active_map
            kfs = self.kfs_of_map(map_id)
            self.kf_t[kfs] = (self.kf_t[kfs] * s).astype(np.float32)
            pts = np.nonzero(self.pt_mask)[0]
            pts = pts[self.kf_map[self.pt_ref_kf[pts]] == map_id]
            self.pt_xyz[pts] = (self.pt_xyz[pts] * s).astype(np.float32)
            self.pt_min_dist[pts] *= s
            self.pt_max_dist[pts] *= s
            lns = np.nonzero(self.ln_mask)[0]
            lns = lns[self.kf_map[self.ln_ref_kf[lns]] == map_id]
            self.ln_Xs[lns] = (self.ln_Xs[lns] * s).astype(np.float32)
            self.ln_Xe[lns] = (self.ln_Xe[lns] * s).astype(np.float32)
            self.version += 1

    def points_in_kfs(self, kf_ids: np.ndarray) -> np.ndarray:
        okf, opt, _ = self.live_obs()
        return np.unique(opt[np.isin(okf, kf_ids)])

    def lines_in_kfs(self, kf_ids: np.ndarray) -> np.ndarray:
        okf, oln, _ = self.live_line_obs()
        return np.unique(oln[np.isin(okf, kf_ids)])

    # -- landmark maintenance ------------------------------------------------

    def update_point_maintenance(self, pt_ids: np.ndarray, scale: float = 1.2,
                                 n_levels: int = 8, max_obs: int = 12,
                                 device="cuda"):
        """Distinctive-descriptor vote + normal / scale-range update for the
        given landmarks (dispatch, then apply at once)."""
        ctx = self.dispatch_point_maintenance(pt_ids, scale, n_levels, max_obs,
                                              device)
        if ctx is not None:
            self.apply_point_maintenance(ctx, ctx["out"].cpu().numpy())

    def apply_point_maintenance(self, ctx, fetched):
        """Store the voted distinctive descriptors (host half)."""
        P = ctx["P"]
        uniq = ctx["uniq"]
        best = np.asarray(fetched)[:P]
        self.pt_desc[uniq] = ctx["desc"][np.arange(P), best]
        self.pt_angle[uniq] = ctx["angs"][np.arange(P), best]
        self.version += 1

    def dispatch_point_maintenance(self, pt_ids: np.ndarray,
                                   scale: float = 1.2, n_levels: int = 8,
                                   max_obs: int = 12, device="cuda"):
        """Normal / scale-range update (applied at once, numpy) and the
        distinctive-descriptor vote over each landmark's first ``max_obs``
        observations (dispatched on ``device``; the returned ctx's "out" is
        the [P] winning row, applied by :meth:`apply_point_maintenance`)."""
        pt_ids = np.asarray(pt_ids)
        pt_ids = pt_ids[self.pt_mask[pt_ids]]
        if len(pt_ids) == 0:
            return None
        okf, opt, okp = self.live_obs()
        sel = np.isin(opt, pt_ids)
        o_kf, o_pt, o_kp = okf[sel], opt[sel], okp[sel]
        if len(o_pt) == 0:
            return None
        order = np.argsort(o_pt, kind="stable")
        o_kf, o_pt, o_kp = o_kf[order], o_pt[order], o_kp[order]
        uniq, start, counts = np.unique(o_pt, return_index=True,
                                        return_counts=True)
        slot = np.arange(len(o_pt)) - np.repeat(start, counts)
        keep = slot < max_obs
        P = len(uniq)
        row = np.searchsorted(uniq, o_pt)

        # --- normal & scale range (numpy) ---------------------------------
        Cw_all = -np.einsum("kji,kj->ki", self.kf_R[o_kf], self.kf_t[o_kf])
        dirs = self.pt_xyz[o_pt] - Cw_all
        dn = np.linalg.norm(dirs, axis=-1, keepdims=True)
        dirs = dirs / np.maximum(dn, 1e-9)
        nsum = np.zeros((P, 3), np.float32)
        np.add.at(nsum, row, dirs.astype(np.float32))
        nn = np.linalg.norm(nsum, axis=-1, keepdims=True)
        self.pt_normal[uniq] = nsum / np.maximum(nn, 1e-9)
        ref = self.pt_ref_kf[uniq]
        is_ref = o_kf == ref[row]
        # distance and octave at the reference observation (else the first)
        dist_ref = np.zeros((P,), np.float32)
        octv_ref = np.zeros((P,), np.int32)
        dist_ref[row[is_ref]] = dn[is_ref, 0]
        octv_ref[row[is_ref]] = self.kf_kp_octave[o_kf[is_ref], o_kp[is_ref]]
        no_ref = dist_ref == 0
        dist_ref[no_ref] = dn[start, 0][no_ref]
        octv_ref[no_ref] = self.kf_kp_octave[o_kf[start], o_kp[start]][no_ref]
        max_d = dist_ref * (scale ** octv_ref)
        self.pt_max_dist[uniq] = max_d
        self.pt_min_dist[uniq] = max_d / (scale ** (n_levels - 1))
        self.version += 1

        # --- distinctive descriptor (device vote) -------------------------
        desc = np.zeros((P, max_obs, 8), np.uint32)
        dmask = np.zeros((P, max_obs), bool)
        angs = np.zeros((P, max_obs), np.float32)
        desc[row[keep], slot[keep]] = self.kf_kp_desc[o_kf[keep], o_kp[keep]]
        angs[row[keep], slot[keep]] = self.kf_kp_angle[o_kf[keep], o_kp[keep]]
        dmask[row[keep], slot[keep]] = True
        out = _distinctive_rows(
            torch.from_numpy(desc.view(np.int32)).to(device),
            torch.from_numpy(dmask).to(device))
        return {"out": out, "P": P, "uniq": uniq, "desc": desc,
                "angs": angs}

    @property
    def num_keyframes(self):
        return int(self.kf_mask.sum())

    @property
    def num_points(self):
        return int(self.pt_mask.sum())

    @property
    def num_lines(self):
        return int(self.ln_mask.sum())
