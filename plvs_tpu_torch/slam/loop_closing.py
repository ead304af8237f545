"""Loop closing: BoW place recognition, geometric verification and
essential-graph correction, synchronous per keyframe.

Counterpart of plvs_tpu/slam/loop_closing.py's ``LoopCloser``: candidates
from the keyframe database's inverted file (score gate from the covisible
neighbours), verification by the batched Sim3 / SE3 RANSAC on matched
landmarks (descriptor matches through kernel K1), a Sim3-guided projection
of the candidate's local map that expands the support (K1 again), the
consecutive-coincidence streak with one tolerated miss, the drift gate,
and the correction: a pose graph over the map's keyframes (temporal chain,
covisibility and spanning-tree edges from the current poses, and the loop
edge), its landmarks moved through their reference keyframe's pose change,
and the verified duplicate points and lines fused. A place recognised in
another map of the atlas welds that map in instead (``_merge``).

The RANSAC draws from a ``torch.Generator`` seeded 0 on the closer's device
(the JAX package's ``PRNGKey(0)``, whose stream PyTorch cannot
reproduce). Once ``gravity_w`` is set (the System sets it when the IMU
is initialized) the correction is the 4-DoF essential graph: each vertex
turns only about its camera-frame gravity axis. The map objects of
``object_store`` move with their best-observing keyframe (the latest one
in the corrected map). The sharded pose graph (``mesh``) is not ported;
setting it raises, naming its ROADMAP.md item.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..features import matching
from ..ops import resolve_device
from ..solvers import pose_graph, sim3_solver
from .frame import project_points
from .keyframe_database import KeyFrameDatabase
from .map_store import MapStore, spanning_tree

# settings outside the ported slice -> ROADMAP.md item
_NOT_IN_SLICE = {
    "mesh": "queue 1 item 8, multi-device (the sharded pose graph)",
}


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _words(a: np.ndarray, device) -> torch.Tensor:
    """uint32 descriptor words -> int32 tensor on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


@dataclasses.dataclass
class LoopCloser:
    store: MapStore
    kfdb: KeyFrameDatabase | None = None
    # camera model for the Sim3-guided projection expansion; None takes the
    # 3-D proximity expansion
    cam: object | None = None
    min_score_ratio: float = 0.75
    # final acceptance support, on the expanded correspondences
    min_inliers: int = 20
    min_kf_gap: int = 10          # don't close against recent KFs
    fix_scale: bool = True        # RGB-D / stereo
    # consecutive agreeing detections before a correction
    required_coincidences: int = 2
    # expanded support that closes after one confirming coincidence
    strong_inliers: int = 60
    # keyframes after a closure during which detection is skipped
    closure_backoff_kfs: int = 10
    # a later detection extends a pending one within these drift changes
    coincidence_rot_tol: float = 0.17   # rad
    coincidence_trans_tol: float = 0.5  # metres
    # plausibility gate on the world drift a loop within one map implies
    max_drift_rot: float = 1.3    # rad
    max_drift_trans: float = 2.0  # metres
    gravity_w: np.ndarray | None = None
    object_store: object | None = None
    stopwatch: object | None = None  # optional stage timing (.scope(name))
    mesh: object | None = None
    device: str | torch.device = "cuda"

    def _scope(self, name: str):
        if self.stopwatch is None:
            return contextlib.nullcontext()
        return self.stopwatch.scope(name)

    def __post_init__(self):
        for name, item in _NOT_IN_SLICE.items():
            if getattr(self, name) is not None:
                raise NotImplementedError(
                    f"LoopCloser.{name} is not in the ported slice; "
                    f"ROADMAP.md {item} ports it")
        self.device = resolve_device(self.device)
        if self.kfdb is None:
            self.kfdb = KeyFrameDatabase(self.store, device=self.device)
        self.last_loop_kf = -1
        self._kfs_since_loop = 10 ** 9  # no closure yet: detection free
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        # pending detection awaiting consecutive confirmations: dict(cand,
        # kf, count, G_R, G_t), (G_R, G_t) the implied world drift
        self._pending = None
        # optional diagnostics: one dict per process_keyframe call
        self.trace: list | None = None

    def _trace(self, kf_id: int, **kw):
        if self.trace is not None:
            self.trace.append({"kf": int(kf_id), **kw})

    # ------------------------------------------------------------------
    def _drift_transform(self, kf_id: int, cand: int, R_rel, t_rel):
        """World-to-world drift G implied by X_cand_cam = R_rel X_kf_cam +
        t_rel: G maps the active (drifted) world into the candidate's."""
        st = self.store
        Rc, tc = st.kf_R[cand], st.kf_t[cand]
        Rk, tk = st.kf_R[kf_id], st.kf_t[kf_id]
        G_R = (Rc.T @ R_rel @ Rk).astype(np.float32)
        G_t = (Rc.T @ (R_rel @ tk + t_rel - tc)).astype(np.float32)
        return G_R, G_t

    # ------------------------------------------------------------------
    def process_keyframe(self, kf_id: int, words=None) -> dict | None:
        """Index, detect, verify and (after enough consecutive
        coincidences) correct. Returns the loop's info dict if one
        closed. ``words``: the keyframe's word ids, when already
        quantized."""
        st = self.store
        with self._scope("lc.bow_add"):
            if not self.kfdb.add(kf_id, words=words):
                return None
        # post-closure backoff: index the keyframe but skip detection
        self._kfs_since_loop += 1
        if self._kfs_since_loop <= self.closure_backoff_kfs:
            self._trace(kf_id, stage="backoff",
                        since=int(self._kfs_since_loop))
            return None

        with self._scope("lc.detect"):
            cands = self._detect(kf_id)
        # a pending hypothesis is re-verified first
        if self._pending is not None:
            pc = int(self._pending["cand"])
            cands = [pc] + [c for c in cands if c != pc]
        if not cands:
            self._trace(kf_id, stage="detect", n_cands=0)
            self._pending_miss()
            return None
        ok = False
        with self._scope("lc.verify"):
            for cand in cands:
                ok, R_rel, t_rel, n_inl, pairs = self._verify(kf_id, cand)
                if ok:
                    break
        if not ok:
            self._trace(kf_id, stage="verify_fail",
                        cands=list(map(int, cands)), last_inl=int(n_inl))
            self._pending_miss()
            return None
        G_R, G_t = self._drift_transform(kf_id, cand, R_rel, t_rel)
        if st.kf_map[cand] == st.kf_map[kf_id]:
            ang = float(np.arccos(np.clip((np.trace(G_R) - 1) / 2,
                                          -1.0, 1.0)))
            if (ang > self.max_drift_rot
                    or np.linalg.norm(G_t) > self.max_drift_trans):
                self._trace(kf_id, stage="drift_gate", cand=int(cand),
                            inl=int(n_inl), ang=round(ang, 3),
                            trans=round(float(np.linalg.norm(G_t)), 3))
                self._pending_miss()
                return None

        pend = self._pending
        if pend is not None and self._consistent(pend, cand, G_R, G_t):
            count = pend["count"] + 1
        else:
            count = 1
        self._pending = dict(cand=cand, kf=kf_id, count=count,
                             G_R=G_R, G_t=G_t)
        # strong support shortens a long streak, never closes on one hit
        strong = int(n_inl) >= self.strong_inliers and count >= 2
        self._trace(kf_id, stage="coincidence", cand=int(cand),
                    inl=int(n_inl), count=count, strong=strong)
        if count < self.required_coincidences and not strong:
            return None
        self._pending = None

        with self._scope("lc.correct"):
            if st.kf_map[cand] != st.kf_map[kf_id]:
                with st.lock:
                    info = self._merge(kf_id, cand, R_rel, t_rel, pairs)
            else:
                info = self._correct(kf_id, cand, R_rel, t_rel, pairs)
        info.update({"candidate": int(cand), "inliers": int(n_inl)})
        self.last_loop_kf = kf_id
        self._kfs_since_loop = 0
        return info

    # ------------------------------------------------------------------
    def _pending_miss(self):
        """Tolerate one keyframe that fails to re-confirm the pending
        region; a second consecutive miss resets the streak."""
        if self._pending is None:
            return
        self._pending["misses"] = self._pending.get("misses", 0) + 1
        if self._pending["misses"] > 1:
            self._pending = None

    def _consistent(self, pend: dict, cand: int, G_R, G_t) -> bool:
        """A new detection extends a pending one if it names the same region
        (the pending candidate or a keyframe covisible with it) and implies
        the same world drift."""
        st = self.store
        if cand != pend["cand"]:
            covis, _ = st.covisibility(int(pend["cand"]), min_weight=5)
            if cand not in set(covis.tolist()):
                return False
        dR = pend["G_R"].T @ G_R
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1.0, 1.0))
        dt = np.linalg.norm(G_t - pend["G_t"])
        return bool(ang < self.coincidence_rot_tol
                    and dt < self.coincidence_trans_tol)

    # ------------------------------------------------------------------
    def _merge(self, kf_id: int, cand: int, R_rel, t_rel, pairs) -> dict:
        """Weld kf_id's map into cand's map: G = T_cand^-1 o (R_rel, t_rel)
        o T_kf, then fuse the verified duplicate landmarks (the matched,
        older map's point stays)."""
        st = self.store
        src_map = int(st.kf_map[kf_id])
        dst_map = int(st.kf_map[cand])
        G_R, G_t = self._drift_transform(kf_id, cand, R_rel, t_rel)
        st.merge_map_into(src_map, dst_map, G_R, G_t)
        n_fused = 0
        for p_src, p_dst in pairs:
            if st.pt_mask[p_src] and st.pt_mask[p_dst] and p_src != p_dst:
                st.replace_point(int(p_src), int(p_dst))
                n_fused += 1
        return {"merged_map": src_map, "into_map": dst_map,
                "n_fused": n_fused, "merge": True, "cost0": 0.0, "cost": 0.0,
                "n_kf": int(len(st.kfs_of_map(dst_map)))}

    # ------------------------------------------------------------------
    def _detect(self, kf_id: int):
        """Inverted-file candidates: shared-word prefilter and L1 score, the
        gate from the least similar of the first ten covisible keyframes."""
        st = self.store
        covis, _ = st.covisibility(kf_id, min_weight=5)
        cov_scores = [self.kfdb.score_pair(kf_id, int(c)) for c in covis[:10]]
        min_score = min(cov_scores) if cov_scores else 0.05
        live = np.nonzero(st.kf_mask)[0]
        recent = set(live[np.abs(st.kf_frame_id[live] - st.kf_frame_id[kf_id])
                          < self.min_kf_gap].tolist())
        excluded = set(covis.tolist()) | {kf_id} | recent
        cands = self.kfdb.query_keyframe(
            kf_id, top_n=3, exclude=excluded,
            min_score=max(self.min_score_ratio * min_score, 0.015))
        return [c for c, _s in cands]

    # ------------------------------------------------------------------
    def _ransac(self, X1, X2, inlier_thresh: float):
        """Sim3 / SE3 RANSAC X2 = s R X1 + t on the closer's device, read
        back in one transfer."""
        X1 = torch.as_tensor(np.asarray(X1, np.float32), device=self.device)
        X2 = torch.as_tensor(np.asarray(X2, np.float32), device=self.device)
        valid = torch.ones((X1.shape[0],), dtype=torch.bool,
                           device=self.device)
        res = sim3_solver.sim3_ransac(X1, X2, valid, self._generator,
                                      inlier_thresh=inlier_thresh,
                                      with_scale=not self.fix_scale)
        return sim3_solver.RansacResult(*(x.cpu().numpy() for x in res))

    def _verify(self, kf_id: int, cand: int, coarse_min: int = 7):
        """Geometric verification: strict descriptor matches (TH_LOW, 0.75
        ratio) give a coarse transform that needs ``coarse_min`` inliers;
        the guided expansion then gathers the candidate window's support and
        refits, and the acceptance gate (``min_inliers``) applies to the
        expanded support."""
        st = self.store
        dev = self.device
        idx, _ = matching.match_nn_ratio(
            _words(st.kf_kp_desc[kf_id], dev), _words(st.kf_kp_desc[cand], dev),
            torch.from_numpy(st.kf_kp_mask[kf_id]
                             & (st.kf_kp_pt[kf_id] >= 0)).to(dev),
            torch.from_numpy(st.kf_kp_mask[cand]
                             & (st.kf_kp_pt[cand] >= 0)).to(dev),
            max_dist=50, ratio=0.75)
        idx = idx.cpu().numpy()
        sel = np.nonzero(idx >= 0)[0]
        if len(sel) < coarse_min:
            return False, None, None, 0, None
        p1_ids = st.kf_kp_pt[kf_id][sel]
        p2_ids = st.kf_kp_pt[cand][idx[sel]]
        # both sides in their own camera frames: the estimate is the
        # relative pose
        X1 = st.pt_xyz[p1_ids] @ st.kf_R[kf_id].T + st.kf_t[kf_id]
        X2 = st.pt_xyz[p2_ids] @ st.kf_R[cand].T + st.kf_t[cand]
        # generous coarse threshold: the active side's geometry is warped
        # by the drift spread across its window
        res = self._ransac(X1, X2, inlier_thresh=0.20)
        n_coarse = int(res.n_inliers)
        if n_coarse < coarse_min:
            return False, None, None, n_coarse, None
        inl = res.inliers
        pairs = list(zip(p1_ids[inl].tolist(), p2_ids[inl].tolist()))

        # guided expansion and refit
        R_rel, t_rel = res.R, res.t
        G_R, G_t = self._drift_transform(kf_id, cand, R_rel, t_rel)
        pairs2 = self._expand_pairs(kf_id, cand, pairs, G_R, G_t)
        best = (R_rel, t_rel, n_coarse, pairs)
        if len(pairs2) > len(pairs):
            src = np.asarray([p for p, _ in pairs2])
            dst = np.asarray([q for _, q in pairs2])
            X1 = st.pt_xyz[src] @ st.kf_R[kf_id].T + st.kf_t[kf_id]
            X2 = st.pt_xyz[dst] @ st.kf_R[cand].T + st.kf_t[cand]
            res2 = self._ransac(X1, X2, inlier_thresh=0.25)
            if int(res2.n_inliers) >= n_coarse:
                inl2 = res2.inliers
                best = (res2.R, res2.t, int(res2.n_inliers),
                        list(zip(src[inl2].tolist(), dst[inl2].tolist())))
        R_b, t_b, n_b, pairs_b = best
        if n_b < self.min_inliers:
            return False, None, None, n_b, None
        return True, R_b, t_b, n_b, pairs_b

    # ------------------------------------------------------------------
    def _expand_pairs_projective(self, kf_id: int, cand: int, pairs,
                                 G_R, G_t, radius_px: float = 25.0,
                                 max_hamming: int = 55,
                                 cap_dst: int = 4096):
        """Sim3-guided projection: the candidate window's landmarks, mapped
        into the active world through G^-1, are projected into the current
        keyframe and matched against its keypoints in a pixel window. The
        landmark set is padded to a bucket of 2048 or 4096 (padding
        projects behind the camera)."""
        st = self.store
        dev = self.device
        covis, _ = st.covisibility(cand, min_weight=5)
        window = np.concatenate([[cand], covis[:5]]).astype(np.int64)
        dst_ids = st.points_in_kfs(window)
        dst_ids = dst_ids[st.pt_mask[dst_ids]][:cap_dst]
        if len(dst_ids) < 10:
            return pairs
        n_dst = len(dst_ids)
        db = min(_bucket(n_dst, 2048), cap_dst)
        if db > n_dst:
            dst_ids = np.concatenate(
                [dst_ids, np.full((db - n_dst,), int(dst_ids[0]),
                                  dst_ids.dtype)])
        X_act = (st.pt_xyz[dst_ids] - G_t) @ G_R
        X_act[n_dst:] = np.array([0.0, 0.0, -1e6], np.float32)
        uv, _, vis = project_points(
            self.cam, torch.from_numpy(st.kf_R[kf_id]).to(dev),
            torch.from_numpy(st.kf_t[kf_id]).to(dev),
            torch.from_numpy(X_act.astype(np.float32)).to(dev))
        kp_pt = st.kf_kp_pt[kf_id]
        n_kp = st.kf_kp_xy[kf_id].shape[0]
        idx, _ = matching.search_by_projection(
            uv, vis, _words(st.pt_desc[dst_ids], dev),
            torch.zeros((len(dst_ids),), dtype=torch.int32, device=dev),
            torch.from_numpy(st.kf_kp_xy[kf_id]).to(dev),
            _words(st.kf_kp_desc[kf_id], dev),
            torch.zeros((n_kp,), dtype=torch.int32, device=dev),
            torch.from_numpy(st.kf_kp_mask[kf_id] & (kp_pt >= 0)).to(dev),
            radius=radius_px, max_dist=max_hamming, octave_tol=8)
        idx = idx.cpu().numpy()
        hit = np.nonzero(idx >= 0)[0]
        have = set(pairs)
        out = list(pairs)
        for d_i, kp_i in zip(hit.tolist(), idx[hit].tolist()):
            src = int(kp_pt[kp_i])
            if src < 0 or not st.pt_mask[src]:
                continue
            pr = (src, int(dst_ids[d_i]))
            if pr not in have:
                have.add(pr)
                out.append(pr)
        return out

    def _expand_pairs(self, kf_id: int, cand: int, pairs, G_R, G_t,
                      radius: float = 0.4, max_hamming: int = 55,
                      cap_src: int = 1024, cap_dst: int = 4096):
        """More landmark correspondences through the drift estimate G: the
        projective expansion with a camera, else 3-D proximity of the
        active keyframe's points mapped into the candidate's world. Returns
        the union of ``pairs`` and the new (src, dst) id pairs."""
        if self.cam is not None:
            return self._expand_pairs_projective(
                kf_id, cand, pairs, G_R, G_t, max_hamming=max_hamming,
                cap_dst=cap_dst)
        st = self.store
        covis, _ = st.covisibility(cand, min_weight=5)
        window = np.concatenate([[cand], covis[:5]]).astype(np.int64)
        dst_ids = st.points_in_kfs(window)
        dst_ids = dst_ids[st.pt_mask[dst_ids]][:cap_dst]
        src_ids = st.kf_kp_pt[kf_id]
        src_ids = np.unique(src_ids[src_ids >= 0])
        src_ids = src_ids[st.pt_mask[src_ids]][:cap_src]
        if len(dst_ids) < 10 or len(src_ids) < 10:
            return pairs
        have = set(pairs)
        dst_ids = dst_ids[~np.isin(dst_ids, src_ids)]
        if len(dst_ids) < 10:
            return pairs
        Xs = st.pt_xyz[src_ids] @ G_R.T + G_t   # src mapped into cand world
        Xd = st.pt_xyz[dst_ids]
        d2 = ((Xs[:, None, :] - Xd[None, :, :]) ** 2).sum(-1)
        ham = matching.hamming(_words(st.pt_desc[src_ids], self.device),
                               _words(st.pt_desc[dst_ids], self.device))
        ham = ham.cpu().numpy()
        cost = np.where((d2 < radius * radius) & (ham <= max_hamming),
                        ham.astype(np.float32), np.inf)
        best = cost.argmin(axis=1)
        ok = np.isfinite(cost[np.arange(len(src_ids)), best])
        out = list(pairs)
        for s, b in zip(src_ids[ok].tolist(), best[ok].tolist()):
            pr = (int(s), int(dst_ids[b]))
            if pr not in have:
                have.add(pr)
                out.append(pr)
        return out

    # ------------------------------------------------------------------
    def _correct(self, kf_id: int, cand: int, R_rel, t_rel, fuse_pairs=None):
        """Essential-graph correction: a snapshot of the map's keyframe
        poses and its covisibility graph, the pose graph (chain,
        covisibility and spanning-tree edges measured from the current
        poses, and the loop edge pinning T_kf_cand to the verified relative
        pose, weighted by the edge count) with the candidate fixed, then
        the landmarks moved through their reference keyframe's pose change
        and the verified duplicates fused (the loop side's landmarks stay).
        """
        st = self.store
        dev = self.device
        with st.lock:
            live = np.sort(st.kfs_of_map(int(st.kf_map[kf_id])))
            K = len(live)
            loc = {int(k): i for i, k in enumerate(live)}
            R_before = st.kf_R[live].copy()
            t_before = st.kf_t[live].copy()
            kf_fixed = st.kf_fixed[live].copy()
            g_ei, g_ej, g_w = st.covis_graph_full(min_weight=20)

        # edges: temporal chain + covisibility + spanning tree
        pairs = [(i, i - 1) for i in range(1, K)]
        have = {tuple(sorted(p)) for p in pairs}
        lut = np.full(st.max_kf, -1, np.int64)
        lut[live] = np.arange(K)
        sel = ((lut[g_ei] >= 0) & (lut[g_ej] >= 0)) \
            if len(g_ei) else np.zeros((0,), bool)
        cov_i = lut[g_ei[sel]].astype(np.int32)
        cov_j = lut[g_ej[sel]].astype(np.int32)
        cov_w = np.asarray(g_w[sel], np.int32)
        for a, b in zip(cov_i.tolist(), cov_j.tolist()):
            key = tuple(sorted((a, b)))
            if key not in have:
                have.add(key)
                pairs.append((a, b))
        if len(cov_i):
            # symmetric edges for the parent scan
            parent = spanning_tree(np.concatenate([cov_i, cov_j]),
                                   np.concatenate([cov_j, cov_i]),
                                   np.concatenate([cov_w, cov_w]), K)
            for child in range(K):
                p = int(parent[child])
                if p >= 0 and tuple(sorted((child, p))) not in have:
                    have.add(tuple(sorted((child, p))))
                    pairs.append((child, p))
        n_pairs = len(pairs)
        pairs = torch.as_tensor(np.asarray(pairs, np.int64).reshape(-1, 2),
                                device=dev)
        R = torch.from_numpy(R_before).to(dev)
        t = torch.from_numpy(t_before).to(dev)
        s = torch.ones((K,), dtype=torch.float32, device=dev)
        eR, et, es = pose_graph.make_edges_from_poses(R, t, s, pairs)

        # loop edge S_kf_cand = T_kf_cand = (R_rel^T, -R_rel^T t_rel), from
        # the verified X_cand = R_rel X_kf + t_rel
        Rlc = torch.from_numpy(np.ascontiguousarray(R_rel.T)).to(dev)
        tlc = torch.from_numpy((-R_rel.T @ t_rel).astype(np.float32)).to(dev)
        E = n_pairs + 1
        fixed = np.zeros((K,), bool)
        fixed[loc[cand]] = True
        fixed |= kf_fixed   # frozen loaded-map keyframes never move
        prob = pose_graph.PoseGraphProblem(
            R, t, s, torch.from_numpy(fixed).to(dev),
            torch.cat([pairs[:, 0], torch.tensor([loc[kf_id]], device=dev)]),
            torch.cat([pairs[:, 1], torch.tensor([loc[cand]], device=dev)]),
            torch.cat([eR, Rlc[None]]), torch.cat([et, tlc[None]]),
            torch.cat([es, torch.ones((1,), device=dev)]),
            torch.cat([torch.ones((n_pairs,), device=dev),
                       torch.full((1,), float(E), device=dev)]),
            torch.ones((E,), dtype=torch.bool, device=dev))
        dof4_axis = None
        if self.gravity_w is not None:
            # gravity is observable: the 4-DoF graph, each vertex's update a
            # rotation about its camera-frame gravity axis a_k = R_k g_w
            g = np.asarray(self.gravity_w, np.float32)
            g = g / max(np.linalg.norm(g), 1e-9)
            dof4_axis = torch.from_numpy(np.ascontiguousarray(
                np.einsum("kij,j->ki", R_before, g), np.float32)).to(dev)
        Rn, tn, _, info = pose_graph.optimize(prob, num_iters=12, cg_iters=50,
                                              fix_scale=self.fix_scale,
                                              dof4_axis=dof4_axis)
        Rn, tn = Rn.cpu().numpy(), tn.cpu().numpy()
        info = {k: v.item() for k, v in info.items()}

        # apply: landmarks through their reference keyframe's pose change
        # (X' = T_new^-1 T_old X); only those of the corrected map move
        i_end = loc[kf_id]
        map_id = int(st.kf_map[kf_id])
        with st.lock:
            pts = np.nonzero(st.pt_mask)[0]
            ref = st.pt_ref_kf[pts]
            in_map = st.kf_map[ref] == map_id
            pts, ref = pts[in_map], ref[in_map]
            ref_loc = np.asarray([loc.get(int(r), i_end) for r in ref],
                                 dtype=np.int64)
            if len(pts):
                Xc = (np.einsum("nij,nj->ni", R_before[ref_loc], st.pt_xyz[pts])
                      + t_before[ref_loc])
                st.pt_xyz[pts] = np.einsum("nji,nj->ni", Rn[ref_loc],
                                           Xc - tn[ref_loc])
            st.version += 1
            lns = np.nonzero(st.ln_mask)[0]
            if len(lns):
                lns = lns[st.kf_map[st.ln_ref_kf[lns]] == map_id]
            if len(lns):
                lref_loc = np.asarray(
                    [loc.get(int(r), i_end) for r in st.ln_ref_kf[lns]],
                    dtype=np.int64)
                for arr in (st.ln_Xs, st.ln_Xe):
                    Xc2 = (np.einsum("nij,nj->ni", R_before[lref_loc],
                                     arr[lns]) + t_before[lref_loc])
                    arr[lns] = np.einsum("nji,nj->ni", Rn[lref_loc],
                                         Xc2 - tn[lref_loc])
            st.kf_R[live] = Rn
            st.kf_t[live] = tn
            if self.object_store is not None:
                self._move_objects(loc, R_before, t_before, Rn, tn)
            n_lines_fused = self._fuse_loop_lines(kf_id, cand)
            n_fused = 0
            for p_src, p_dst in fuse_pairs or ():
                if p_src != p_dst and st.pt_mask[p_src] and st.pt_mask[p_dst]:
                    st.replace_point(int(p_src), int(p_dst))
                    n_fused += 1
        return {"cost0": info["cost0"], "cost": info["cost"], "n_kf": K,
                "n_fused": n_fused, "n_lines_fused": n_lines_fused,
                "lm_iters": int(info["lm_iters"]),
                "cg_iters": int(info["cg_iters"])}

    def _move_objects(self, loc, R_before, t_before, Rn, tn):
        """Each detected object follows its latest observing keyframe of the
        corrected map: T_wo' = T_new^-1 T_old T_wo."""
        for rec in self.object_store.objects:
            if not rec.detected or not rec.obs:
                continue
            anchor = max((k for k in rec.obs if k in loc), default=None)
            if anchor is None:
                continue
            i = loc[anchor]
            R_rel = Rn[i].T @ R_before[i]
            t_rel = Rn[i].T @ (t_before[i] - tn[i])
            rec.R_wo = (R_rel @ rec.R_wo).astype(np.float32)
            rec.t_wo = (R_rel @ rec.t_wo + t_rel).astype(np.float32)

    # ------------------------------------------------------------------
    def _fuse_loop_lines(self, kf_id: int, cand: int,
                         endpoint_tol: float = 0.15,
                         max_hamming: int = 80) -> int:
        """Merge line-landmark duplicates between the current keyframe's
        window and the candidate's after correction (endpoint proximity,
        either endpoint order, and LBD distance through K1)."""
        st = self.store
        if st.num_lines == 0:
            return 0
        covis_c, _ = st.covisibility(cand, min_weight=5)
        win_c = np.concatenate([[cand], covis_c[:5]]).astype(np.int64)
        covis_k, _ = st.covisibility(kf_id, min_weight=5)
        win_k = np.concatenate([[kf_id], covis_k[:5]]).astype(np.int64)
        src = st.lines_in_kfs(win_k)
        src = src[st.ln_mask[src]]
        dst = st.lines_in_kfs(win_c)
        dst = dst[st.ln_mask[dst]]
        dst = dst[~np.isin(dst, src)]
        if len(src) == 0 or len(dst) == 0:
            return 0
        d2s = ((st.ln_Xs[src][:, None] - st.ln_Xs[dst][None]) ** 2).sum(-1)
        d2e = ((st.ln_Xe[src][:, None] - st.ln_Xe[dst][None]) ** 2).sum(-1)
        d2s_f = ((st.ln_Xs[src][:, None] - st.ln_Xe[dst][None]) ** 2).sum(-1)
        d2e_f = ((st.ln_Xe[src][:, None] - st.ln_Xs[dst][None]) ** 2).sum(-1)
        close = np.minimum(np.maximum(d2s, d2e), np.maximum(d2s_f, d2e_f))
        ham = matching.hamming(_words(st.ln_desc[src], self.device),
                               _words(st.ln_desc[dst], self.device))
        ham = ham.cpu().numpy()
        cost = np.where((close < endpoint_tol ** 2) & (ham <= max_hamming),
                        ham.astype(np.float32), np.inf)
        best = cost.argmin(axis=1)
        ok = np.isfinite(cost[np.arange(len(src)), best])
        n = 0
        for s_, b in zip(src[ok].tolist(), best[ok].tolist()):
            d = int(dst[b])
            if st.ln_mask[s_] and st.ln_mask[d]:
                st.replace_line(int(s_), d)
                n += 1
        return n
