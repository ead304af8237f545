"""Local mapping: landmark culling, line triangulation, neighbour fuse,
landmark maintenance, windowed local bundle adjustment and keyframe culling.

Counterpart of plvs_tpu/slam/local_mapping.py for the synchronous backend.
The covisibility window is assembled on the host from the observation
table and solved by ``solvers/ba.py`` on the mapper's device. Each stage
keeps the JAX package's dispatch / apply split as a pair of methods, driven
here in order by :meth:`LocalMapper.process_keyframe`.

Differences from the JAX package, all deliberate:

* the two device programs of the backend (line matching + triangulation
  against up to 4 neighbours, projection fuse against up to 5) run the
  neighbours stacked: one Hamming matrix (kernel K1) of the keyframe's rows
  against every neighbour's rows at once, sliced per neighbour, and the
  gates batched over neighbours, instead of a ``vmap`` over neighbour
  slices. Neighbour lists are not padded to a fixed count and problems not
  to shape buckets: PyTorch compiles nothing per shape. What the buckets
  meant beyond padding is kept: under ``fixed_shapes`` the line block of
  the local BA is present even for fewer than 4 lines;
* ``warm_ba_buckets`` has no counterpart (it precompiles XLA shapes);
* a deferred write-back (the interleaved backend applies a solve frames
  after its dispatch) skips landmark slots that were culled and reused in
  between: the JAX package checks keyframe slots by identity but points
  and lines only by liveness, and writes one landmark's solved position
  into another (``_ba_apply``).

The pass is staged as in the JAX package (``process_keyframe_stages``, a
generator with two yields); ``process_keyframe`` drains it with inline
fetches, and the System's interleaved backend steps it between frames with
helper-thread fetches. With ``abort_check`` set (the mapper actor), the
local BA runs in chunks of ``ba_chunk_iters`` LM iterations and stops after
a chunk once the check is true.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..features import lines as lines_mod
from ..features import matching
from ..geometry import cameras as cam_mod
from ..geometry import triangulation
from ..ops import resolve_device
from ..solvers import ba
from ..utils.fetch import SyncFetch, to_host
from .map_store import MapStore


def _mv(R, x):
    return (R @ x[..., None])[..., 0]


def _stacked_hamming(d1: torch.Tensor, d2b: torch.Tensor) -> torch.Tensor:
    """[Q, 8] x [B, K, 8] -> [B, Q, K]: one K1 launch on the neighbours'
    stacked rows, sliced per neighbour."""
    B, K = d2b.shape[:2]
    dist = matching.hamming(d1, d2b.reshape(B * K, 8))
    return dist.reshape(d1.shape[0], B, K).permute(1, 0, 2)


def _triangulate_lines_pair(cam, R1, t1, R2, t2, sp1, ep1, sp2, ep2, valid,
                            reproj_thresh: float = 3.0):
    """Plane-plane triangulation + verification of matched keyline pairs of
    one keyframe ([n] rows, pose R1 [3, 3], t1 [3]) against B neighbours
    (poses R2 [B, 3, 3], t2 [B, 3]; keylines sp2 / ep2 [B, n, 2]); returns
    (Xs, Xe, ok), each [B, n, ...]."""
    R2n, t2n = R2[:, None], t2[:, None]
    rays = [cam_mod.unproject(cam, uv) for uv in (sp1, ep1, sp2, ep2)]
    Xs, Xe, ok_tri, deg = triangulation.triangulate_line_planes(
        R1, t1, R2n, t2n, *rays)
    nld2 = lines_mod.line_nld(sp2, ep2)

    def resid(X):
        uv = cam_mod.project(cam, _mv(R2n, X) + t2n)
        return ((nld2[..., :2] * uv).sum(-1) + nld2[..., 2]).abs()

    seg_len = torch.linalg.norm(Xe - Xs, dim=-1)
    z1s = (_mv(R1, Xs) + t1)[..., 2]
    ok = (valid & ok_tri & (deg < 0.995)
          & (resid(Xs) < reproj_thresh) & (resid(Xe) < reproj_thresh)
          & (seg_len > 0.02) & (seg_len < 10.0 * torch.clamp(z1s, min=0.1)))
    return Xs, Xe, ok


def _triangulate_lines_multi(cam, R1, t1, d1, m1, sp1, ep1, R2b, t2b, d2b,
                             m2b, sp2b, ep2b, reproj_thresh: float = 3.0):
    """Line matching + plane-plane triangulation against B neighbour
    keyframes; returns per-neighbour (idx [B, n], Xs, Xe, ok)."""
    idx, _ = matching.match_nn_ratio_dist(_stacked_hamming(d1, d2b), m1, m2b,
                                          max_dist=90, ratio=0.85)
    ic = torch.clamp(idx, min=0)[..., None].expand(-1, -1, 2)
    Xs, Xe, ok = _triangulate_lines_pair(
        cam, R1, t1, R2b, t2b, sp1, ep1, sp2b.gather(1, ic),
        ep2b.gather(1, ic), idx >= 0, reproj_thresh)
    return idx, Xs, Xe, ok


def _fuse_match_batch(cam, R_nb, t_nb, pts_xyz, pts_desc, kp_xy, kp_desc,
                      kp_octave, kp_mask):
    """Projection-guided fuse matching of one point set ([P]) against B
    neighbour keyframes ([B, N] keypoints); returns idx [B, P]."""
    Xc = _mv(R_nb[:, None], pts_xyz[None]) + t_nb[:, None]       # [B, P, 3]
    uv = cam_mod.project(cam, Xc)
    vis = (Xc[..., 2] > 0.05) & cam_mod.in_image(cam, uv, 8.0)
    zero_oct = torch.zeros(vis.shape, dtype=torch.int32, device=vis.device)
    idx, _ = matching.search_by_projection_dist(
        _stacked_hamming(pts_desc, kp_desc), uv, vis, zero_oct, kp_xy,
        kp_octave, kp_mask, radius=3.0, max_dist=50, octave_tol=8)
    return idx


@dataclasses.dataclass
class LocalMapper:
    cam: cam_mod.Camera
    store: MapStore
    window_size: int = 8
    fixed_cap: int = 8
    scale: float = 1.2
    n_levels: int = 8
    use_lines: bool = False
    kfdb: object | None = None  # keyframe database to notify on culls
    stopwatch: object | None = None  # optional stage timing (.scope(name))
    # polled between local-BA chunks (the mapper actor sets it): True
    # stops the solve after the current chunk
    abort_check: object | None = None
    ba_chunk_iters: int = 3
    # line blocks of the local BA present even for < 4 lines (the JAX
    # package's fixed-shape backend includes them in the solve)
    fixed_shapes: bool = False
    # inertial runtime (None for visual-only maps): a keyframe of the IMU
    # chain is culled only when the merged preintegration span stays under
    # inertial_max_gap seconds, and the runtime re-chains across it
    inertial: object | None = None
    inertial_max_gap: float = 3.0
    # monocular maps grow by triangulation against covisible neighbours
    # (create_new_points); depth maps grow from depth at keyframe creation
    triangulate_new_points: bool = False
    # shards of the observation-sharded global BA (SystemConfig.
    # sharded_backend, parallel/sharded_ba.py); the windowed local BA stays
    # on one device: its problem is too small to pay for the reductions
    mesh: object | None = None
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        # one entry per local / global BA solve: the solve's info as read
        # back at its write-back, and its cameras (window + fixed observers)
        self.ba_log: list[dict] = []
        self.n_culled = 0
        # points added by each create_new_points call
        self.new_points_log: list[int] = []

    def _scope(self, name: str):
        if self.stopwatch is None:
            return contextlib.nullcontext()
        return self.stopwatch.scope(name)

    def _t(self, a) -> torch.Tensor:
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device)

    def process_keyframe(self, kf_id: int, extra_fetch=None):
        """The per-keyframe backend pass run to its end with inline fetches
        (the drain of :meth:`process_keyframe_stages`); returns the fetched
        ``extra_fetch``."""
        gen = self.process_keyframe_stages(kf_id, extra_fetch=extra_fetch)
        while True:
            try:
                next(gen)
            except StopIteration as stop:
                return stop.value

    def process_keyframe_stages(self, kf_id: int, extra_fetch=None,
                                submit=None):
        """The per-keyframe backend pass as a generator, in the JAX
        package's order: cull points and lines; on a monocular map
        triangulate new points (:meth:`create_new_points`); dispatch the line
        triangulation and the fuse matches from the store as it stands and
        yield their fetch (with ``extra_fetch``, an unrelated device output
        such as the keyframe's BoW words, fetched in the same future);
        apply lines, then fuse; point maintenance (normals and scale range
        at once, the descriptor vote dispatched); dispatch the local BA and
        yield its fetch together with the vote's; apply the BA and the
        vote; keyframe culling. ``submit`` (fn(outs) -> future) takes the
        fetches; None fetches inline. Each ``yield`` hands the caller the
        future it waits on (None when nothing was fetched), and the
        generator's value is the fetched ``extra_fetch``."""
        fetch = submit if submit is not None else SyncFetch()
        lock = self.store.lock
        with self._scope("lm.cull"), lock:
            self.cull_points(kf_id)
            if self.use_lines:
                self.cull_lines(kf_id)
        if self.triangulate_new_points:
            with self._scope("lm.tri_pts"), lock:
                self.new_points_log.append(self.create_new_points(kf_id))
        with lock:
            tri_ctx = (self._dispatch_new_lines(kf_id)
                       if self.use_lines else None)
            fuse_ctx = self._dispatch_fuse(kf_id)
        outs = [c["out"] for c in (tri_ctx, fuse_ctx) if c is not None]
        fut = (fetch((tuple(outs), extra_fetch))
               if outs or extra_fetch is not None else None)
        yield fut
        extra_out = None
        fetched = []
        if fut is not None:
            with self._scope("lm.await"):
                got, extra_out = fut.result()
            fetched = list(got)
        if tri_ctx is not None:
            with self._scope("lm.tri_lines"), lock:
                self._apply_new_lines(kf_id, tri_ctx, fetched.pop(0))
        if fuse_ctx is not None:
            with self._scope("lm.fuse"), lock:
                self._apply_fuse(kf_id, fuse_ctx, fetched.pop(0))
        with self._scope("lm.maint"), lock:
            pts = self.store.kf_kp_pt[kf_id]
            maint_ctx = self.store.dispatch_point_maintenance(
                np.unique(pts[pts >= 0]), scale=self.scale,
                n_levels=self.n_levels, device=self.device)
        with self._scope("lm.ba"):
            ba_ctx = self._ba_dispatch_local(kf_id)
        maint_out = None if maint_ctx is None else maint_ctx["out"]
        ba_out = None if ba_ctx is None else self.ba_outs(ba_ctx)
        ba_fut = (fetch((ba_out, maint_out))
                  if ba_ctx is not None or maint_ctx is not None else None)
        yield ba_fut
        if ba_fut is not None:
            with self._scope("lm.ba" if ba_ctx is not None else "lm.await"):
                solved, maint_fetched = ba_fut.result()
                if ba_ctx is not None:
                    self.ba_finish(ba_ctx, solved)
            if maint_ctx is not None:
                with self._scope("lm.maint"), lock:
                    self.store.apply_point_maintenance(maint_ctx,
                                                       maint_fetched)
        with self._scope("lm.cull_kf"), lock:
            self.cull_keyframes(kf_id)
        return extra_out

    # ------------------------------------------------------------------
    def _dispatch_new_lines(self, kf_id: int, max_neighbors: int = 4,
                            reproj_thresh: float = 3.0):
        """Dispatch half of create_new_lines: host-side neighbour
        preselection + one stacked match + triangulate program; returns a
        ctx holding the device output, or None."""
        st = self.store
        covis, _ = st.covisibility(kf_id, min_weight=10)
        if len(covis) == 0:
            return None
        m1 = st.kf_kl_mask[kf_id] & (st.kf_kl_line[kf_id] < 0)
        if m1.sum() < 2:
            return None
        R1, t1 = st.kf_R[kf_id], st.kf_t[kf_id]
        C1 = -R1.T @ t1
        # baseline + free-keyline gates
        nbs = []
        for nb in covis[:max_neighbors]:
            nb = int(nb)
            C2 = -st.kf_R[nb].T @ st.kf_t[nb]
            if np.linalg.norm(C1 - C2) < 0.01:
                continue
            if (st.kf_kl_mask[nb] & (st.kf_kl_line[nb] < 0)).sum() >= 2:
                nbs.append(nb)
        if not nbs:
            return None
        nbs = np.asarray(nbs, np.int64)
        m2b = st.kf_kl_mask[nbs] & (st.kf_kl_line[nbs] < 0)
        t = self._t
        out = _triangulate_lines_multi(
            self.cam, t(R1), t(t1), t(st.kf_kl_desc[kf_id]), t(m1),
            t(st.kf_kl_sp[kf_id]), t(st.kf_kl_ep[kf_id]), t(st.kf_R[nbs]),
            t(st.kf_t[nbs]), t(st.kf_kl_desc[nbs]), t(m2b),
            t(st.kf_kl_sp[nbs]), t(st.kf_kl_ep[nbs]), reproj_thresh)
        return {"out": out, "nbs": nbs, "m1": m1}

    def _apply_new_lines(self, kf_id: int, ctx, fetched):
        """Apply half of create_new_lines (store mutation)."""
        st = self.store
        nbs, m1 = ctx["nbs"], ctx["m1"]
        idx_b, Xs_b, Xe_b, ok_b = fetched
        taken = ~m1  # keylines already bound to a landmark
        for bi, nb in enumerate(nbs):
            idx, Xs, Xe, ok = idx_b[bi], Xs_b[bi], Xe_b[bi], ok_b[bi]
            good = np.nonzero(ok & ~taken)[0]
            if len(good) == 0:
                continue
            ln_ids = st.alloc_lines(len(good))
            st.version += 1
            st.ln_Xs[ln_ids] = Xs[good]
            st.ln_Xe[ln_ids] = Xe[good]
            st.ln_desc[ln_ids] = st.kf_kl_desc[kf_id][good]
            st.ln_mask[ln_ids] = True
            st.ln_ref_kf[ln_ids] = kf_id
            st.ln_first_kf[ln_ids] = kf_id
            st.ln_n_obs[ln_ids] = 0
            st.ln_visible[ln_ids] = 1
            st.ln_found[ln_ids] = 1
            st.add_line_observations(kf_id, ln_ids, good)
            st.add_line_observations(int(nb), ln_ids, idx[good])
            taken[good] = True

    def create_new_lines(self, kf_id: int, max_neighbors: int = 4,
                         reproj_thresh: float = 3.0):
        """Triangulate new line landmarks between the new keyframe and its
        covisible neighbours by plane-plane intersection."""
        ctx = self._dispatch_new_lines(kf_id, max_neighbors, reproj_thresh)
        if ctx is not None:
            self._apply_new_lines(kf_id, ctx, to_host(ctx["out"]))

    # ------------------------------------------------------------------
    def create_new_points(self, kf_id: int, max_neighbors: int = 5) -> int:
        """Triangulate new points between the keyframe and its (at most 5)
        covisible neighbours, in the JAX package's order: per neighbour the
        baseline check, the epipolar-gated matches of the keypoints without
        a point (K1), two-ray triangulation, then one read of the gates'
        inputs and the gates — reprojection under 5.991 px^2 in both views,
        depth over 0.05 in both, parallax cosine under 0.9998. Returns the
        number of points added."""
        st = self.store
        covis, _ = st.covisibility(kf_id, min_weight=10)
        if len(covis) == 0:
            return 0
        m1 = st.kf_kp_mask[kf_id] & (st.kf_kp_pt[kf_id] < 0)
        if m1.sum() < 10:
            return 0
        rays1_full = cam_mod.unproject(self.cam, self._t(st.kf_kp_xy[kf_id]))
        desc1 = self._t(st.kf_kp_desc[kf_id])
        R1, t1 = st.kf_R[kf_id], st.kf_t[kf_id]
        n_added = 0
        for nb in covis[:max_neighbors]:
            nb = int(nb)
            C1 = -R1.T @ t1
            C2 = -st.kf_R[nb].T @ st.kf_t[nb]
            if np.linalg.norm(C1 - C2) < 1e-3:
                continue
            m2 = st.kf_kp_mask[nb] & (st.kf_kp_pt[nb] < 0)
            rays2_full = cam_mod.unproject(self.cam, self._t(st.kf_kp_xy[nb]))
            R12 = R1 @ st.kf_R[nb].T                 # x1 = R12 x2 + t12
            t12 = t1 - R12 @ st.kf_t[nb]
            idx, _ = matching.search_for_triangulation(
                desc1, self._t(m1), rays1_full, self._t(st.kf_kp_desc[nb]),
                self._t(m2), rays2_full, self._t(R12), self._t(t12),
                epi_thresh=2.0 / float(self.cam.fx))
            idx = idx.cpu().numpy()
            sel = np.nonzero(idx >= 0)[0]
            if len(sel) == 0:
                continue
            n = len(sel)
            ra = rays1_full[self._t(sel)]
            rb = rays2_full[self._t(idx[sel])]

            def rep(a):
                a = self._t(a)
                return a.expand((n,) + tuple(a.shape))

            Xw, valid = triangulation.triangulate_points_world(
                rep(R1), rep(t1), rep(st.kf_R[nb]), rep(st.kf_t[nb]), ra, rb)
            cosp = triangulation.parallax_cos(ra, rb, rep(R12))
            Xc1 = Xw @ self._t(R1).T + self._t(t1)
            Xc2 = Xw @ self._t(st.kf_R[nb]).T + self._t(st.kf_t[nb])
            uv1, uv2, valid, cosp, z1, z2, Xw = to_host(
                (cam_mod.project(self.cam, Xc1), cam_mod.project(self.cam, Xc2),
                 valid, cosp, Xc1[:, 2], Xc2[:, 2], Xw))
            e1 = np.sum((uv1 - st.kf_kp_xy[kf_id][sel]) ** 2, -1)
            e2 = np.sum((uv2 - st.kf_kp_xy[nb][idx[sel]]) ** 2, -1)
            ok = (valid & (cosp < 0.9998) & (z1 > 0.05) & (z2 > 0.05)
                  & (e1 < 5.991) & (e2 < 5.991))
            good = np.nonzero(ok)[0]
            if len(good) == 0:
                continue
            pt_ids = st.alloc_pts(len(good))
            st.version += 1
            st.pt_xyz[pt_ids] = Xw[good]
            st.pt_desc[pt_ids] = st.kf_kp_desc[kf_id][sel[good]]
            st.pt_mask[pt_ids] = True
            st.pt_ref_kf[pt_ids] = kf_id
            st.pt_first_kf[pt_ids] = kf_id
            st.pt_visible[pt_ids] = 1
            st.pt_found[pt_ids] = 1
            st.add_observations(kf_id, pt_ids, sel[good])
            st.add_observations(nb, pt_ids, idx[sel[good]])
            m1 = st.kf_kp_mask[kf_id] & (st.kf_kp_pt[kf_id] < 0)
            n_added += len(good)
        return n_added

    # ------------------------------------------------------------------
    def _dispatch_fuse(self, kf_id: int, max_neighbors: int = 5):
        """Dispatch half of the neighbour fuse: every neighbour matched in
        one stacked program; returns a ctx or None."""
        st = self.store
        covis, _ = st.covisibility(kf_id, min_weight=10)
        if len(covis) == 0:
            return None
        my_pts = st.kf_kp_pt[kf_id]
        pts = my_pts[my_pts >= 0]
        if len(pts) == 0:
            return None
        nbs = covis[:max_neighbors].astype(np.int64)
        t = self._t
        out = _fuse_match_batch(
            self.cam, t(st.kf_R[nbs]), t(st.kf_t[nbs]), t(st.pt_xyz[pts]),
            t(st.pt_desc[pts]), t(st.kf_kp_xy[nbs]), t(st.kf_kp_desc[nbs]),
            t(st.kf_kp_octave[nbs]), t(st.kf_kp_mask[nbs]))
        return {"out": out, "nbs": nbs, "pts": pts}

    def _apply_fuse(self, kf_id: int, ctx, fetched):
        """Apply half of the neighbour fuse, merging duplicate landmarks: a
        Python loop over the hits, as in the JAX package (its order decides
        which landmark survives a merge)."""
        st = self.store
        nbs, pts = ctx["nbs"], ctx["pts"]
        for bi, nb in enumerate(nbs):
            idx = fetched[bi]
            for h in np.nonzero(idx >= 0)[0]:
                p = int(pts[h])
                other = int(st.kf_kp_pt[nb, idx[h]])
                if other < 0:
                    # new observation of p in the neighbour
                    if st.pt_mask[p]:
                        st.add_observations(nb, np.asarray([p]),
                                            np.asarray([idx[h]]))
                elif other != p and st.pt_mask[p] and st.pt_mask[other]:
                    if st.pt_n_obs[p] >= st.pt_n_obs[other]:
                        st.replace_point(other, p)
                    else:
                        st.replace_point(p, other)

    # ------------------------------------------------------------------
    def cull_keyframes(self, kf_id: int):
        """Remove redundant keyframes: over 90% of their landmarks observed
        by 4 or more keyframes."""
        st = self.store
        covis, _ = st.covisibility(kf_id, min_weight=10)
        okf, opt, _ = st.live_obs()
        iner = self.inertial
        iner_active = iner is not None and len(iner.kf_chain) > 0
        for kc in covis:
            kc = int(kc)
            if kc == 0 or kc == kf_id or st.kf_fixed[kc]:
                continue
            pts = opt[okf == kc]
            if len(pts) < 20:
                continue
            if (st.pt_n_obs[pts] >= 4).mean() > 0.9:
                if iner_active:
                    gap = iner.max_cull_gap(kc)
                    if gap is None or gap > self.inertial_max_gap:
                        continue
                st.remove_keyframe(kc)
                if iner_active:
                    iner.remove_keyframe(kc)
                self.n_culled += 1
                if self.kfdb is not None:
                    self.kfdb.remove(kc)

    def cull_lines(self, kf_id: int):
        """Line-landmark culling (MapLineCulling)."""
        st = self.store
        lns = np.nonzero(st.ln_mask)[0]
        if len(lns) == 0:
            return
        ratio = st.ln_found[lns] / np.maximum(st.ln_visible[lns], 1)
        age = kf_id - st.ln_first_kf[lns]
        bad = (ratio < 0.25) & (st.ln_visible[lns] >= 8)
        bad |= (age >= 4) & (st.ln_n_obs[lns] <= 1) & (st.ln_visible[lns] >= 6)
        st.remove_lines(lns[bad])

    def cull_points(self, kf_id: int):
        """Remove unreliable recent points: found / visible under 0.25, or
        too few observations a few keyframes after creation; never the
        landmarks of a frozen keyframe."""
        st = self.store
        pts = np.nonzero(st.pt_mask)[0]
        if len(pts) == 0:
            return
        ratio = st.pt_found[pts] / np.maximum(st.pt_visible[pts], 1)
        age = kf_id - st.pt_first_kf[pts]
        bad = (ratio < 0.25) & (st.pt_visible[pts] >= 8)
        bad |= (age >= 3) & (st.pt_n_obs[pts] <= 1) & (st.pt_visible[pts] >= 6)
        ref = np.clip(st.pt_ref_kf[pts], 0, st.max_kf - 1)
        bad &= ~st.kf_fixed[ref]
        st.remove_points(pts[bad])

    # ------------------------------------------------------------------
    def local_ba(self, kf_id: int):
        """The windowed local BA of a new keyframe (5 LM x 14 CG) and its
        write-back; returns the solve's info (host), or None when the
        window yields no problem."""
        return self._solve(self._ba_dispatch_local(kf_id))

    def _ba_dispatch_local(self, kf_id: int):
        st = self.store
        covis, _ = st.covisibility(kf_id, min_weight=10)
        window = np.concatenate(
            [[kf_id], covis[: self.window_size]]).astype(np.int64)
        return self._ba_dispatch(window, num_iters=5, cg_iters=14)

    def global_ba(self, map_id: int | None = None, num_iters: int = 10):
        """Bundle adjustment over every live keyframe of a map (all free;
        the gauge anchor is the oldest keyframe when no out-of-window
        observer exists)."""
        st = self.store
        if map_id is None:
            map_id = st.active_map
        window = np.sort(st.kfs_of_map(map_id)).astype(np.int64)
        return self._window_ba(window, num_iters=num_iters,
                               use_mesh=self.mesh is not None)

    def global_ba_dispatch(self, map_id: int | None = None,
                           num_iters: int = 10):
        """Dispatch half of the global BA after a loop closure: every live
        keyframe of the map (10 LM x 30 CG); pass the ctx to :meth:`_solve`,
        or fetch its :meth:`ba_outs` and pass them to :meth:`ba_finish`."""
        st = self.store
        if map_id is None:
            map_id = st.active_map
        window = np.sort(st.kfs_of_map(map_id)).astype(np.int64)
        return self._ba_dispatch(window, num_iters=num_iters, cg_iters=30,
                                 use_mesh=self.mesh is not None)

    def _window_ba(self, window: np.ndarray, num_iters: int = 6,
                   cg_iters: int = 30, use_mesh: bool = False):
        """Windowed LM solve and its write-back."""
        return self._solve(self._ba_dispatch(window, num_iters=num_iters,
                                             cg_iters=cg_iters,
                                             use_mesh=use_mesh))

    def _solve(self, ctx):
        """Fetch a dispatched solve (its only host read) and apply it."""
        if ctx is None:
            return None
        return self.ba_finish(ctx, to_host(self.ba_outs(ctx)))

    @staticmethod
    def ba_outs(ctx):
        """What a dispatched solve's write-back fetches: the solved blocks
        and the cost, and the solve's info."""
        return ctx["outs"], ctx["info"]

    def ba_finish(self, ctx, fetched):
        """Write-back half of a dispatched solve from its fetched
        :meth:`ba_outs`: log the info, apply the blocks under the store
        lock; returns the info."""
        solved, info = fetched
        info = {k: np.asarray(v).item() for k, v in info.items()}
        info["window"] = ctx["cams"][: ctx["K"]].tolist()
        self.ba_log.append(info)
        with self.store.lock:
            self._ba_apply(ctx, solved)
        return info

    def _ba_dispatch(self, window: np.ndarray, num_iters: int = 6,
                     cg_iters: int = 30, use_mesh: bool = False,
                     schur: bool = False):
        """Dispatch half of the windowed LM solve: snapshot the window,
        queue every LM iteration on the device, return a ctx whose "outs"
        are the solved blocks and the cost. With ``abort_check`` set the
        iterations run in chunks of ``ba_chunk_iters`` (each chunk a fresh
        LM from the last one's blocks, as in the JAX package), and the
        solve stops after a chunk once the check is true. ``use_mesh``
        runs the observation-sharded solve over ``mesh``; ``schur`` the
        direct Schur preconditioner (``ba.bundle_adjust(schur_direct=
        True)``)."""
        with self.store.lock:
            packed = self._gather_ba(window)
            if packed is None:
                return None
            prob, cams, pts, lns, fixed_mask, K = packed
            st = self.store
            # slot identity at dispatch: an apply must not write a slot
            # culled and reused by another keyframe or landmark in between
            ident = {"cam_fid": st.kf_frame_id[cams].copy(),
                     "pt_gen": st.pt_gen[pts].copy(),
                     "ln_gen": st.ln_gen[lns].copy()}
        done, infos = 0, []
        while done < num_iters:
            it = (num_iters - done if self.abort_check is None
                  else min(self.ba_chunk_iters, num_iters - done))
            if use_mesh:
                from ..parallel import sharded_ba

                R, t, p, lXs, lXe, info = sharded_ba.bundle_adjust_sharded(
                    self.cam, prob, self.mesh, num_iters=it,
                    cg_iters=cg_iters)
            elif schur:
                R, t, p, lXs, lXe, info = ba.bundle_adjust(
                    self.cam, prob, num_iters=it, cg_iters=cg_iters,
                    schur_direct=True)
            else:
                R, t, p, lXs, lXe, info = ba.bundle_adjust(
                    self.cam, prob, num_iters=it, cg_iters=cg_iters)
            prob = prob._replace(R=R, t=t, points=p, lines_Xs=lXs,
                                 lines_Xe=lXe)
            infos.append(info)
            done += it
            if self.abort_check is not None and self.abort_check():
                break
        if len(infos) > 1:
            info = dict(info, cost0=infos[0]["cost0"])
            for k in ("lm_iters", "cg_iters"):
                if k in info:
                    info[k] = sum(i[k] for i in infos)
        return {"outs": (prob.R, prob.t, prob.points, prob.lines_Xs,
                         prob.lines_Xe, info["cost"]), "info": info,
                "cams": cams, "pts": pts, "lns": lns, "fixed": fixed_mask,
                "K": K, **ident}

    def _ba_apply(self, ctx, solved):
        """Apply half: write the solved blocks back (caller holds the store
        lock). A non-finite cost applies nothing. Slots whose identity
        changed since the dispatch are left alone: a keyframe slot culled
        and reused (its frame id), a point or line slot culled and
        reallocated to another landmark (its generation)."""
        Rn, tn, pn, lXs, lXe, cost = solved
        if not np.isfinite(float(cost)):
            return
        fixed = ctx["fixed"]
        st = self.store
        cams, pts, lns, K = ctx["cams"], ctx["pts"], ctx["lns"], ctx["K"]
        stale = (~st.kf_mask[cams]) | (st.kf_frame_id[cams] != ctx["cam_fid"])
        if stale.any():
            fixed = fixed | stale
            if fixed.all():
                return
        free = ~fixed
        st.kf_R[cams[free]] = Rn[:K][free]
        st.kf_t[cams[free]] = tn[:K][free]
        alive = st.pt_mask[pts] & (st.pt_gen[pts] == ctx["pt_gen"])
        st.version += 1
        st.pt_xyz[pts[alive]] = pn[: len(pts)][alive]
        if len(lns):
            lalive = st.ln_mask[lns] & (st.ln_gen[lns] == ctx["ln_gen"])
            st.ln_Xs[lns[lalive]] = lXs[: len(lns)][lalive]
            st.ln_Xe[lns[lalive]] = lXe[: len(lns)][lalive]

    def _gather_ba(self, window: np.ndarray):
        """Snapshot the window problem (caller holds the lock); returns
        (prob, cams, pts, lns, fixed_mask, K) or None."""
        st = self.store
        if len(window) < 2:
            return None
        pts = st.points_in_kfs(window)
        pts = pts[st.pt_mask[pts]]
        if len(pts) < 20:
            return None
        okf, opt, okp = st.live_obs()
        in_pts = np.isin(opt, pts)
        obs_kfs_of_pts = np.unique(okf[in_pts])
        fixed = np.setdiff1d(obs_kfs_of_pts, window)[: self.fixed_cap]
        cams = np.concatenate([window, fixed])
        K = len(cams)
        kf_local = np.full(st.max_kf, -1, np.int64)
        kf_local[cams] = np.arange(K)
        pt_local = np.full(st.max_pts, -1, np.int64)
        pt_local[pts] = np.arange(len(pts))
        sel = in_pts & np.isin(okf, cams)
        o_kf, o_pt, o_kp = okf[sel], opt[sel], okp[sel]
        if len(o_kf) < 40:
            return None

        # fixed: out-of-window observers, frozen keyframes, and the oldest
        # window keyframe when no external anchor exists (the gauge)
        fixed_mask = np.zeros((K,), bool)
        fixed_mask[len(window):] = True
        fixed_mask |= st.kf_fixed[cams]
        if len(fixed) == 0 and not fixed_mask.any():
            fixed_mask[np.argmin(st.kf_frame_id[window])] = True
        if fixed_mask.all():
            return None

        octv = st.kf_kp_octave[o_kf, o_kp].astype(np.float32)
        t = self._t
        cols = dict(
            R=t(st.kf_R[cams]), t=t(st.kf_t[cams]), fixed_cam=t(fixed_mask),
            points=t(st.pt_xyz[pts]), obs_cam=t(kf_local[o_kf]),
            obs_pt=t(pt_local[o_pt]), obs_uvr=t(st.kf_kp_uvr[o_kf, o_kp]),
            obs_inv_sigma2=t((self.scale ** (-2.0 * octv)).astype(
                np.float32)),
            obs_mask=t(np.ones(len(o_kf), bool)))
        lns = np.zeros((0,), np.int64)
        if self.use_lines and (st.num_lines > 0 or self.fixed_shapes):
            lns = st.lines_in_kfs(window)
            lns = lns[st.ln_mask[lns]]
            # single-observation lines stay at their creation geometry
            lns = lns[st.ln_n_obs[lns] >= 2]
            lkf, lln, lkl = st.live_line_obs()
            lsel = np.isin(lln, lns) & np.isin(lkf, cams)
            lo_kf, lo_ln, lo_kl = lkf[lsel], lln[lsel], lkl[lsel]
            if (len(lns) >= 4 and len(lo_kf) >= 8) or self.fixed_shapes:
                ln_local = np.full(st.max_lines, -1, np.int64)
                ln_local[lns] = np.arange(len(lns))
                sp = st.kf_kl_sp[lo_kf, lo_kl]
                ep = st.kf_kl_ep[lo_kf, lo_kl]
                dvec = ep - sp
                nrm = np.stack([-dvec[:, 1], dvec[:, 0]], -1)
                nrm = nrm / np.maximum(
                    np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-9)
                nld = np.concatenate(
                    [nrm, -np.sum(nrm * sp, -1, keepdims=True)], -1)
                # length-scaled information (short segments carry more
                # angular noise on the inferred infinite line)
                mlen = np.linalg.norm(ep - sp, axis=-1)
                cols.update(
                    lines_Xs=t(st.ln_Xs[lns]), lines_Xe=t(st.ln_Xe[lns]),
                    line_mask=t(np.ones(len(lns), bool)),
                    lobs_cam=t(kf_local[lo_kf]), lobs_line=t(ln_local[lo_ln]),
                    lobs_nld=t(nld.astype(np.float32)),
                    lobs_inv_sigma2=t(np.clip((mlen / 40.0) ** 2, 0.1,
                                              4.0).astype(np.float32)),
                    lobs_mask=t(np.ones(len(lo_kf), bool)),
                    lobs_depth=t(st.kf_kl_depth[lo_kf, lo_kl]))
            else:
                lns = np.zeros((0,), np.int64)
        return ba.make_problem(**cols), cams, pts, lns, fixed_mask, K
