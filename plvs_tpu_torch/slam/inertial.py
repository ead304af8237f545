"""Inertial runtime: IMU sample queue, state prediction, the staged
initialization and the VI local BA window.

Counterpart of plvs_tpu/slam/inertial.py (the reference's
Tracking::GrabImuData / PreintegrateIMU / PredictStateIMU,
LocalMapping::InitializeIMU and LocalInertialBA). The host queues raw
samples; each frame gap and each keyframe gap is preintegrated on the
runtime's device; the initialization is the inertial-only Gauss-Newton
solve over the keyframe chain; once initialized, each keyframe's temporal
window is refined by the VI bundle adjustment. On a monocular map
(``fix_scale=False``) the initialization also estimates the metric scale
and multiplies the whole map by it (``MapStore.rescale_map``); the factor
waits in ``consume_scale_correction`` for the System, which mirrors it
onto the tracker and the trajectories.

One difference from the JAX package, deliberate: the one-entry cache of a
frame gap's bias-corrected deltas is keyed on the preintegration object
and on a bias generation, bumped wherever ``bias_gyro`` or ``bias_acc`` is
written. The JAX cache keys on the preintegration alone, so after a bias
update it keeps returning deltas corrected to the old bias (ADVICE.md).

A store the mapper actor shares is read and written under its lock.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..features import lines as lines_mod
from ..imu import initialization as imu_init
from ..imu import preintegration as pre
from ..ops import resolve_device
from ..solvers import vi_ba


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _read_flat(tensors):
    """Several float tensors -> numpy arrays of their shapes, read back
    with one device-to-host copy."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    host = flat.cpu().numpy()
    out, i = [], 0
    for t in tensors:
        n = t.numel()
        out.append(host[i:i + n].reshape(tuple(t.shape)))
        i += n
    return out


@dataclasses.dataclass
class InertialRuntime:
    calib: pre.ImuCalib = dataclasses.field(default_factory=pre.ImuCalib)
    R_cb: np.ndarray = dataclasses.field(
        default_factory=lambda: np.eye(3, dtype=np.float32))
    t_cb: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    init_min_kfs: int = 6
    init_min_time: float = 1.5      # s of preintegrated data before init
    init_refine_until: float = 6.0  # re-estimate until this much data
    # per-frame pose prior: uncertainty of the finite-differenced velocity
    # and floors for the pose (the position prior stays weak, the gyro's
    # rotation prior tight)
    prior_vel_sigma: float = 0.15   # m/s
    prior_pos_floor: float = 0.005  # m
    prior_rot_floor: float = 0.002  # rad
    per_frame_prior: bool = True
    # stereo / RGB-D maps are metric; a monocular map's scale is a free
    # variable of the initialization, and the whole map is rescaled
    fix_scale: bool = True
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.samples: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.kf_preint: dict[int, pre.Preintegrated] = {}  # since prev KF
        self.kf_chain: list[int] = []
        self.kf_velocity: dict[int, np.ndarray] = {}
        # raw window behind each kf_preint entry: (t0, [(t, gyro, acc)])
        self.kf_raw: dict[int, tuple[float, list]] = {}
        self._bias_gen = 0
        self.bias_gyro = np.zeros(3, np.float32)
        self.bias_acc = np.zeros(3, np.float32)
        self.gravity: np.ndarray | None = None  # None until initialized
        self._cur_velocity: np.ndarray | None = None
        self._last_pose: tuple[float, np.ndarray] | None = None
        # (preintegration, bias generation, host deltas)
        self._deltas_cache: tuple | None = None
        # one dict per VI BA solve (cost0, cost, lm_iters, cg_iters, K)
        self.vi_ba_log: list[dict] = []
        # scale the last (re-)initialization multiplied the map by, for the
        # System to mirror onto the tracker and the trajectories
        self._pending_scale: float | None = None

    def consume_scale_correction(self) -> float | None:
        """The scale factor the map was just multiplied by (None if none)."""
        s, self._pending_scale = self._pending_scale, None
        return s

    # the biases: every write starts a new generation of the deltas cache
    @property
    def bias_gyro(self) -> np.ndarray:
        return self._bias_gyro

    @bias_gyro.setter
    def bias_gyro(self, v):
        self._bias_gyro = v
        self._bias_gen += 1

    @property
    def bias_acc(self) -> np.ndarray:
        return self._bias_acc

    @bias_acc.setter
    def bias_acc(self, v):
        self._bias_acc = v
        self._bias_gen += 1

    @property
    def initialized(self) -> bool:
        return self.gravity is not None

    # ------------------------------------------------------------------
    def add_samples(self, samples):
        """samples: iterable of (t, gyro[3], acc[3])."""
        for t, w, a in samples:
            s = (float(t), np.asarray(w, np.float32),
                 np.asarray(a, np.float32))
            self.samples.append(s)

    def preintegrate_frame_gap(self, t0: float, t1: float):
        """Preintegrate the samples in (t0, t1], or None for fewer than 2."""
        sel = [(t, w, a) for t, w, a in self.samples if t0 < t <= t1]
        return self._preintegrate_raw(t0, sel)

    def _preintegrate_raw(self, t0: float, sel):
        if len(sel) < 2:
            return None
        gy = np.stack([s[1] for s in sel]).astype(np.float32)
        ac = np.stack([s[2] for s in sel]).astype(np.float32)
        ts = np.asarray([s[0] for s in sel])
        dts = np.diff(ts, prepend=t0).astype(np.float32)
        host = np.concatenate([gy, ac, dts[:, None], np.broadcast_to(
            np.concatenate([self.bias_gyro, self.bias_acc])[None],
            (len(sel), 6))], 1).astype(np.float32)
        d = torch.from_numpy(host).to(self.device)   # one upload
        return pre.preintegrate(d[:, 0:3], d[:, 3:6], d[:, 6], d[0, 7:10],
                                d[0, 10:13], self.calib)

    # ------------------------------------------------------------------
    def _fetch_deltas(self, p: pre.Preintegrated):
        """(dR, dV, dP, dT, cov) of ``p`` at the current bias as host
        arrays, read back once and cached for the other consumers of the
        same gap while the bias stays the same."""
        c = self._deltas_cache
        if c is not None and c[0] is p and c[1] == self._bias_gen:
            return c[2]
        out = tuple(_read_flat(pre.deltas(p, self.bias_gyro,
                                          self.bias_acc)))
        self._deltas_cache = (p, self._bias_gen, out)
        return out

    def predict_rotation(self, R_cw: np.ndarray, p) -> np.ndarray:
        """Gyro-only camera rotation prediction: R_cw' = R_cb dR^T R_bc
        R_cw."""
        dR = self._fetch_deltas(p)[0]
        R_bw = self.R_cb.T @ R_cw
        return (self.R_cb @ (dR.T @ R_bw)).astype(np.float32)

    def note_frame_pose(self, R_cw: np.ndarray, t_cw: np.ndarray,
                        timestamp: float) -> None:
        """Refresh the velocity estimate from consecutive tracked camera
        centres."""
        C = (-R_cw.T @ t_cw).astype(np.float32)
        if self._last_pose is not None:
            t0, C0 = self._last_pose
            dt = timestamp - t0
            if 1e-4 < dt < 1.0:
                self._cur_velocity = ((C - C0) / dt).astype(np.float32)
        self._last_pose = (timestamp, C)

    def predict_state(self, R_cw: np.ndarray, t_cw: np.ndarray, p):
        """Propagate the body state through the bias-corrected gap under
        the estimated gravity and map it back to a camera pose; (R_cw',
        t_cw') or None before initialization or a velocity estimate."""
        if not self.initialized or self._cur_velocity is None:
            return None
        dR, dV, dP, dT, _ = self._fetch_deltas(p)
        dT = float(dT)
        R_bc = self.R_cb.T
        t_bc = -R_bc @ self.t_cb
        R_bw = R_bc @ R_cw
        t_bw = R_bc @ t_cw + t_bc
        R_wb = R_bw.T
        p_wb = -R_wb @ t_bw
        v = self._cur_velocity
        g = self.gravity
        R_wb2 = R_wb @ dR
        p_wb2 = p_wb + v * dT + 0.5 * g * dT * dT + R_wb @ dP
        self._cur_velocity = (v + g * dT + R_wb @ dV).astype(np.float32)
        R_bw2 = R_wb2.T
        t_bw2 = -R_bw2 @ p_wb2
        return ((self.R_cb @ R_bw2).astype(np.float32),
                (self.R_cb @ t_bw2 + self.t_cb).astype(np.float32))

    def pose_prior_info(self, p) -> np.ndarray:
        """[6, 6] information of the SE3 prior at the IMU-predicted camera
        pose: position from the dp block plus the velocity uncertainty over
        the gap, rotation from the dtheta block, isotropic per block."""
        _, _, _, dT, C = self._fetch_deltas(p)
        dT = float(dT)
        var_rot = float(np.trace(C[0:3, 0:3])) / 3.0 + self.prior_rot_floor ** 2
        var_pos = (float(np.trace(C[6:9, 6:9])) / 3.0
                   + (self.prior_vel_sigma * dT) ** 2
                   + self.prior_pos_floor ** 2)
        info = np.zeros((6, 6), np.float32)
        info[0, 0] = info[1, 1] = info[2, 2] = 1.0 / var_pos
        info[3, 3] = info[4, 4] = info[5, 5] = 1.0 / var_rot
        return info

    # ------------------------------------------------------------------
    def _total_time(self) -> float:
        return float(sum((raw[-1][0] - t0)
                         for t0, raw in self.kf_raw.values() if raw))

    def on_keyframe(self, kf_id: int, t_prev_kf: float | None, t_kf: float,
                    store) -> None:
        """Record the preintegration over (previous keyframe, this one], then
        run the staged initialization when its thresholds are met (under
        the store's lock: the mapper actor culls keyframes of the chain)."""
        with store.lock:
            self._on_keyframe_locked(kf_id, t_prev_kf, t_kf, store)

    def _on_keyframe_locked(self, kf_id, t_prev_kf, t_kf, store):
        if kf_id in self.kf_chain:
            # slot reuse after keyframe culling: drop the stale history
            i = self.kf_chain.index(kf_id)
            for k in self.kf_chain[i:]:
                self.kf_preint.pop(k, None)
                self.kf_raw.pop(k, None)
            self.kf_chain = self.kf_chain[:i]
        if t_prev_kf is not None:
            sel = [(t, w, a) for t, w, a in self.samples
                   if t_prev_kf < t <= t_kf]
            p = self._preintegrate_raw(t_prev_kf, sel)
            if p is not None:
                self.kf_preint[kf_id] = p
                self.kf_raw[kf_id] = (t_prev_kf, sel)
        self.kf_chain.append(kf_id)
        self.samples = [s for s in self.samples if s[0] > t_kf - 0.5]
        total_t = self._total_time()
        if len(self.kf_chain) >= self.init_min_kfs and (
                (not self.initialized and total_t >= self.init_min_time)
                or (self.initialized and total_t < self.init_refine_until)):
            self._try_initialize(store)

    def max_cull_gap(self, kc: int) -> float | None:
        """The merged preintegration span (t_next - t_prev) that culling
        ``kc`` would create, or None if kc is not an interior chain node."""
        if kc not in self.kf_chain:
            return None
        i = self.kf_chain.index(kc)
        if i == 0 or i >= len(self.kf_chain) - 1:
            return None
        nxt = self.kf_chain[i + 1]
        if kc not in self.kf_raw or nxt not in self.kf_raw:
            return None
        t_prev = self.kf_raw[kc][0]
        raw_n = self.kf_raw[nxt][1]
        t_next = raw_n[-1][0] if raw_n else t_prev
        return float(t_next - t_prev)

    def remove_keyframe(self, kc: int) -> bool:
        """Re-chain across a culled keyframe: the next node's
        preintegration becomes the exact re-integration of the concatenated
        raw windows (prev, kc] + (kc, next]."""
        if kc not in self.kf_chain:
            return False
        i = self.kf_chain.index(kc)
        if 0 < i < len(self.kf_chain) - 1:
            nxt = self.kf_chain[i + 1]
            if kc in self.kf_raw and nxt in self.kf_raw:
                t_prev, raw_a = self.kf_raw[kc]
                merged = raw_a + self.kf_raw[nxt][1]
                p = self._preintegrate_raw(t_prev, merged)
                if p is not None:
                    self.kf_preint[nxt] = p
                    self.kf_raw[nxt] = (t_prev, merged)
        self.kf_chain.pop(i)
        self.kf_preint.pop(kc, None)
        self.kf_raw.pop(kc, None)
        self.kf_velocity.pop(kc, None)
        return True

    # ------------------------------------------------------------------
    def _body_pose(self, R_cw, t_cw):
        """Camera pose -> body pose (R_wb, p_wb): T_bw = T_bc T_cw."""
        R_bc = self.R_cb.T
        t_bc = -R_bc @ self.t_cb
        R_bw = R_bc @ R_cw
        t_bw = R_bc @ t_cw + t_bc
        return R_bw.T, -R_bw.T @ t_bw

    def _try_initialize(self, store) -> bool:
        """Gravity / bias / velocity estimation over the keyframe chain."""
        with store.lock:
            chain = [k for k in self.kf_chain if store.kf_mask[k]]
            pairs = [(a, b) for a, b in zip(chain[:-1], chain[1:])
                     if b in self.kf_preint]
            if len(pairs) < self.init_min_kfs - 1:
                return False
            kfs = [pairs[0][0]] + [b for _, b in pairs]
            R_wb, p_wb = [], []
            for k in kfs:
                R_cw = store.kf_R[k]
                R_wb.append((R_cw.T @ self.R_cb).astype(np.float32))
                p_wb.append(self._body_pose(R_cw, store.kf_t[k])[1]
                            .astype(np.float32))
        out = imu_init.inertial_only_optimize_padded(
            np.stack(R_wb), np.stack(p_wb),
            [self.kf_preint[b] for _, b in pairs], fix_scale=self.fix_scale)
        g, bg, ba, vel, scale = _read_flat((out.gravity, out.bias_gyro,
                                            out.bias_acc, out.velocities,
                                            out.scale))
        if not np.isfinite(g).all():
            return False
        if not self.fix_scale:
            # a monocular map: apply the estimated metric scale to all of it
            # (re-initializations refine it toward 1)
            s = float(scale)
            if not np.isfinite(s) or not (0.05 < s < 20.0):
                return False
            if abs(s - 1.0) > 1e-3:
                store.rescale_map(s)
                self._pending_scale = (self._pending_scale or 1.0) * s
        self.gravity = g
        self.bias_gyro = bg
        self.bias_acc = ba
        for k, v in zip(kfs, vel):
            self.kf_velocity[k] = v.astype(np.float32)
        return True

    # ------------------------------------------------------------------
    def vi_local_ba(self, cam, store, kf_id: int, window: int = 8) -> bool:
        """VI BA over the temporal keyframe window ending at ``kf_id`` (run
        under the store's lock)."""
        if not self.initialized:
            return False
        with store.lock:
            return self._vi_local_ba_locked(cam, store, kf_id, window)

    def _vi_local_ba_locked(self, cam, store, kf_id: int, window: int):
        dev = self.device
        chain = [k for k in self.kf_chain if store.kf_mask[k]]
        if kf_id not in chain:
            return False
        end = chain.index(kf_id)
        kfs = chain[max(0, end - window + 1): end + 1]
        if len(kfs) < 3:
            return False
        pres, pmask = [], []
        for a, b in zip(kfs[:-1], kfs[1:]):
            if b in self.kf_preint:
                pres.append(self.kf_preint[b])
                pmask.append(True)
            else:
                pres.append(pre.Preintegrated(*(torch.zeros_like(x) for x in
                                                next(iter(
                                                    self.kf_preint.values())))))
                pmask.append(False)
        K = len(kfs)
        R_wb = np.zeros((K, 3, 3), np.float32)
        p_wb = np.zeros((K, 3), np.float32)
        v_w = np.zeros((K, 3), np.float32)
        for i, k in enumerate(kfs):
            R_wb[i], p_wb[i] = self._body_pose(store.kf_R[k], store.kf_t[k])
            v_w[i] = self.kf_velocity.get(k, np.zeros(3, np.float32))

        # visual observations of the window
        okf, opt, okp = store.live_obs()
        sel = np.isin(okf, kfs)
        pts = np.unique(opt[sel])
        pts = pts[store.pt_mask[pts]]
        if len(pts) < 20:
            return False
        kf_local = {k: i for i, k in enumerate(kfs)}
        pt_local = np.full(store.max_pts, -1, np.int64)
        pt_local[pts] = np.arange(len(pts))
        sel = sel & np.isin(opt, pts)
        o_kf = np.asarray([kf_local[k] for k in okf[sel]], np.int64)
        o_pt = pt_local[opt[sel]]
        o_uvr = store.kf_kp_uvr[okf[sel], okp[sel]]
        M = len(o_kf)
        if M < 40:
            return False
        fixed = np.zeros((K,), bool)
        fixed[0] = True

        # the JAX package's fixed-shape buckets: the temporal window is the
        # keyframe bucket, points and observations pad to powers of two
        Kb = max(window, K)
        Pb = _bucket(len(pts), 1024)
        Mb = _bucket(M, 4096)
        if Kb > K:
            pk = Kb - K
            R_wb = np.concatenate(
                [R_wb, np.tile(np.eye(3, dtype=np.float32)[None],
                               (pk, 1, 1))])
            p_wb = np.concatenate([p_wb, np.zeros((pk, 3), np.float32)])
            v_w = np.concatenate([v_w, np.zeros((pk, 3), np.float32)])
            fixed = np.concatenate([fixed, np.ones((pk,), bool)])
            zero_p = pre.Preintegrated(*(torch.zeros_like(x)
                                         for x in pres[0]))
            pres = pres + [zero_p] * pk
            pmask = pmask + [False] * pk
        P = len(pts)
        pt_xyz = np.zeros((Pb, 3), np.float32)
        pt_xyz[:P] = store.pt_xyz[pts]
        o_uvr = np.pad(np.asarray(o_uvr, np.float32), ((0, Mb - M), (0, 0)),
                       constant_values=-1.0)

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                   device=dev)

        line_kw = {}
        if store.num_lines > 0:
            lkf, lln, lkl = store.live_line_obs()
            lsel = np.isin(lkf, kfs) & store.ln_mask[
                np.clip(lln, 0, store.max_lines - 1)]
            if lsel.sum() >= 4:
                nl = int(lsel.sum())
                nlb = _bucket(nl, 512)
                lo_kf = np.asarray([kf_local[k] for k in lkf[lsel]], np.int64)
                sp = store.kf_kl_sp[lkf[lsel], lkl[lsel]]
                ep = store.kf_kl_ep[lkf[lsel], lkl[lsel]]
                nld = lines_mod.line_nld(t(sp), t(ep))
                mlen = np.linalg.norm(ep - sp, axis=-1)
                pl_ = ((0, nlb - nl), (0, 0))
                line_kw = dict(
                    lobs_kf=t(np.pad(lo_kf, (0, nlb - nl))),
                    lobs_Xs=t(np.pad(np.asarray(store.ln_Xs[lln[lsel]],
                                                np.float32), pl_)),
                    lobs_Xe=t(np.pad(np.asarray(store.ln_Xe[lln[lsel]],
                                                np.float32), pl_)),
                    lobs_nld=torch.nn.functional.pad(nld, (0, 0, 0,
                                                           nlb - nl)),
                    lobs_inv_sigma2=t(np.pad(np.clip(
                        (mlen / 40.0) ** 2, 0.1, 4.0).astype(np.float32),
                        (0, nlb - nl), constant_values=1.0)),
                    lobs_mask=t(np.arange(nlb) < nl))

        prob = vi_ba.VIProblem(
            t(R_wb), t(p_wb), t(v_w),
            t(np.tile(self.bias_gyro, (Kb, 1)).astype(np.float32)),
            t(np.tile(self.bias_acc, (Kb, 1)).astype(np.float32)),
            t(fixed), t(np.arange(Kb) < K), t(self.R_cb, torch.float32),
            t(self.t_cb, torch.float32), t(pt_xyz), t(np.arange(Pb) < P),
            t(np.pad(o_kf, (0, Mb - M))), t(np.pad(o_pt, (0, Mb - M))),
            t(o_uvr), t(np.ones((Mb,), np.float32)), t(np.arange(Mb) < M),
            imu_init.stack_preints(pres), t(np.asarray(pmask)),
            t(np.asarray(self.gravity, np.float32)), **line_kw)
        Rn, pn, vn, bgn, ban, ptsn, info = vi_ba.vi_bundle_adjust(
            cam, prob, num_iters=6, cg_iters=30)
        (Rn, pn, vn, bgn, ban, ptsn, cost0, cost, lm_n, cg_n) = _read_flat(
            (Rn, pn, vn, bgn, ban, ptsn[:P], info["cost0"], info["cost"],
             info["lm_iters"], info["cg_iters"]))
        self.vi_ba_log.append({"kf": int(kf_id), "K": K, "cost0": float(cost0),
                               "cost": float(cost), "lm_iters": int(lm_n),
                               "cg_iters": int(cg_n)})
        if not np.isfinite(float(cost)):
            return False
        for i, k in enumerate(kfs):
            if fixed[i]:
                continue
            R_bw = Rn[i].T
            t_bw = -R_bw @ pn[i]
            store.kf_R[k] = (self.R_cb @ R_bw).astype(np.float32)
            store.kf_t[k] = (self.R_cb @ t_bw + self.t_cb).astype(np.float32)
            self.kf_velocity[k] = vn[i].astype(np.float32)
        store.version += 1
        store.pt_xyz[pts] = ptsn
        # while the staged initialization still refines, its inertial-only
        # solve is the better bias estimator; afterwards track the last
        # real keyframe's optimized bias
        if self._total_time() >= self.init_refine_until:
            self.bias_gyro = bgn[K - 1].astype(np.float32)
            self.bias_acc = ban[K - 1].astype(np.float32)
        return True
