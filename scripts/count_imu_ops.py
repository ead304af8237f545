"""How many PyTorch operations the inertial path dispatches: one frame gap's
preintegration, the per-frame deltas read-back, the inertial-only
initialization and one VI local BA solve.

    python3 scripts/count_imu_ops.py [--device cpu|cuda] [--samples 10]

The per-frame inertial work of ``System.track_rgbd`` is one preintegration
of the samples since the last frame (10 at 300 Hz and 30 frames/s) and one
bias-corrected deltas read-back; every keyframe adds one preintegration of
the keyframe gap, and while the IMU initializes (or refines) the
inertial-only solve, once initialized the VI BA (6 LM x 30 CG at the
runtime's fixed trip counts). On the card each non-view operation is about
one kernel launch. The counts do not depend on the data: the loops run
fixed trip counts. This script counts them with a ``TorchDispatchMode`` on
bench.py's inertial motion (``io/synthetic.py``) and prints one JSON line.
Imports nothing of jax or plvs_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _vi_problem(torch, initialization, vi_ba, frames, preints, device, K=8,
                P=300):
    """A VI BA window over K keyframes four frames apart, P points seen by
    every keyframe (a problem of the runtime's shape; the count does not
    depend on its values)."""
    rng = np.random.default_rng(0)
    kf = frames[3::4][:K]
    R_wb = np.stack([R.T for _, R, _, _ in kf]).astype(np.float32)
    p_wb = np.stack([-R.T @ t for _, R, t, _ in kf]).astype(np.float32)
    pts = np.c_[rng.uniform(-1, 1, (P, 2)), rng.uniform(2, 4, P)].astype(
        np.float32)
    M = K * P
    uvr = np.c_[rng.uniform(0, 640, (M, 2)), -np.ones(M)].astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return vi_ba.VIProblem(
        t(R_wb), t(p_wb), t(np.zeros((K, 3), np.float32)),
        t(np.zeros((K, 3), np.float32)), t(np.zeros((K, 3), np.float32)),
        t(np.arange(K) == 0), t(np.ones(K, bool)),
        t(np.eye(3, dtype=np.float32)), t(np.zeros(3, np.float32)), t(pts),
        t(np.ones(P, bool)), t(np.repeat(np.arange(K), P)),
        t(np.tile(np.arange(P), K)), t(uvr), t(np.ones(M, np.float32)),
        t(np.ones(M, bool)), initialization.stack_preints(preints[:K - 1]),
        t(np.ones(K - 1, bool)), t(np.array([0.3, 9.7, -0.4], np.float32)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--samples", type=int, default=10,
                    help="samples in the frame gap (10 at 300 Hz, 30 fps)")
    args = ap.parse_args()

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from plvs_tpu_torch.geometry import cameras
    from plvs_tpu_torch.imu import initialization, preintegration as pre
    from plvs_tpu_torch.io import synthetic
    from plvs_tpu_torch.slam.inertial import _read_flat
    from plvs_tpu_torch.solvers import vi_ba

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.views += bool(func.is_view)
            return func(*args, **(kwargs or {}))

    def count(fn):
        c = Count()
        with c:
            fn()
        return c.ops - c.views

    dev = torch.device(args.device)
    frames = synthetic.inertial_sequence(n_frames=40, seed=1)
    z3 = np.zeros(3, np.float32)

    def window(sel, t0):
        ts = np.asarray([s[0] for s in sel])
        d = torch.from_numpy(np.c_[
            np.stack([s[1] for s in sel]), np.stack([s[2] for s in sel]),
            np.diff(ts, prepend=t0)].astype(np.float32)).to(dev)
        return d[:, 0:3], d[:, 3:6], d[:, 6]

    gap = [s for f in frames[1:] for s in f[3]][:args.samples]
    g, a, dts = window(gap, frames[0][0])
    n_pre = count(lambda: pre.preintegrate(g, a, dts, z3, z3))
    p = pre.preintegrate(g, a, dts, z3, z3)
    n_deltas = count(lambda: _read_flat(pre.deltas(p, z3, z3)))
    kf = frames[3::4]
    preints = []
    for i in range(1, len(kf)):
        sel = [s for f in frames[4 * i:4 * i + 4] for s in f[3]]
        preints.append(pre.preintegrate(*window(sel, kf[i - 1][0]), z3, z3))
    R_wb = np.stack([R.T for _, R, _, _ in kf]).astype(np.float32)
    p_wb = np.stack([-R.T @ t for _, R, t, _ in kf]).astype(np.float32)
    n_init = count(lambda: initialization.inertial_only_optimize_padded(
        R_wb[:6], p_wb[:6], preints[:5], fix_scale=True))
    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    prob = _vi_problem(torch, initialization, vi_ba, frames, preints, dev)
    n_vi = count(lambda: vi_ba.vi_bundle_adjust(cam, prob, num_iters=6,
                                                cg_iters=30))
    print(json.dumps({
        "device": args.device, "frame_gap_samples": args.samples,
        "preintegrate_non_view_ops": n_pre,
        "per_sample": n_pre / max(args.samples, 1),
        "deltas_readback_non_view_ops": n_deltas,
        "init_solve_non_view_ops_K6": n_init,
        "vi_ba_non_view_ops_K8": n_vi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
