"""The JAX package's figures on bench.py's RGB-D-inertial scenario, for the
port's chip-smoke phase 9.

Runs ``plvs_tpu``'s System with ``bench.py``'s ``_vi_throughput_scenario``
configuration (``bench.py:376-384``: 640x480, 1024 features, 8 levels,
scale 1.2, ``max_kf=128``, ``max_pts=65536``, no lines, local BA, no loop
closing, ``use_imu``, pipelined at depth 2 with ``pipeline_overlap``,
``backend_fixed_shapes``, ``max_kf_interval=4``) on the CPU over the
timed pass's frames (seed 1, 90 frames), made by the port's numpy copy of
bench.py's sequence (``plvs_tpu_torch.io.synthetic.inertial_sequence`` and
``inertial_scene``: the same frames ``chip_smoke.py`` renders), calls
``flush()`` and prints one JSON line: the resolved states, the keyframe at
which the IMU initialized, the gravity and gyro-bias errors, the ATE, the
live map and the VI BA solves.

``--inline`` takes the overlap thread out (``pipeline_overlap=False``), as
phase 7's reference does: which frames resolve together then no longer
follows a helper thread's timing, and the run is deterministic. Under the
IMU the interleaved backend is off, so the backend runs inline anyway.

    JAX_PLATFORMS=cpu python scripts/reference_vi.py [--inline] [--frames N]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--inline", action="store_true",
                    help="pipeline_overlap=False")
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import evaluation
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.slam.tracking import OK
    from plvs_tpu_torch.geometry import cameras as tcameras
    from plvs_tpu_torch.io import synthetic as tsyn

    params = (520.9, 521.0, 325.1, 249.7)
    kw = dict(width=640, height=480, bf=40.0)
    cam = cameras.pinhole(*params, **kw)
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=128,
                       max_pts=65536, use_lines=False, local_ba=True,
                       loop_closing=False, use_imu=True, pipelined=True,
                       pipeline_depth=2, pipeline_overlap=not args.inline,
                       backend_fixed_shapes=True, max_kf_interval=4)
    system = System(cam, cfg)
    scene = tsyn.inertial_scene(tcameras.pinhole(*params, **kw), args.seed)
    seq = tsyn.inertial_sequence(n_frames=args.frames, seed=args.seed)
    frames = [(ts, *scene.render(R, t), samples, R, t)
              for ts, R, t, samples in seq]

    resolved = []
    post = system._post_track

    def recording_post(res, ts, payload=None):
        resolved.append(int(res.state))
        return post(res, ts, payload)

    system._post_track = recording_post
    vi = []
    vi_local_ba = system.inertial.vi_local_ba

    def recording_vi(*a, **k):
        ok = vi_local_ba(*a, **k)
        vi.append(bool(ok))
        return ok

    system.inertial.vi_local_ba = recording_vi
    init_kf = None
    t0 = time.perf_counter()
    for ts, gray, depth, samples, _, _ in frames:
        system.track_rgbd(gray, depth, ts, imu_samples=samples)
        if init_kf is None and system.inertial.initialized:
            init_kf = int(system.store._next_kf_uid)
    system.flush()
    if init_kf is None and system.inertial.initialized:
        init_kf = int(system.store._next_kf_uid)
    wall = time.perf_counter() - t0
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for *_, R, t in frames])
    g_true = np.array([0.3, 9.7, -0.4], np.float64)
    g_true = g_true / np.linalg.norm(g_true)
    iner = system.inertial
    g = None if iner.gravity is None else np.asarray(iner.gravity, np.float64)
    true_bg = np.array([0.002, -0.001, 0.001])
    out = {
        "device": "cpu (jax " + jax.__version__ + ")",
        "inline": args.inline,
        "seed": args.seed,
        "frames": len(frames),
        "resolved": len(resolved),
        "all_ok_after_first": all(s == OK for s in resolved[1:]),
        "not_ok": [i for i, s in enumerate(resolved) if s != OK],
        "init_keyframe": init_kf,
        "gravity": None if g is None else g.tolist(),
        "gravity_cos": None if g is None else float(
            g @ g_true / np.linalg.norm(g)),
        "bias_gyro": np.asarray(iner.bias_gyro).tolist(),
        "bias_gyro_err": float(np.linalg.norm(np.asarray(iner.bias_gyro)
                                              - true_bg)),
        "ate_rmse_m": evaluation.ate_rmse(est, gt, align=True),
        "map": system.map_statistics(),
        "keyframes_made": int(system.store._next_kf_uid),
        "vi_ba_solves": len(vi),
        "vi_ba_ok": int(sum(vi)),
        "wall_s": wall,
    }
    system.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
