"""The JAX package's figures on the port's relocalization chip-smoke scene.

Runs ``plvs_tpu``'s synchronous RGB-D tracker with points and lines over
bench.py's structured-wall scene (``chip_smoke.py`` phase 2's scene and
flags) with a blackout: gray and depth zeroed on frames [a, b). The map
loses tracking, goes RECENTLY_LOST (or LOST) and relocalizes through the
keyframe database. Prints one JSON line with the per-frame states, the
first frame from which every state is OK, the final camera centre's error
against ground truth and the ATE. ``chip_smoke.py`` phase 6 holds the port
to the same state sequence.

    JAX_PLATFORMS=cpu python scripts/reference_reloc.py [--blackout 80 86]
        [--frames 120] [--recently-lost-keyframes N]

``--recently-lost-keyframes N`` sets the tracker's ``min_kf_recently_lost``
(10 by default): a map of fewer keyframes goes LOST, not RECENTLY_LOST.
``chip_smoke.py`` phase 6 runs ``--frames 40 --blackout 30 33
--recently-lost-keyframes 3``.
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
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--blackout", type=int, nargs=2, default=(80, 86))
    ap.add_argument("--recently-lost-keyframes", type=int, default=None)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import evaluation, synthetic
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.slam.tracking import OK

    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=True, max_lines=160,
                       local_ba=False, loop_closing=False,
                       dense_mapping=False, pipelined=False,
                       depth_upload_decimation=2)
    system = System(cam, cfg)
    if args.recently_lost_keyframes is not None:
        system.tracker.min_kf_recently_lost = args.recently_lost_keyframes
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=420.0)
    a, b = args.blackout
    states, gt = [], []
    t0 = time.perf_counter()
    for i, (ts, gray, depth, R, t) in enumerate(
            scene.sequence(n_frames=args.frames)):
        if a <= i < b:
            gray = np.zeros_like(gray)
            depth = np.zeros_like(depth)
        state, _, _ = system.track_rgbd(gray, depth, ts)
        states.append(int(state))
        gt.append(-R.T @ t)
    wall = time.perf_counter() - t0
    ok_from = next(i for i in range(len(states) + 1)
                   if all(s == OK for s in states[i:]))
    _, R_end, t_end = system.trajectory[-1]
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack(gt)
    out = {
        "device": "cpu (jax " + jax.__version__ + ")",
        "frames": args.frames,
        "blackout": [a, b],
        "min_kf_recently_lost": system.tracker.min_kf_recently_lost,
        "states": states,
        "ok_from": ok_from,
        "final_centre_err_m": float(np.linalg.norm(-R_end.T @ t_end - gt[-1])),
        "ate_rmse_m": evaluation.ate_rmse(est, gt, align=True),
        "map": system.map_statistics(),
        "wall_s": wall,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
