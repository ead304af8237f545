"""ATE of the JAX package on the PyTorch port's chip-smoke scene.

Runs ``plvs_tpu``'s synchronous RGB-D tracker with points and lines over
bench.py's structured-wall scene and prints one JSON line with the aligned
and raw ATE-RMSE against ground truth. Without ``--local-ba`` the keyframe
backend is off (``chip_smoke.py`` phase 2's configuration); with it the
synchronous keyframe backend runs with bench.py's fixed BA shapes
(``local_ba=True, backend_fixed_shapes=True``, phase 4's configuration),
and the line also gives the live keyframes, points and lines and the
keyframes culled. The port's chip smoke holds its own ATE to
max(1.5 x this, this + 1 cm).

    JAX_PLATFORMS=cpu python scripts/reference_ate_rgbd_lines.py [--frames 120] [--local-ba]
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
    ap.add_argument("--local-ba", action="store_true",
                    help="run the synchronous keyframe backend")
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
                       local_ba=args.local_ba, loop_closing=False,
                       dense_mapping=False, pipelined=False,
                       depth_upload_decimation=2,
                       backend_fixed_shapes=args.local_ba)
    system = System(cam, cfg)
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=420.0)
    states, gt = [], []
    t0 = time.perf_counter()
    for ts, gray, depth, R, t in scene.sequence(n_frames=args.frames):
        state, _, _ = system.track_rgbd(gray, depth, ts)
        states.append(int(state))
        gt.append(-R.T @ t)
    wall = time.perf_counter() - t0
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack(gt)
    out = {
        "device": "cpu (jax " + jax.__version__ + ")",
        "frames": args.frames,
        "all_ok_after_first": all(s == OK for s in states[1:]),
        "ate_rmse_m": evaluation.ate_rmse(est, gt, align=True),
        "ate_rmse_raw_m": evaluation.ate_rmse(est, gt, align=False),
        "map": system.map_statistics(),
        "wall_s": wall,
    }
    if args.local_ba:
        st = system.store
        # every keyframe ever made has a uid; the culled ones left tombstones
        out["local_ba"] = {"keyframes_made": int(st._next_kf_uid),
                           "keyframes_culled": len(st.kf_tombstone)}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
