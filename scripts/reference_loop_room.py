"""The JAX package's figures on the port's loop-closure chip-smoke scene.

Runs ``plvs_tpu``'s synchronous RGB-D System with local BA, loop closing
and dense mapping (points only) over the four-wall room orbit of
tests/test_flagship_e2e.py (``SyntheticRoom(half=3, tex_size=2048,
seed=3)``, ``orbit_loop_trajectory(132, radius=1, laps=1.375)``, depth
noise N(0, 0.01) d^2 from ``default_rng(1000 + i)``) at bench.py's camera
and width (640x480, 1024 features, 8 levels), and prints one JSON line:
the tracking states, every closed loop (keyframe, candidate, inliers,
pose-graph cost before and after), the global BA's cost before and after,
the ATE, the live map and the dense map's occupied voxels and mesh
triangles right after the first rebuild and at the end. ``chip_smoke.py``
phase 5 holds the port to these figures. ``--lines`` runs the same orbit
with bench.py's lines flags instead (``use_lines=True, max_lines=160,
scale=1.2, max_kf=256, backend_fixed_shapes=True``), a configuration in
which the reference loses tracking mid-orbit and closes no loop.

    JAX_PLATFORMS=cpu python scripts/reference_loop_room.py [--frames 132] [--lines]
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
    ap.add_argument("--frames", type=int, default=132)
    ap.add_argument("--lines", action="store_true",
                    help="bench.py's lines flags instead of points only")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from plvs_tpu.dense import meshing
    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import evaluation, synthetic
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.slam.tracking import OK
    from plvs_tpu.solvers import ba

    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    lines = (dict(use_lines=True, max_lines=160, scale=1.2, max_kf=256,
                  backend_fixed_shapes=True) if args.lines
             else dict(use_lines=False, max_kf=128))
    cfg = SystemConfig(num_features=1024, n_levels=8, max_pts=65536,
                       local_ba=True, loop_closing=True, dense_mapping=True,
                       dense_voxel_size=0.02, **lines)
    system = System(cam, cfg)

    # the global BA is the solve with 30 CG iterations (the local BA runs
    # 14): record its cost before and after
    gba = []
    solve = ba.bundle_adjust_jit

    def recording(*a, **kw):
        out = solve(*a, **kw)
        if kw.get("cg_iters") == 30:
            gba.append({"cost0": float(out[-1]["cost0"]),
                        "cost": float(out[-1]["cost"])})
        return out

    ba.bundle_adjust_jit = recording
    dm = system.dense_mapper
    rebuild = dm.rebuild
    after_rebuild = []

    def recording_rebuild(get_pose):
        rebuild(get_pose)
        _, faces = meshing.marching_tetrahedra(dm.volume)
        after_rebuild.append({"occupied": int(len(dm.cloud()[0])),
                              "triangles": int(len(faces)),
                              "keyframes": len(dm.keyframes)})

    dm.rebuild = recording_rebuild

    room = synthetic.SyntheticRoom(cam, half=3.0, tex_size=2048, seed=3)
    poses = synthetic.orbit_loop_trajectory(132, radius=1.0,
                                            laps=1.375)[:args.frames]
    states, gt = [], []
    t0 = time.perf_counter()
    for i, (ts, gray, depth, R, t) in enumerate(room.sequence(poses)):
        rng = np.random.default_rng(1000 + i)
        depth = depth + rng.normal(0, 0.01, depth.shape).astype(
            np.float32) * depth ** 2
        state, _, _ = system.track_rgbd(gray, depth, ts)
        states.append(int(state))
        gt.append(-R.T @ t)
    wall = time.perf_counter() - t0
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack(gt)
    _, faces = meshing.marching_tetrahedra(dm.volume)
    out = {
        "device": "cpu (jax " + jax.__version__ + ")",
        "frames": len(states),
        "lines_flags": args.lines,
        "all_ok_after_first": all(s == OK for s in states[1:]),
        "states": states,
        "loops": [{"kf": int(k), "candidate": int(info["candidate"]),
                   "inliers": int(info["inliers"]),
                   "cost0": float(info["cost0"]), "cost": float(info["cost"]),
                   "n_fused": int(info.get("n_fused", 0))}
                  for k, info in system.loops_closed],
        "global_ba": gba,
        "ate_rmse_m": evaluation.ate_rmse(est, gt, align=True),
        "ate_rmse_raw_m": evaluation.ate_rmse(est, gt, align=False),
        "map": system.map_statistics(),
        "dense_after_rebuild": after_rebuild,
        "dense_end": {"occupied": int(len(dm.cloud()[0])),
                      "triangles": int(len(faces))},
        "wall_s": wall,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
