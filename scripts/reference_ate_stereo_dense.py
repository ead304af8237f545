"""The JAX package's figures on the port's stereo dense-mapping chip-smoke
phase.

Runs ``plvs_tpu``'s synchronous rectified-stereo tracker with points and
lines, dense TSDF mapping and per-keyframe incremental meshing on, and the
rest of the keyframe backend off (the configuration ``chip_smoke.py``
phase 3 drives through ``plvs_tpu_torch``), over bench.py's structured-wall
scene with the right image rendered one baseline to the right. Prints one
JSON line: the aligned and raw ATE-RMSE against ground truth, the map
counts, the occupied-voxel count of the dense cloud with the median and p95
of |z - 3.0| over its centroids (the wall is the plane z = 3 m), and the
triangle counts of the incremental mesh cache and of a full marching-
tetrahedra pass over the final volume.

    JAX_PLATFORMS=cpu python scripts/reference_ate_stereo_dense.py [--frames 120]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

WALL_Z = 3.0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
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
                       sensor="stereo", local_ba=False, loop_closing=False,
                       dense_mapping=True, dense_voxel_size=0.02,
                       dense_mesh_every=1, pipelined=False)
    system = System(cam, cfg)
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=WALL_Z, texture=tex,
                                    tex_scale=420.0)
    baseline = cam.bf / float(cam.params[0])
    states, gt = [], []
    t0 = time.perf_counter()
    for ts, gray, _, R, t in scene.sequence(n_frames=args.frames):
        gray_r, _ = scene.render(R, t - np.array([baseline, 0.0, 0.0],
                                                  np.float32))
        state, _, _ = system.track_stereo(gray, gray_r, ts)
        states.append(int(state))
        gt.append(-R.T @ t)
    wall = time.perf_counter() - t0
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack(gt)
    dm = system.dense_mapper
    pts, _ = dm.cloud()
    dz = np.abs(pts[:, 2] - WALL_Z)
    V, F = dm.mesh()
    print(json.dumps({
        "device": "cpu (jax " + jax.__version__ + ")",
        "frames": args.frames,
        "all_ok_after_first": all(s == OK for s in states[1:]),
        "ate_rmse_m": evaluation.ate_rmse(est, gt, align=True),
        "ate_rmse_raw_m": evaluation.ate_rmse(est, gt, align=False),
        "map": system.map_statistics(),
        "dense_blocks": int(dm.volume.n_blocks),
        "occupied_voxels": int(len(pts)),
        "median_abs_dz_m": float(np.median(dz)),
        "p95_abs_dz_m": float(np.percentile(dz, 95)),
        "mesh_triangles_incremental": int(sum(
            len(t) for t in dm.mesher._block_tris.values())),
        "mesh_triangles_full": int(len(F)),
        "remeshed_blocks": [int(n) for n in dm.remesh_counts],
        "wall_s": wall,
    }))


if __name__ == "__main__":
    main()
