"""The JAX package's figures on the port's chip-smoke phase 12: RGB-D SLAM
with incremental 3D segmentation, then the dense library's far field,
carving, ESDF and mesh normals on the run's keyframes.

Runs ``plvs_tpu``'s synchronous System on the CPU in demo_inseg.py's
configuration at bench width (``plvs_tpu/demo_inseg.py:60-76``: dense
mapping with ``dense_segmentation``, 2 cm voxels, local BA and loop closing
on; here 640x480, 1024 features, 8 levels, scale 1.2) over phase 5's room
(``SyntheticRoom(half=3, tex_size=2048, seed=3)``, no depth noise) on
``orbit_loop_trajectory(60, radius=0.6, laps=0.5)``, rendered by the
port's numpy copy so ``chip_smoke.py`` sees the same frames. Then feeds the
stored keyframes at their final poses through a
``DenseMapper(multi_res=True, split_depth=3.0, carve_every=3,
fixed_shapes=True)`` with ``insert_keyframe_rgbd``, and reports its fine
and coarse occupied voxels, triangles and carved voxels, the ESDF of its
fine volume at 1000 wall points (pixels of the stored depths nearer than
2.9 m, back-projected at the final poses:
``plvs_tpu_torch.io.evaluation.depth_samples``) and the median cosine of
its mesh normals to the inward normals of the room's walls
(``SyntheticRoom.wall_normals``). Prints one JSON line.

    JAX_PLATFORMS=cpu python scripts/reference_inseg.py [--frames 60]
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
    ap.add_argument("--frames", type=int, default=60)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from plvs_tpu.dense import esdf
    from plvs_tpu.dense.mapping import DenseMapper
    from plvs_tpu.dense.meshing import marching_tetrahedra
    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import evaluation
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.slam.tracking import OK
    from plvs_tpu_torch.geometry import cameras as tcam
    from plvs_tpu_torch.io import evaluation as tev
    from plvs_tpu_torch.io import synthetic as tsyn

    args_cam = (520.9, 521.0, 325.1, 249.7)
    kw = dict(width=640, height=480, bf=40.0)
    cam = cameras.pinhole(*args_cam, **kw)
    room = tsyn.SyntheticRoom(tcam.pinhole(*args_cam, **kw), half=3.0,
                              tex_size=2048, seed=3)
    poses = tsyn.orbit_loop_trajectory(args.frames, radius=0.6, laps=0.5)
    frames = list(room.sequence(poses))
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=False, local_ba=True,
                       loop_closing=True, dense_mapping=True,
                       dense_segmentation=True, dense_voxel_size=0.02,
                       pipelined=False)
    system = System(cam, cfg)
    t0 = time.perf_counter()
    states = [int(system.track_rgbd(g, d, ts)[0])
              for ts, g, d, _, _ in frames]
    run_s = time.perf_counter() - t0
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for *_, R, t in frames])
    dm = system.dense_mapper
    pts, lab = dm.segment_cloud()
    out = {"phase": 12, "device": "cpu (jax " + jax.__version__ + ")",
           "frames": args.frames, "run_s": run_s,
           "all_ok_after_first": all(s == OK for s in states[1:]),
           "states_not_ok": [i for i, s in enumerate(states) if s != OK],
           "ate_rmse_m": evaluation.ate_rmse(est, gt, align=True),
           "map": system.map_statistics(),
           "keyframes_made": int(system.store._next_kf_uid),
           "loops": len(system.loops_closed),
           "segmented_voxels": int(len(pts)),
           "labelled_voxels": int((lab > 0).sum()),
           "segments_conf2": int(len(np.unique(lab[lab > 0]))),
           "next_global": int(dm.label_map.next_global),
           "keyframes_segmented": len(dm.labels)}

    st = system.store
    final = {k.kf_id: (st.kf_R[k.kf_id].copy(), st.kf_t[k.kf_id].copy())
             for k in dm.keyframes if st.kf_mask[k.kf_id]}
    lib = DenseMapper(cam, voxel_size=0.02, multi_res=True, split_depth=3.0,
                      carve_every=3, fixed_shapes=True)
    carved = []
    for vol in (lib.volume, lib.coarse):
        f = vol.remove_unstable

        def counted(*a, _f=f, _v=vol, **k):
            before = int((_v.weight > 0).sum())
            _f(*a, **k)
            carved.append(before - int((_v.weight > 0).sum()))

        vol.remove_unstable = counted
    t1 = time.perf_counter()
    for k in dm.keyframes:
        if k.kf_id in final:
            lib.insert_keyframe_rgbd(k.kf_id, np.asarray(k.color),
                                     np.asarray(k.depth), *final[k.kf_id])
    fine_pts, _ = lib.volume.occupied_cloud()
    coarse_pts, _ = lib.coarse.occupied_cloud()
    _, F = lib.mesh()
    origin, grid, _ = esdf.esdf_from_tsdf(lib.volume)
    q = tev.depth_samples([(k.kf_id, np.asarray(k.depth))
                           for k in dm.keyframes], final, cam, 1000, 2.9)
    d = esdf.query_esdf(origin, grid, lib.volume.voxel_size, q)
    V, _ = marching_tetrahedra(lib.volume)
    V = V[np.random.default_rng(0).choice(len(V), min(len(V), 5000),
                                          replace=False)]
    # the map is built in the first camera's frame: rotate into the room's
    R0, t0 = poses[0]
    cos = np.sum((lib.mesh_normals(V) @ R0)
                 * room.wall_normals((V - t0) @ R0), -1)
    out.update(library={
        "keyframes": len(final),
        "fine_occupied": int(len(fine_pts)),
        "coarse_occupied": int(len(coarse_pts)),
        "triangles": int(len(F)),
        "carved_voxels": int(sum(carved)),
        "carves": len(carved),
        "esdf_grid": list(grid.shape),
        "esdf_median_m": float(np.median(d)),
        "normals_median_cos": float(np.median(cos)),
        "cpu_s": time.perf_counter() - t1})
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
