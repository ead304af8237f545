"""The JAX package's figures on the port's chip-smoke phases 10 and 11: the
non-rectified KB8 fisheye rig, and the same rig rectified with dense
mapping.

Both phases run ``plvs_tpu``'s synchronous System on the CPU over
bench.py's structured wall (phase 2's texture and poses) seen through
tests/test_stereo_rig.py's KB8 pair scaled to 640x480
(``plvs_tpu_torch.io.synthetic.RIG_KB8_LEFT`` / ``RIG_KB8_RIGHT``, the right
camera 11 cm to the right, yawed by 0.017 rad), both views rendered by the
port's numpy ``SyntheticRig``, so ``chip_smoke.py`` sees the same frames.
Configuration: ``sensor="stereo"``, 1024 features, 8 levels, local BA with
fixed BA shapes, no loop closing, no lines, ``max_kf=256``,
``max_kf_interval=5``.

* phase 10: 90 frames through the rig (``cam2`` / ``T_c1_c2``); also the
  first frame's rig build against the rendered depth (the JAX test's
  gates);
* phase 11: 60 frames with ``rectify=True`` and 2 cm dense mapping; also
  SGM disparity (``method="sgm"``) on the first rectified pair.

Prints one JSON line per phase.

    JAX_PLATFORMS=cpu python scripts/reference_rig.py [--phase 10|11] [--frames N]

``--frames`` runs the first N poses instead (``chip_smoke.py`` runs 45 in
phase 10 and 40 in phase 11).
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
    ap.add_argument("--phase", type=int, choices=(10, 11), default=None)
    ap.add_argument("--frames", type=int, default=None)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from plvs_tpu.dense import stereo_depth
    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import evaluation
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.slam import frame as frame_mod
    from plvs_tpu.slam.tracking import OK
    from plvs_tpu_torch.geometry import cameras as tcam
    from plvs_tpu_torch.io import synthetic as tsyn

    size = dict(width=640, height=480)
    cam_l = cameras.kannala_brandt8(*tsyn.RIG_KB8_LEFT, **size)
    cam_r = cameras.kannala_brandt8(*tsyn.RIG_KB8_RIGHT, **size)
    T = tsyn.rig_extrinsic()
    rig = tsyn.SyntheticRig(
        tcam.kannala_brandt8(*tsyn.RIG_KB8_LEFT, **size),
        tcam.kannala_brandt8(*tsyn.RIG_KB8_RIGHT, **size), T,
        wall_z=WALL_Z, texture=tsyn.make_structured_texture(
            2048, rng=np.random.default_rng(7)), tex_scale=420.0)
    poses = tsyn.default_trajectory(120)

    for phase in (10, 11) if args.phase is None else (args.phase,):
        n = args.frames or (90 if phase == 10 else 60)
        frames = list(rig.sequence(poses[:n]))
        cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2,
                           max_kf=256, max_pts=65536, use_lines=False,
                           sensor="stereo", local_ba=True,
                           loop_closing=False, backend_fixed_shapes=True,
                           max_kf_interval=5, pipelined=False,
                           rectify=phase == 11, dense_mapping=phase == 11,
                           dense_voxel_size=0.02)
        system = System(cam_l, cfg, cam2=cam_r, T_c1_c2=T)
        out = {"phase": phase, "device": "cpu (jax " + jax.__version__ + ")",
               "frames": n}
        t0 = time.perf_counter()
        states = [int(system.track_stereo(gl, gr, ts)[0])
                  for ts, gl, gr, _, _ in frames]
        out["wall_s"] = time.perf_counter() - t0
        est = system.trajectory_tum()[:, 1:4]
        gt = np.stack([-R.T @ t for *_, R, t in frames])
        out.update(
            all_ok_after_first=all(s == OK for s in states[1:]),
            states_not_ok=[i for i, s in enumerate(states) if s != OK],
            ate_rmse_m=evaluation.ate_rmse(est, gt, align=True),
            map=system.map_statistics(),
            keyframes_made=int(system.store._next_kf_uid))
        gl0, gr0, depth0 = rig.render(*poses[0])
        if phase == 10:
            fr = frame_mod.build_frame_stereo_rig(
                jnp.asarray(gl0), jnp.asarray(gr0), cam_l, cam_r,
                jnp.asarray(T[:3, :3]), jnp.asarray(T[:3, 3]), 1024, 8, 1.2)
            d = np.asarray(fr.depth)
            xy = np.asarray(fr.kp.xy)
            ok = d > 0
            xi = np.clip(np.round(xy[ok, 0]).astype(int), 0, 639)
            yi = np.clip(np.round(xy[ok, 1]).astype(int), 0, 479)
            rel = (d[ok] - depth0[yi, xi]) / depth0[yi, xi]
            out["first_frame"] = {
                "triangulated": int(ok.sum()),
                "median_rel_err": float(np.median(rel)),
                "median_abs_rel_err": float(np.median(np.abs(rel)))}
        else:
            dm = system.dense_mapper
            pts, _ = dm.cloud()
            out.update(
                occupied_voxels=int(len(pts)),
                median_abs_dz_m=float(np.median(np.abs(pts[:, 2] - WALL_Z))),
                mesh_triangles_full=int(len(dm.mesh()[1])),
                dense_blocks=int(dm.volume.n_blocks),
                rectified_bf=float(system.cam.bf))
            rl, rr = system.rectifier(gl0, gr0)
            t1 = time.perf_counter()
            disp = np.asarray(stereo_depth.disparity(rl, rr, max_disp=64,
                                                     method="sgm"))
            valid = disp > 0
            depth = system.cam.bf / disp[valid]
            out["sgm_first_pair"] = {
                "valid_share": float(valid.mean()),
                "median_abs_depth_err_m": float(np.median(np.abs(
                    depth - WALL_Z))),
                "cpu_s": time.perf_counter() - t1}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
