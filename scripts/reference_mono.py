"""The JAX package's figures for the port's monocular and image-scale chip
phases (``chip_smoke.py`` phases 13-14), on the CPU.

Phase 13: ``System(sensor="mono")`` at bench.py's camera and widths
(640x480, 1024 features, 8 levels, scale 1.2), ``max_kf=64``,
``max_pts=16384``, ``max_kf_interval=5``, ``min_kf_inliers=25``, local BA
and loop closing on, synchronous, over tests/test_slam_e2e.py
TestMonocular's scene (``SyntheticRGBD(wall_z=3.0, seed=9)``) and its
40-pose translation-dominant trajectory, frames 28-30 blanked. It runs
once per relocalization / two-view key (``--keys``; the default key 7 is
the JAX package's own) and prints, per key, the init frame, the frames not
OK, the relocalizing frame, the PnP RANSAC calls and their inliers, the
``create_new_points`` additions, the Sim3-aligned ATE over the OK frames
and the live map; then the spread of the init and relocalizing frames.

Phase 14: RGB-D at 640x480 with ``image_scale=0.5`` (320x240 at 1024 / 8:
the per-level ORB path), local BA and loop closing on, lines off, 40
frames of ``SyntheticRGBD(wall_z=3.0, seed=1)`` with one map object —
tests/test_objects_e2e.py's template (a 256 px crop at offset 20 of the
wall texture, 256 / tex_scale m wide). It prints the states, the ATE, the
live map, the keyframes the object was detected at, its last inlier count
and its world corners.

Frames are rendered by the port's numpy ``io/synthetic``, as chip_smoke.py
renders them.

    JAX_PLATFORMS=cpu python scripts/reference_mono.py --phase 13 [--keys 7 1 2 3 4]
    JAX_PLATFORMS=cpu python scripts/reference_mono.py --phase 14
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

BLACKOUT = (28, 31)


def mono_poses(n: int = 40):
    """tests/test_slam_e2e.py TestMonocular's trajectory."""
    poses = []
    for i in range(n):
        s = i / (n - 1)
        C = np.array([1.6 * s, 0.1 * np.sin(2 * np.pi * s), 0.3 * s],
                     np.float32)
        R = np.eye(3, dtype=np.float32)
        poses.append((R, (-R @ C).astype(np.float32)))
    return poses


def _phase13(key: int) -> dict:
    import jax

    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import evaluation
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.slam import local_mapping as lm_mod
    from plvs_tpu.slam.tracking import OK
    from plvs_tpu.solvers import pnp
    from plvs_tpu_torch.geometry import cameras as tcam
    from plvs_tpu_torch.io import synthetic

    args = (520.9, 521.0, 325.1, 249.7)
    cam = cameras.pinhole(*args, width=640, height=480, bf=40.0)
    scene = synthetic.SyntheticRGBD(
        tcam.pinhole(*args, width=640, height=480, bf=40.0), wall_z=3.0,
        seed=9)
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=64,
                       max_pts=16384, loop_closing=True, sensor="mono",
                       max_kf_interval=5, min_kf_inliers=25, pipelined=False)
    system = System(cam, cfg)
    system.tracker._reloc_key = jax.random.PRNGKey(key)
    pnp_calls = []
    orig_pnp = pnp.pnp_ransac

    def counting_pnp(*a, **kw):
        res = orig_pnp(*a, **kw)
        pnp_calls.append({"matches": int(a[0].shape[0]),
                          "inliers": int(res.n_inliers)})
        return res

    pnp.pnp_ransac = counting_pnp
    added = []
    orig_cnp = lm_mod.LocalMapper.create_new_points

    def counting_cnp(self, kf_id, *a, **kw):
        n0 = int(self.store.pt_mask.sum())
        orig_cnp(self, kf_id, *a, **kw)
        added.append(int(self.store.pt_mask.sum()) - n0)

    lm_mod.LocalMapper.create_new_points = counting_cnp
    a, b = BLACKOUT
    states, gt, reloc_calls = [], [], None
    t0 = time.perf_counter()
    try:
        for i, (ts, gray, _d, R, t) in enumerate(
                scene.sequence(poses=mono_poses())):
            if a <= i < b:
                gray = np.zeros_like(gray)
            n_before = len(pnp_calls)
            state, _, _ = system.track_monocular(gray, ts)
            states.append(int(state))
            gt.append(-R.T @ t)
            if i >= b and reloc_calls is None and state == OK:
                reloc_calls = pnp_calls[n_before:]
    finally:
        pnp.pnp_ransac = orig_pnp
        lm_mod.LocalMapper.create_new_points = orig_cnp
    wall = time.perf_counter() - t0
    ok = [i for i, s in enumerate(states) if s == OK]
    traj = system.trajectory_tum()
    ate = evaluation.ate_rmse(traj[ok, 1:4], np.stack([gt[i] for i in ok]),
                              align=True, with_scale=True)
    reloc = next((i for i in range(b, len(states)) if states[i] == OK), None)
    return {"key": key, "states": states, "init_frame": ok[0] if ok else None,
            "not_ok": [i for i, s in enumerate(states) if s != OK],
            "reloc_frame": reloc, "pnp_calls": len(pnp_calls),
            "pnp_calls_at_reloc": reloc_calls,
            "create_new_points_added": added, "ate_sim3_ok_m": ate,
            "map": system.map_statistics(), "wall_s": wall}


def _phase14() -> dict:
    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import evaluation
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.slam.tracking import OK
    from plvs_tpu_torch.geometry import cameras as tcam
    from plvs_tpu_torch.io import synthetic

    args = (520.9, 521.0, 325.1, 249.7)
    cam = cameras.pinhole(*args, width=640, height=480, bf=40.0)
    scene = synthetic.SyntheticRGBD(
        tcam.pinhole(*args, width=640, height=480, bf=40.0), wall_z=3.0,
        seed=1)
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=64,
                       max_pts=16384, image_scale=0.5, local_ba=True,
                       loop_closing=True, use_lines=False, pipelined=False)
    system = System(cam, cfg)
    crop, off = 256, 20
    tpl = scene.tex[off:off + crop, off:off + crop]
    metric_w = crop / scene.tex_scale
    oid = system.add_map_object(tpl, metric_w)
    states, gt = [], []
    t0 = time.perf_counter()
    for ts, gray, depth, R, t in scene.sequence(n_frames=40):
        state, _, _ = system.track_rgbd(gray, depth, ts)
        states.append(int(state))
        gt.append(-R.T @ t)
    wall = time.perf_counter() - t0
    est = system.trajectory_tum()[:, 1:4]
    ate = evaluation.ate_rmse(est, np.stack(gt), align=True)
    rec = system.object_store.objects[oid]
    corners = rec.corners_world()
    return {"states": states, "all_ok": all(s == OK for s in states),
            "ate_rmse_m": ate, "map": system.map_statistics(),
            "template_features": int(len(rec.template.desc)),
            "detected": bool(rec.detected),
            "detected_keyframes": sorted(int(k) for k in rec.obs),
            "n_inliers_last": int(rec.n_inliers),
            "corners_world": None if corners is None else corners.tolist(),
            "offset_m": off / scene.tex_scale, "metric_width_m": metric_w,
            "wall_s": wall}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phase", type=int, choices=(13, 14), default=13)
    ap.add_argument("--keys", type=int, nargs="+", default=[7, 1, 2, 3, 4])
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    if args.phase == 14:
        print(json.dumps({"device": "cpu (jax " + jax.__version__ + ")",
                          "phase": 14, **_phase14()}))
        return
    runs = []
    for key in args.keys:
        r = _phase13(key)
        runs.append(r)
        print(json.dumps({"phase": 13, **r}), flush=True)
    inits = [r["init_frame"] for r in runs]
    relocs = [r["reloc_frame"] for r in runs]
    print(json.dumps({"device": "cpu (jax " + jax.__version__ + ")",
                      "phase": 13, "keys": args.keys,
                      "init_frames": inits, "reloc_frames": relocs,
                      "ate_sim3_ok_m": [r["ate_sim3_ok_m"] for r in runs],
                      "maps": [r["map"] for r in runs]}))


if __name__ == "__main__":
    main()
