"""JAX figures for ``chip_smoke.py`` phase 18 (sensor artifacts, stereo
lines with the keyframe backend, lines under depth noise).

Runs ``plvs_tpu``'s System on the CPU and prints one JSON line per run:

- ``--part a``: phase 4's configuration (bench.py's camera and widths,
  lines, ``local_ba``, ``backend_fixed_shapes``) over phase 2's structured
  wall and sweep, each frame through ``SensorModel(seed=11)`` by
  ``SyntheticRGBD.sequence(sensor=)``;
- ``--part b``: the same widths with ``sensor="stereo"``, lines,
  ``local_ba`` and ``backend_fixed_shapes`` over the bar-dominated wall
  (``make_line_texture(rng=default_rng(11))``), the right image rendered
  one baseline to the right (tests/test_lines_e2e.py's rig);
- ``--part c``: tests/test_lines_e2e.py's scene and size (320x240, 512
  features, 4 levels, 64 lines, its default flags) with depth noise
  0.006 z^2 seeded 77 + i, once with points only and once with lines.

Each line gives the states, the aligned ATE-RMSE, the live keyframes,
points and lines, the keyframes made and the line landmarks with at least
two observations. The port's chip smoke holds its runs to these.

The JAX pose solve multiplies masked line rows by a zero weight, and a
keyline slot the detector left empty carries non-finite endpoints, so
0 x NaN turns the frame's pose NaN and the frame is lost. The port zeroes
masked rows in ``make_pose_obs``; by default this script gives the JAX
package the same repair at run time (``pose_opt.make_pose_obs`` wrapped,
nothing edited), and ``--as-is`` runs it unrepaired.

    JAX_PLATFORMS=cpu python scripts/reference_sensor_lines.py --part a|b|c [--frames N] [--as-is]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _summary(system, states, gt, wall, OK, evaluation) -> dict:
    est = system.trajectory_tum()[:, 1:4]
    st = system.store
    lns = np.nonzero(st.ln_mask)[0]
    return {"states": states,
            "not_ok_after_first": sum(s != OK for s in states[1:]),
            "ate_rmse_m": evaluation.ate_rmse(est, np.stack(gt), align=True),
            "map": system.map_statistics(),
            "keyframes_made": int(st._next_kf_uid),
            "lines_multi_view": int((st.ln_n_obs[lns] >= 2).sum()),
            "wall_s": wall}


def mask_empty_line_rows(pose_opt) -> None:
    """Wrap the JAX ``pose_opt.make_pose_obs`` so masked line rows carry a
    zero line and a zero weight, as the port's do (the tracker's jitted
    programs look the function up when they are traced)."""
    import jax.numpy as jnp

    make = pose_opt.make_pose_obs

    def make_pose_obs(Xw, uvr, inv_sigma2, mask, line_Xs=None, line_Xe=None,
                      line_nld=None, line_inv_sigma2=None, line_mask=None):
        if line_Xs is not None:
            line_nld = jnp.where(line_mask[:, None], line_nld, 0.0)
            line_inv_sigma2 = jnp.where(line_mask, line_inv_sigma2, 0.0)
        return make(Xw, uvr, inv_sigma2, mask, line_Xs, line_Xe, line_nld,
                    line_inv_sigma2, line_mask)

    pose_opt.make_pose_obs = make_pose_obs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=("a", "b", "c"), required=True)
    ap.add_argument("--frames", type=int, default=None,
                    help="frames (40 for parts a-b, 30 for part c)")
    ap.add_argument("--as-is", action="store_true",
                    help="run the JAX package without the masked-row "
                         "repair")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import evaluation, synthetic
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.slam.tracking import OK
    from plvs_tpu.solvers import pose_opt

    if not args.as_is:
        mask_empty_line_rows(pose_opt)
    out = {"device": "cpu (jax " + jax.__version__ + ")", "part": args.part,
           "masked_line_rows_repaired": not args.as_is}
    if args.part in ("a", "b"):
        n = args.frames or 40
        cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640,
                              height=480, bf=40.0)
        wide = dict(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                    max_pts=65536, use_lines=True, max_lines=160,
                    local_ba=True, loop_closing=False, dense_mapping=False,
                    pipelined=False, backend_fixed_shapes=True)
        states, gt = [], []
        t0 = time.perf_counter()
        if args.part == "a":
            system = System(cam, SystemConfig(**wide,
                                              depth_upload_decimation=2))
            tex = synthetic.make_structured_texture(
                2048, rng=np.random.default_rng(7))
            scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                            tex_scale=420.0)
            seq = scene.sequence(n_frames=n,
                                 sensor=synthetic.SensorModel(seed=11))
            for ts, gray, depth, R, t in seq:
                states.append(int(system.track_rgbd(gray, depth, ts)[0]))
                gt.append(-R.T @ t)
        else:
            system = System(cam, SystemConfig(**wide, sensor="stereo"))
            tex = synthetic.make_line_texture(rng=np.random.default_rng(11))
            scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex)
            shift = np.array([cam.bf / float(cam.params[0]), 0.0, 0.0],
                             np.float32)
            for ts, gray, _, R, t in scene.sequence(n_frames=n):
                gray_r, _ = scene.render(R, t - shift)
                states.append(int(system.track_stereo(gray, gray_r, ts)[0]))
                gt.append(-R.T @ t)
        out.update(frames=n, **_summary(system, states, gt,
                                        time.perf_counter() - t0, OK,
                                        evaluation))
        print(json.dumps(out))
        return

    n = args.frames or 30
    cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                          bf=24.0)
    out["frames"] = n
    for use_lines in (False, True):
        system = System(cam, SystemConfig(
            num_features=512, n_levels=4, max_kf=64, max_pts=16384,
            use_lines=use_lines, max_lines=64))
        scene = synthetic.SyntheticRGBD(
            cam, wall_z=3.0,
            texture=synthetic.make_line_texture(
                rng=np.random.default_rng(11)))
        states, gt = [], []
        t0 = time.perf_counter()
        for i, (ts, gray, depth, R, t) in enumerate(
                scene.sequence(n_frames=n)):
            noise = np.random.default_rng(77 + i).normal(
                0, 0.006, depth.shape).astype(np.float32)
            depth = depth + noise * depth ** 2
            states.append(int(system.track_rgbd(gray, depth, ts)[0]))
            gt.append(-R.T @ t)
        out["lines" if use_lines else "points"] = _summary(
            system, states, gt, time.perf_counter() - t0, OK, evaluation)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
