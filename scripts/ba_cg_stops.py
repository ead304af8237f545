"""Where the local BA's CG loop stops, in the JAX solver and in the port's,
on phase-4-sized windows.

    JAX_PLATFORMS=cpu python scripts/ba_cg_stops.py [--frames 120]

CPU only. Runs the JAX System over chip_smoke.py phase 4's scene and
configuration (640x480, 1024 features, 8 levels, 160 lines, local BA with
``backend_fixed_shapes=True``) and records every local-BA problem its
mapper hands to ``bundle_adjust_jit`` (padded to the mapper's buckets).
Then, for each window:

* the JAX solver, run eagerly with ``jax.lax.while_loop`` replaced by a
  Python loop that evaluates the same condition and counts the trips: its
  LM iterations and the CG iterations of each (the solver's ``info`` has no
  CG count), and its cost before and after, beside the compiled solve's
  (XLA fuses the compiled program, so its float32 costs differ in the last
  digits);
* the port's ``bundle_adjust`` on the same problem (carried across with
  ``convert.ba_problem_from_numpy``): its LM and CG iterations and costs.

Prints one JSON line: per window the CG iterations of both solvers, out of
LM x 14, and both cost ratios cost0 / cost.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=120)
    args = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import synthetic
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.solvers import ba
    from plvs_tpu_torch import convert
    from plvs_tpu_torch.solvers import ba as tba

    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=True, max_lines=160,
                       local_ba=True, loop_closing=False, dense_mapping=False,
                       pipelined=False, depth_upload_decimation=2,
                       backend_fixed_shapes=True)
    system = System(cam, cfg)
    problems = []
    solve = ba.bundle_adjust_jit

    def recording(cam_, prob, num_iters=10, cg_iters=40, **kw):
        problems.append(({f: np.array(getattr(prob, f)) for f in
                          prob._fields}, num_iters, cg_iters, kw))
        return solve(cam_, prob, num_iters=num_iters, cg_iters=cg_iters, **kw)

    ba.bundle_adjust_jit = recording
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=420.0)
    t0 = time.perf_counter()
    for ts, gray, depth, _, _ in scene.sequence(n_frames=args.frames):
        system.track_rgbd(gray, depth, ts)
    ba.bundle_adjust_jit = solve
    run_s = time.perf_counter() - t0

    # the JAX solver's loops replayed in Python: the same conditions,
    # evaluated on concrete values, with the trips counted
    while_loop = jax.lax.while_loop
    trips = []     # (depth, count) per loop run, inner loops first

    def counting(cond, body, init):
        depth = counting.depth
        counting.depth += 1
        s, n = init, 0
        while bool(cond(s)):
            s = body(s)
            n += 1
        counting.depth -= 1
        trips.append((depth, n))
        return s

    counting.depth = 0
    tcam = convert.camera_from_numpy(cam.kind, np.asarray(cam.params),
                                     cam.width, cam.height, cam.bf)
    windows = []
    for arrays, num_iters, cg_iters, kw in problems:
        prob = ba.BAProblem(*(jax.numpy.asarray(arrays[f])
                              for f in ba.BAProblem._fields))
        jit_info = solve(cam, prob, num_iters=num_iters, cg_iters=cg_iters,
                         **kw)[-1]
        trips.clear()
        jax.lax.while_loop = counting
        try:
            with jax.disable_jit():
                info = ba.bundle_adjust(cam, prob, num_iters=num_iters,
                                        cg_iters=cg_iters, **kw)[-1]
        finally:
            jax.lax.while_loop = while_loop
        cg = [n for d, n in trips if d == 1]
        lm = [n for d, n in trips if d == 0][0]
        tprob = convert.ba_problem_from_numpy(arrays, device="cpu")
        tinfo = tba.bundle_adjust(tcam, tprob, num_iters=num_iters,
                                  cg_iters=cg_iters)[-1]
        tinfo = {k: float(v) for k, v in tinfo.items()}
        windows.append({
            "cameras": int(arrays["cam_mask"].sum()),
            "points": int(arrays["point_mask"].sum()),
            "lines": int(arrays["line_mask"].sum()),
            "lm_x_cg": [num_iters, cg_iters],
            "jax_lm_iters": lm, "jax_cg_iters": cg,
            "jax_cg_total": sum(cg),
            "jax_cost_ratio": float(info["cost0"]) / float(info["cost"]),
            "jax_jit_cost_ratio": (float(jit_info["cost0"])
                                   / float(jit_info["cost"])),
            "port_lm_iters": int(tinfo["lm_iters"]),
            "port_cg_total": int(tinfo["cg_iters"]),
            "port_cost_ratio": tinfo["cost0"] / tinfo["cost"],
        })
    print(json.dumps({"device": "cpu (jax " + jax.__version__ + ", torch "
                      + torch.__version__ + ")", "frames": args.frames,
                      "jax_run_s": run_s, "windows": windows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
