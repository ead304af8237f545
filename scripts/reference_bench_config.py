"""The JAX package's figures on bench.py's configuration, for the port's
chip-smoke phases 7 and 8.

Runs ``plvs_tpu``'s System with bench.py's settings (``bench.py:60-90``
with its environment defaults: 640x480, 1024 features, 8 levels, scale
1.2, ``max_kf=256``, ``max_pts=65536``, lines with ``max_lines=160``,
local BA, loop closing, dense mapping at 2 cm, ``backend_fixed_shapes``,
``pipelined`` with ``pipeline_depth=4`` and ``pipeline_overlap``, and the
interleaved keyframe backend) on the CPU, calls ``flush()`` and prints one
JSON line: the tracking states, the ATE, the live map, the occupied
voxels and mesh triangles at the end, the loops closed, the interleaved
backend's ``_stage_stats`` and its largest backlog.

Without options it runs 120 frames of bench.py's structured-wall scene
(phase 7). ``--room`` runs the room orbit of phase 5 instead
(``SyntheticRoom(half=3, tex_size=2048, seed=3)``,
``orbit_loop_trajectory(132, radius=1, laps=1.375)``, depth noise
N(0, 0.01) d^2 from ``default_rng(1000 + i)``), points only
(``use_lines=False``). ``--async`` adds ``async_mapping=True``, bench.py's
``PLVS_BENCH_ASYNC=1`` path (phase 8 is ``--room --async``). With the
helper threads on, which frames resolve together and when a backend stage
resumes follow timing, so a run is one sample.

``--inline`` takes both timing decisions out: ``pipeline_overlap=False``
and the interleaved backend's fetches made inline (patched onto the
System's instance, as tests/test_torch_pipelined.py does), so every fetch
is complete when it is polled. The run is then deterministic, and its
schedule is the one the port's run on the card takes: there every fetch of
phase 7 was done by the next poll (``_stage_stats`` all "ready"), while on
the CPU the JAX backend's fetches lag and a third of the stages resume on
their deadline or by force. Phase 7 holds the port to this run.

``--settled`` makes each launch of the tracker's per-frame programs return
only once their outputs are computed (``jax.block_until_ready`` after
``Tracker._launch_group`` and ``_dispatch_fused``), as a launch of the
port's per-frame program does on the card: its pose solves read the
inlier count back every Gauss-Newton iteration. JAX on the CPU otherwise
returns from a launch at once and computes in the background, so the next
frame finds the fetch still running and extrapolates across it; that
decides which frames resolve together, and with it the candidates and the
keyframes.

``--first N`` tracks only the first N poses of the wall's sweep of
``--frames`` poses (the same step).

    JAX_PLATFORMS=cpu python scripts/reference_bench_config.py [--room] [--async] [--inline] [--settled] [--frames N] [--first N]
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
    ap.add_argument("--room", action="store_true",
                    help="the room orbit, points only (phase 8's scene)")
    ap.add_argument("--async", dest="async_", action="store_true",
                    help="async_mapping=True (the mapper actor)")
    ap.add_argument("--inline", action="store_true",
                    help="no overlap thread, inline backend fetches")
    ap.add_argument("--settled", action="store_true",
                    help="per-frame launches return with their outputs "
                         "computed")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--first", type=int, default=None,
                    help="track only the first N poses of the wall's sweep")
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from plvs_tpu.dense import meshing
    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import evaluation, synthetic
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.slam.local_mapping import _SyncFetch
    from plvs_tpu.slam.tracking import OK

    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=not args.room, max_lines=160,
                       local_ba=True, loop_closing=True, dense_mapping=True,
                       dense_voxel_size=0.02, backend_fixed_shapes=True,
                       async_mapping=args.async_, pipelined=True,
                       pipeline_depth=4, pipeline_overlap=not args.inline)
    system = System(cam, cfg)
    if args.inline:
        system._submit_backend_fetch = _SyncFetch()
    backlog = [0]
    enqueue = system._enqueue_backend

    def recording_enqueue(kf_id, dense_payload=None):
        backlog[0] = max(backlog[0], len(system._backend_q) + 1)
        return enqueue(kf_id, dense_payload)

    system._enqueue_backend = recording_enqueue
    if args.settled:
        tr = system.tracker
        launch, dispatch = tr._launch_group, tr._dispatch_fused

        def settled_launch(group):
            launch(group)
            jax.block_until_ready([c["out"] for c in group])

        def settled_dispatch(*a, **kw):
            ctx = dispatch(*a, **kw)
            if ctx is not None:
                jax.block_until_ready(ctx["out"])
            return ctx

        tr._launch_group = settled_launch
        tr._dispatch_fused = settled_dispatch

    if args.room:
        room = synthetic.SyntheticRoom(cam, half=3.0, tex_size=2048, seed=3)
        poses = synthetic.orbit_loop_trajectory(132, radius=1.0, laps=1.375)
        frames = []
        for i, (ts, g, d, R, t) in enumerate(
                room.sequence(poses[:args.frames])):
            rng = np.random.default_rng(1000 + i)
            d = d + rng.normal(0, 0.01, d.shape).astype(np.float32) * d ** 2
            frames.append((ts, g, d, R, t))
    else:
        tex = synthetic.make_structured_texture(
            2048, rng=np.random.default_rng(7))
        scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                        tex_scale=420.0)
        frames = list(scene.sequence(synthetic.default_trajectory(
            args.frames or 120)[:args.first]))
    states = []
    t0 = time.perf_counter()
    for ts, gray, depth, _, _ in frames:
        state, _, _ = system.track_rgbd(gray, depth, ts)
        states.append(int(state))
    system.flush()
    wall = time.perf_counter() - t0
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    dm = system.dense_mapper
    _, faces = meshing.marching_tetrahedra(dm.volume)
    out = {
        "device": "cpu (jax " + jax.__version__ + ")",
        "scene": "room" if args.room else "wall",
        "async_mapping": args.async_,
        "inline": args.inline,
        "settled": args.settled,
        "frames": len(states),
        "resolved": len(system.trajectory),
        "all_ok_after_first": all(s == OK for s in states[1:]),
        "not_ok": [i for i, s in enumerate(states) if s != OK],
        "ate_rmse_m": evaluation.ate_rmse(est, gt, align=True),
        "map": system.map_statistics(),
        "keyframes_made": int(system.store._next_kf_uid),
        "dense": {"occupied": int(len(dm.cloud()[0])),
                  "triangles": int(len(faces))},
        "loops": [{"kf": int(k), "candidate": int(info["candidate"]),
                   "inliers": int(info["inliers"])}
                  for k, info in system.loops_closed],
        "stage_stats": dict(system._stage_stats),
        "max_backlog": backlog[0],
        "wall_s": wall,
    }
    system.shutdown()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
