"""Where the time of the PyTorch port's per-frame RGB-D program goes.

    python3 scripts/profile_port_frame.py [--frames 40] [--window 5]

Runs the configuration that ``chip_smoke.py`` drives (``System.track_rgbd``
of ``plvs_tpu_torch`` at 640x480, 1024 ORB features, 8 levels, 160
keylines, keyframe backend off) over bench.py's structured-wall scene on
one CUDA card, and prints:

* the per-frame wall time (host clock, synchronised), p50 and p90;
* the host time of each stage per frame, each stage synchronised at its
  ends: ORB frame build, line build, the tracking program (motion-model
  search + local-map search + pose solves), the pose solves within it, and
  the host bookkeeping that remains; plus pose solves and Gauss-Newton
  iterations per frame;
* over a window of steady frames traced by ``torch.profiler``: device busy
  time per frame (sum of the durations of the device ops: kernels, copies
  and memsets), the device's idle share of the wall time, device ops per
  frame, and the device ops and host ops that take the most time.

The last line is one JSON object with the headline numbers. Needs a CUDA
card; imports nothing of jax or plvs_tpu.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _stage_timer(torch, totals, counts, name, fn):
    """Wrap ``fn`` so each call is synchronised at both ends and its host
    time accumulates under ``name``."""
    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        totals[name] += time.perf_counter() - t0
        counts[name] += 1
        return out
    return wrapped


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--window", type=int, default=5,
                    help="steady frames traced by torch.profiler")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_port_frame: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from plvs_tpu_torch.geometry import cameras, lie
    from plvs_tpu_torch.io import synthetic
    from plvs_tpu_torch.slam import System, SystemConfig, frame, tracking
    from plvs_tpu_torch.solvers import pose_opt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())

    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=True, max_lines=160,
                       local_ba=False, loop_closing=False,
                       dense_mapping=False, pipelined=False,
                       depth_upload_decimation=2)
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=420.0)
    frames = list(scene.sequence(n_frames=args.frames))
    system = System(cam, cfg, device="cuda")

    # -- pass 1: per-frame wall time, no instrumentation ---------------------
    wall = []
    for ts, g, d, _, _ in frames:
        t0 = time.perf_counter()
        system.track_rgbd(g, d, ts)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    steady = np.asarray(wall[1:])

    # -- pass 2: per-stage host time, each stage synchronised ----------------
    totals: dict[str, float] = collections.defaultdict(float)
    counts: dict[str, int] = collections.defaultdict(int)
    patches = [(frame, "build_frame_rgbd", "orb_frame"),
               (frame, "build_frame_lines", "line_frame"),
               (tracking, "_track_frame_tables", "tracking_program"),
               (pose_opt, "pose_optimize", "pose_solves"),
               (lie, "se3_exp", "gn_iterations")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, name in patches:
        setattr(mod, attr, _stage_timer(torch, totals, counts, name,
                                        getattr(mod, attr)))
    system2 = System(cam, cfg, device="cuda")
    t_all = 0.0
    for ts, g, d, _, _ in frames:
        t0 = time.perf_counter()
        system2.track_rgbd(g, d, ts)
        torch.cuda.synchronize()
        t_all += time.perf_counter() - t0
    for mod, attr, fn in saved:
        setattr(mod, attr, fn)
    n = len(frames)
    stage_ms = {k: totals[k] / n * 1e3 for k in
                ("orb_frame", "line_frame", "tracking_program",
                 "pose_solves")}
    stage_ms["host_rest"] = (t_all / n * 1e3 - stage_ms["orb_frame"]
                             - stage_ms["line_frame"]
                             - stage_ms["tracking_program"])
    per_frame = {"pose_solves": counts["pose_solves"] / n,
                 "gn_iterations": counts["gn_iterations"] / n}

    # -- pass 3: torch.profiler over a steady window -------------------------
    window = frames[-args.window:]
    system3 = System(cam, cfg, device="cuda")
    for ts, g, d, _, _ in frames[:-args.window]:
        system3.track_rgbd(g, d, ts)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ts, g, d, _, _ in window:
            system3.track_rgbd(g, d, ts)
        torch.cuda.synchronize()
    win_s = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kern)
    by_kernel: dict[str, list] = collections.defaultdict(lambda: [0, 0.0])
    for e in kern:
        by_kernel[e.name][0] += 1
        by_kernel[e.name][1] += e.time_range.elapsed_us()
    nw = len(window)
    print(f"frames {n}; per-frame wall ms p50 {np.percentile(steady, 50)} "
          f"p90 {np.percentile(steady, 90)} (first frame {wall[0]})")
    print("host ms per frame by stage (each synchronised at its ends): "
          + json.dumps(stage_ms))
    print("per frame: " + json.dumps(per_frame))
    print(f"profiled window of {nw} frames: wall {win_s * 1e3 / nw} ms/frame "
          f"(profiler on), {np.mean(wall[-nw:])} ms/frame (profiler off), "
          f"device busy {busy_us / 1e3 / nw} ms/frame, "
          f"{len(kern) / nw} device ops/frame")
    print("top device ops by time (name, count/frame, ms/frame):")
    for name, (cnt, us) in sorted(by_kernel.items(),
                                  key=lambda kv: -kv[1][1])[:15]:
        print(f"  {name[:90]:90s} {cnt / nw:8.1f} {us / 1e3 / nw:9.4f}")
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=15))
    # the profiler slows the host several-fold, so the idle share is taken
    # against the same frames' wall time in the uninstrumented pass 1
    idle = 1.0 - busy_us / 1e3 / float(np.sum(wall[-nw:]))
    idle_profiled = 1.0 - busy_us / 1e6 / win_s
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": smi.stdout.strip(),
        "frames": n, "wall_ms_p50": float(np.percentile(steady, 50)),
        "wall_ms_p90": float(np.percentile(steady, 90)),
        "stage_ms": stage_ms, **per_frame,
        "device_busy_ms_per_frame": busy_us / 1e3 / nw,
        "device_idle_share": idle,
        "device_idle_share_profiled": idle_profiled,
        "device_ops_per_frame": len(kern) / nw}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
