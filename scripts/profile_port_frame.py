"""Where the time of the PyTorch port's per-frame program goes.

    python3 scripts/profile_port_frame.py [--sensor rgbd|stereo] [--frames 40] [--window 5] [--local-ba]

Runs a configuration that ``chip_smoke.py`` drives over bench.py's
structured-wall scene on one CUDA card — ``--sensor rgbd`` (phase 2):
``System.track_rgbd`` of ``plvs_tpu_torch`` at 640x480, 1024 ORB features,
8 levels, 160 keylines, keyframe backend off; ``--sensor stereo`` (phase
3): ``System.track_stereo`` on rectified pairs at the same widths with
dense TSDF mapping and per-keyframe incremental meshing; ``--local-ba``
adds the synchronous keyframe backend (phase 4: ``local_ba=True`` with
bench.py's fixed BA shapes) — and prints:

* the per-frame wall time (host clock, synchronised), p50 and p90;
* the host time of each stage per frame, each stage synchronised at its
  ends: ORB frame build, line build, the tracking program (motion-model
  search + local-map search + pose solves), the pose solves within it,
  the dense stage (stereo: with its disparity and TSDF integration, the
  rest being the mesh), the keyframe backend, and the host bookkeeping
  that remains; plus pose solves and Gauss-Newton iterations per frame,
  dense-stage ms per keyframe, and with ``--local-ba`` the backend's stage
  ms per keyframe (culling, line triangulation, fuse, maintenance, local
  BA, keyframe culling; synchronised scopes);
* over a window of steady frames traced by ``torch.profiler``: device busy
  time per frame (sum of the durations of the device ops: kernels, copies
  and memsets), the device's idle share of the wall time, device ops per
  frame, the device ops and host ops that take the most time, and the
  launches per frame and device time per launch of the port's own kernels.

The last line is one JSON object with the headline numbers. Needs a CUDA
card; imports nothing of jax or plvs_tpu.
"""

from __future__ import annotations

import argparse
import collections
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


# the device kernels of csrc/*.cu (K1, K2, K3), by name
PORT_KERNELS = ("hamming_bmma_kernel", "cc_cluster_kernel", "stereo_band_kernel")


def _stage_timer(torch, totals, counts, name, fn):
    """Wrap ``fn`` so each call is synchronised at both ends and its host
    time accumulates under ``name``. A generator function (a staged pass)
    has each of its steps timed so, and counts once, when it ends."""
    def stages(gen):
        while True:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                wait, value = next(gen), None
            except StopIteration as stop:
                wait, value = stop, stop.value
            torch.cuda.synchronize()
            totals[name] += time.perf_counter() - t0
            if isinstance(wait, StopIteration):
                counts[name] += 1
                return value
            yield wait

    def wrapped(*a, **kw):
        if inspect.isgeneratorfunction(fn):
            return stages(fn(*a, **kw))
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
    ap.add_argument("--sensor", choices=("rgbd", "stereo"), default="rgbd")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--window", type=int, default=5,
                    help="steady frames traced by torch.profiler")
    ap.add_argument("--local-ba", action="store_true",
                    help="run the synchronous keyframe backend")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_port_frame: no CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from plvs_tpu_torch.dense import mapping
    from plvs_tpu_torch.dense.tsdf import TSDFVolume
    from plvs_tpu_torch.geometry import cameras, lie
    from plvs_tpu_torch.io import synthetic
    from plvs_tpu_torch.slam import System, SystemConfig, frame, tracking
    from plvs_tpu_torch.solvers import pose_opt
    from plvs_tpu_torch.utils.profiling import Stopwatch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())

    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    stereo = args.sensor == "stereo"
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=True, max_lines=160,
                       sensor=args.sensor, local_ba=args.local_ba,
                       loop_closing=False, dense_mapping=stereo,
                       dense_voxel_size=0.02, dense_mesh_every=1,
                       pipelined=False, depth_upload_decimation=2,
                       backend_fixed_shapes=args.local_ba)
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=420.0)
    shift = np.array([cam.bf / float(cam.params[0]), 0.0, 0.0], np.float32)
    # (timestamp, gray, depth or right image)
    frames = [(ts, g, scene.render(R, t - shift)[0] if stereo else d)
              for ts, g, d, R, t in scene.sequence(n_frames=args.frames)]

    def track(system, ts, a, b):
        if stereo:
            system.track_stereo(a, b, ts)
        else:
            system.track_rgbd(a, b, ts)

    system = System(cam, cfg, device="cuda")

    # -- pass 1: per-frame wall time, no instrumentation ---------------------
    wall = []
    for ts, a, b in frames:
        t0 = time.perf_counter()
        track(system, ts, a, b)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    steady = np.asarray(wall[1:])

    # -- pass 2: per-stage host time, each stage synchronised ----------------
    totals: dict[str, float] = collections.defaultdict(float)
    counts: dict[str, int] = collections.defaultdict(int)
    sfx = "_stereo" if stereo else "_rgbd"
    patches = [(frame, "build_frame" + sfx, "orb_frame"),
               (frame, "build_frame_lines" + ("_stereo" if stereo else ""),
                "line_frame"),
               (tracking, "_track_frame_tables", "tracking_program"),
               (pose_opt, "pose_optimize", "pose_solves"),
               (lie, "se3_exp", "gn_iterations"),
               (mapping.DenseMapper, "insert_stages", "dense_stage"),
               (mapping, "disparity", "dense_disparity"),
               (TSDFVolume, "integrate", "dense_integrate")]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, name in patches:
        setattr(mod, attr, _stage_timer(torch, totals, counts, name,
                                        getattr(mod, attr)))
    system2 = System(cam, cfg, device="cuda")
    watch = Stopwatch(sync_device=torch.device("cuda"))
    system2.set_stopwatch(watch)
    t_all = 0.0
    for ts, a, b in frames:
        t0 = time.perf_counter()
        track(system2, ts, a, b)
        torch.cuda.synchronize()
        t_all += time.perf_counter() - t0
    for mod, attr, fn in saved:
        setattr(mod, attr, fn)
    n = len(frames)
    stage_ms = {k: totals[k] / n * 1e3 for k in
                ("orb_frame", "line_frame", "tracking_program",
                 "pose_solves", "dense_stage")}
    backend_s = sum(watch.samples.get("local_mapping", []))
    stage_ms["keyframe_backend"] = backend_s / n * 1e3
    stage_ms["host_rest"] = (t_all / n * 1e3 - stage_ms["orb_frame"]
                             - stage_ms["line_frame"]
                             - stage_ms["tracking_program"]
                             - stage_ms["dense_stage"]
                             - stage_ms["keyframe_backend"])
    n_made = system2.store._next_kf_uid
    backend_ms_per_kf = {
        k: sum(v) / n_made * 1e3 for k, v in sorted(watch.samples.items())
        if k.startswith("lm.") or k == "local_mapping"}
    ba_log = system2.local_mapper.ba_log
    per_frame = {"pose_solves": counts["pose_solves"] / n,
                 "gn_iterations": counts["gn_iterations"] / n}
    n_kf = max(counts["dense_stage"], 1)
    dense_ms_per_kf = {k: totals[k] / n_kf * 1e3 for k in
                       ("dense_stage", "dense_disparity", "dense_integrate")}
    dense_ms_per_kf["dense_mesh_and_rest"] = (
        dense_ms_per_kf["dense_stage"] - dense_ms_per_kf["dense_disparity"]
        - dense_ms_per_kf["dense_integrate"])

    # -- pass 3: torch.profiler over a steady window -------------------------
    window = frames[-args.window:]
    system3 = System(cam, cfg, device="cuda")
    for ts, a, b in frames[:-args.window]:
        track(system3, ts, a, b)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for ts, a, b in window:
            track(system3, ts, a, b)
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
    if stereo:
        print(f"dense stage ms per keyframe ({counts['dense_stage']} "
              "keyframes): " + json.dumps(dense_ms_per_kf))
    if args.local_ba:
        print(f"keyframe backend ms per keyframe ({n_made} keyframes, "
              f"{len(ba_log)} local BA solves, LM iterations "
              f"{[b['lm_iters'] for b in ba_log]}, CG iterations "
              f"{[b['cg_iters'] for b in ba_log]}): "
              + json.dumps(backend_ms_per_kf))
    print(f"profiled window of {nw} frames: wall {win_s * 1e3 / nw} ms/frame "
          f"(profiler on), {np.mean(wall[-nw:])} ms/frame (profiler off), "
          f"device busy {busy_us / 1e3 / nw} ms/frame, "
          f"{len(kern) / nw} device ops/frame")
    print("top device ops by time (name, count/frame, ms/frame):")
    for name, (cnt, us) in sorted(by_kernel.items(),
                                  key=lambda kv: -kv[1][1])[:15]:
        print(f"  {name[:90]:90s} {cnt / nw:8.1f} {us / 1e3 / nw:9.4f}")
    port_kernels = {
        kname: {"launches_per_frame": cnt / nw, "us_per_launch": us / cnt}
        for name, (cnt, us) in by_kernel.items()
        for kname in PORT_KERNELS if kname in name}
    print("port kernels (launches/frame, device us per launch): "
          + json.dumps(port_kernels))
    print(prof.key_averages().table(sort_by="self_cpu_time_total",
                                    row_limit=15))
    # the profiler slows the host several-fold, so the idle share is taken
    # against the same frames' wall time in the uninstrumented pass 1
    idle = 1.0 - busy_us / 1e3 / float(np.sum(wall[-nw:]))
    idle_profiled = 1.0 - busy_us / 1e6 / win_s
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "card": smi.stdout.strip(),
        "sensor": args.sensor, "local_ba": args.local_ba, "frames": n,
        "wall_ms_p50": float(np.percentile(steady, 50)),
        "wall_ms_p90": float(np.percentile(steady, 90)),
        "stage_ms": stage_ms, **per_frame,
        **({"dense_ms_per_keyframe": dense_ms_per_kf,
            "keyframes": counts["dense_stage"]} if stereo else {}),
        **({"backend_ms_per_keyframe": backend_ms_per_kf,
            "keyframes_made": n_made, "local_ba_solves": len(ba_log)}
           if args.local_ba else {}),
        "device_busy_ms_per_frame": busy_us / 1e3 / nw,
        "device_idle_share": idle,
        "device_idle_share_profiled": idle_profiled,
        "device_ops_per_frame": len(kern) / nw,
        "port_kernels": port_kernels}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
