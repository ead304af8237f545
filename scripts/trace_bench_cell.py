"""Where the per-frame program's time goes in a ``slam_bench`` cell, read
from the program's own spans (``Stopwatch.spans``) and a ``torch.profiler``
trace on the same clock.

    python3 scripts/trace_bench_cell.py [--workload tum2_rgbd.mapping] [--seeds 11 12] [--seconds 51]

Needs one CUDA card. Builds the cell's System, session and warm-up as
``slam_bench/run.py`` does, then:

1. for each seed, four windows of ``--seconds`` in the benchmark's closed
   loop (``harness.run_window``) with the spans off, on, on, off: the
   frames/s of each (the cost of recording spans);
2. over the span-on windows: ``resolve.wait`` and ``resolve.launch`` ms a
   resolved frame, the Gauss-Newton iterations, pose solves and pose
   kernel launches a resolved frame (``pose_opt.iteration_count()``,
   ``solves`` and ``kernel_solves`` diffed over the window), the stereo
   builders' matched keypoints and keylines a resolved frame
   (``frame.stereo_counts()``) and the line landmarks the backend's
   triangulation made a keyframe (``local_mapping.lines_made``),
   ``track_host_ms`` as the benchmark reads it, and the backend time nested
   inside ``resolve`` (from the spans' parent links);
3. last, the benchmark's profiled span (a fresh session of the first
   seed, the mix's ``profile_frames`` under the profiler, spans on): CUDA launch calls,
   blocking calls and device ms a launched frame (``slam_bench/spans.py``),
   the device's idle time in the span and the share of it that spans of
   the tracking thread cover, with the profiler's host operations during
   the rest, and the longest idle gaps named by the innermost span; on a
   stereo cell also the launch and blocking calls a frame under
   ``frame.stereo_points`` and ``frame.stereo_lines``.

The last line on standard output is one JSON object with every number.
Imports nothing of jax or plvs_tpu.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _window(system, session, seconds, probe, spans_on):
    """One benchmark window from a reset System; returns its numbers and
    its stopwatch."""
    from plvs_tpu_torch.slam import frame as frame_mod
    from plvs_tpu_torch.slam import local_mapping
    from plvs_tpu_torch.solvers import pose_opt
    from plvs_tpu_torch.utils.profiling import Stopwatch
    from slam_bench import harness

    system.reset()
    watch = Stopwatch()
    if spans_on:
        watch.spans = []
    system.set_stopwatch(watch)
    it0 = pose_opt.iteration_count()
    so0, ks0 = pose_opt.solves, pose_opt.kernel_solves
    st0, lm0 = frame_mod.stereo_counts(), local_mapping.lines_made
    logs, t0, t1 = harness.run_window(system, session, seconds, probe, watch)
    frames = sum(len(log.t_done) for log in logs)
    keyframes = sum(log.keyframes for log in logs)
    sw = watch.samples
    out = {"frames": frames, "window_s": t1 - t0,
           "frames_per_s": frames / (t1 - t0)}
    if spans_on:
        from slam_bench import spans

        def per(seconds):
            return seconds / frames * 1e3

        track = sum(sum(sw.get(k, ())) for k in spans.PROGRAM)
        nested = spans.nested_backend_s(watch.spans)
        out.update(
            resolve_wait_ms=per(sum(sw.get("resolve.wait", ()))),
            launch_host_ms=per(sum(sw.get("resolve.launch", ()))),
            gn_iters_per_frame=(pose_opt.iteration_count() - it0) / frames,
            solves_per_frame=(pose_opt.solves - so0) / frames,
            kernel_solves_per_frame=(pose_opt.kernel_solves - ks0) / frames,
            track_host_ms=per(track),
            **{k.replace(".", "_") + "_per_frame": (v - st0[k]) / frames
               for k, v in frame_mod.stereo_counts().items()},
            lines_made_per_kf=((local_mapping.lines_made - lm0) / keyframes
                               if keyframes else None),
            backend_in_resolve_ms=per(nested),
            stage_ms={k: per(sum(v)) for k, v in sorted(sw.items())},
            span_records=len(watch.spans))
    return out


def _profiled(system, session, traffic, probe):
    """The benchmark's profiled span with the spans on, joined with the
    trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from plvs_tpu_torch.utils.profiling import Stopwatch
    from slam_bench import harness, spans, trace

    a, b = traffic["profile_frames"]
    system.reset()
    watch = Stopwatch()
    system.set_stopwatch(watch)
    for frame in session.frames[:a]:
        harness._feed(system, session.sensor, frame)
    watch.spans = []
    tid = threading.get_native_id()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        for frame in session.frames[a:b]:
            harness._feed(system, session.sensor, frame)
        torch.cuda.synchronize()
        t1 = time.time_ns()
    sp = list(watch.spans)
    watch.spans = None
    system.flush()
    probe.take()
    runtime, device = spans.profiler_rows(prof)
    got = spans.join(sp, runtime, device, tid)
    n = max(got["frames"], 1)
    iv = trace._union(np.asarray([(s, e) for _, s, e, _ in device],
                                 np.int64).reshape(-1, 2))
    iv = iv[(iv[:, 1] > t0) & (iv[:, 0] < t1)] if len(iv) else iv
    edges = [t0] + [x for s, e in iv for x in (s, e)] + [t1]
    gaps = [(max(s, t0), min(e, t1)) for s, e in zip(edges[::2], edges[1::2])
            if min(e, t1) > max(s, t0)]
    idle_ns = sum(e - s for s, e in gaps)
    covered = spans.covered_share(gaps, sp, tid)
    # what the host did in the idle time no span of the tracking thread
    # covers: the innermost profiled host operation at each piece's middle
    host = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() != torch.autograd.DeviceType.CUDA]
    hs = np.asarray([h[1] for h in host], np.int64)
    he = np.asarray([h[2] for h in host], np.int64)
    rest = collections.Counter()
    for s, e in spans.uncovered(gaps, sp, tid):
        mid = (s + e) // 2
        cov = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = (host[cov[np.argmin(he[cov] - hs[cov])]][0] if len(cov)
                else "no_op")
        rest[name] += (e - s) * 1e-6
    at = spans.innermost(sp, tid, [(s + e) // 2 for s, e in gaps])
    named = collections.Counter()
    for (s, e), i in zip(gaps, at):
        named[sp[i].name if i >= 0 else "untimed"] += (e - s) * 1e-6
    busy_ns = int((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0
    stereo = _stereo_calls(sp, runtime, tid)
    return {
        **stereo,
        "frames_fed": b - a, "frames_launched": got["frames"],
        "track_launches_per_frame": got["launches"] / n,
        "track_syncs_per_frame": got["syncs"] / n,
        "track_device_ms": got["device_s"] * 1e3 / n,
        "launches_per_frame_by_span": {k: v / n for k, v in
                                       got["launches_by_span"].items()},
        "syncs_per_frame_by_span": {k: v / n for k, v in
                                    got["syncs_by_span"].items()},
        "span_s": (t1 - t0) * 1e-9, "busy_s": busy_ns * 1e-9,
        "idle_s": idle_ns * 1e-9, "idle_covered_share": covered,
        "idle_uncovered_ms_by_host_op": dict(rest.most_common(8)),
        "idle_ms_by_innermost_span": dict(named.most_common(12)),
        "runtime_calls": len(runtime), "device_ops": len(device)}


STEREO_SPANS = ("frame.stereo_points", "frame.stereo_lines")


def _stereo_calls(sp, runtime, tid) -> dict:
    """Launch and blocking calls of the tracking thread a frame inside each
    stereo front-end span (the frames: its ``frame.stereo_points``
    spans); nothing where the cell tracks no stereo frame."""
    from slam_bench import spans

    frames = sum(1 for s in sp if s.name == STEREO_SPANS[0]
                 and s.thread == tid)
    if not frames:
        return {}
    under = np.full(len(sp), -1, np.int64)  # the stereo span above, by index
    for i, s in enumerate(sp):
        if s.name in STEREO_SPANS:
            under[i] = STEREO_SPANS.index(s.name)
        elif s.parent >= 0:
            under[i] = under[s.parent]
    mine = [r for r in runtime if r[3] == tid]
    at = spans.innermost(sp, tid, [r[1] for r in mine])
    launches = collections.Counter()
    syncs = collections.Counter()
    for r, i in zip(mine, at):
        if i < 0 or under[i] < 0:
            continue
        name = STEREO_SPANS[under[i]]
        if spans.LAUNCH.match(r[0]):
            launches[name] += 1
        elif spans.SYNC.match(r[0]):
            syncs[name] += 1
    return {"stereo_frames": frames,
            "stereo_launches_per_frame": {k: launches[k] / frames
                                          for k in STEREO_SPANS},
            "stereo_syncs_per_frame": {k: syncs[k] / frames
                                       for k in STEREO_SPANS}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", default="tum2_rgbd.mapping")
    ap.add_argument("--seeds", type=int, nargs="+", default=[11, 12])
    ap.add_argument("--seconds", type=float, default=51.0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("trace_bench_cell: no CUDA card", file=sys.stderr)
        return 2
    from plvs_tpu_torch.ops import _build
    from slam_bench import harness, registry, traffic

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cell = registry.load_cell(ROOT, args.workload)
    harness.set_precision(cell.config)
    _build.build_all()
    system = harness.build_system(cell, "cuda")
    probe = harness.Probe(system)
    result = {"card": card, "workload": args.workload, "windows": []}
    for k, seed in enumerate(args.seeds):
        session = traffic.build_session(cell.traffic, cell.config, seed)
        if k == 0:
            for frame in session.frames[:int(cell.traffic["warmup_frames"])]:
                harness._feed(system, session.sensor, frame)
        for spans_on in (False, True, True, False):
            w = _window(system, session, args.seconds, probe, spans_on)
            w.update(seed=seed, spans_on=spans_on)
            print(json.dumps(w), flush=True)
            result["windows"].append(w)
    # last: a profiler session leaves the process slower
    session = traffic.build_session(cell.traffic, cell.config, args.seeds[0])
    result["profiled"] = _profiled(system, session, cell.traffic, probe)
    print(json.dumps(result["profiled"]), flush=True)
    system.shutdown()
    fps = {on: [w["frames_per_s"] for w in result["windows"]
                if w["spans_on"] == on] for on in (False, True)}
    result["frames_per_s_off"] = fps[False]
    result["frames_per_s_on"] = fps[True]
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
