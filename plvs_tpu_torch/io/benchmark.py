"""Sequence benchmark harness: the median ATE of N runs with the lost-frame
gate, per-frame track times, and CPU / RSS sampling.

    python -m plvs_tpu_torch.io.benchmark --synthetic --runs 10
    python -m plvs_tpu_torch.io.benchmark --tum DIR --settings cfg.yaml

Counterpart of plvs_tpu/io/benchmark.py (the reference's Benchmarking/
protocol: N runs a sequence, runs with more than 5% lost frames discarded,
more than 2 discarded runs fail the sequence). ``main`` builds the port's
System on ``--device`` (``cuda`` by default; it raises without CUDA rather
than run on the CPU). A track time is the host wall time of one
``track_*`` call ended by a synchronisation of the System's CUDA device,
so it holds the frame's device work.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Callable

import numpy as np
import torch

from . import evaluation
from .datasets import associate


class ResourceSampler:
    """Samples this process's CPU% and RSS on a background thread."""

    def __init__(self, interval: float = 0.5):
        self.interval = interval
        self.cpu: list[float] = []
        self.rss_mb: list[float] = []
        self._stop = threading.Event()
        self._thread = None

    @staticmethod
    def _read_proc():
        with open("/proc/self/stat") as f:
            parts = f.read().split()
        utime, stime = int(parts[13]), int(parts[14])
        rss_pages = int(parts[23])
        hz = os.sysconf("SC_CLK_TCK")
        page = os.sysconf("SC_PAGE_SIZE")
        return (utime + stime) / hz, rss_pages * page / 1e6

    def _loop(self):
        last_cpu, _ = self._read_proc()
        last_t = time.perf_counter()
        while not self._stop.wait(self.interval):
            cpu_s, rss = self._read_proc()
            now = time.perf_counter()
            self.cpu.append(100.0 * (cpu_s - last_cpu) / max(now - last_t, 1e-6))
            self.rss_mb.append(rss)
            last_cpu, last_t = cpu_s, now

    def __enter__(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=2.0)

    def stats(self):
        if not self.cpu:
            return {"cpu_mean": 0.0, "cpu_std": 0.0,
                    "ram_mb_mean": 0.0, "ram_mb_std": 0.0}
        return {
            "cpu_mean": float(np.mean(self.cpu)),
            "cpu_std": float(np.std(self.cpu)),
            "ram_mb_mean": float(np.mean(self.rss_mb)),
            "ram_mb_std": float(np.std(self.rss_mb)),
        }


@dataclasses.dataclass
class RunResult:
    """One benchmark run."""

    ate_rmse: float
    lost_frac: float
    track_ms: list[float]  # per-frame track wall times
    resources: dict | None = None


def run_sequence_benchmark(
    run_once: Callable[[int], RunResult],
    n_runs: int = 10,
    lost_gate: float = 0.05,
    max_failed: int = 2,
    warmup: bool = False,
) -> dict:
    """Run a sequence ``n_runs`` times and aggregate: median and sigma of
    the ATE over the runs that pass the lost-frame gate (more than
    ``max_failed`` gated runs fail the sequence), mean and std of the
    per-frame track time over the kept runs.

    ``run_once(seed)`` executes one full SLAM run and returns a RunResult.
    ``warmup=True`` runs the sequence once untimed first, so the per-frame
    track times leave out first-call costs (kernel builds, allocator
    growth). Only opt in when ``run_once`` takes an extra seed: callers
    that feed a finite iterator must leave it off."""
    if warmup:
        run_once(n_runs)  # a seed the timed runs never use
    results = [run_once(i) for i in range(n_runs)]
    stats = evaluation.benchmark_statistics(
        [r.ate_rmse for r in results], [r.lost_frac for r in results],
        lost_gate=lost_gate, max_failed=max_failed)
    kept = [r for r in results if r.lost_frac <= lost_gate]
    tt = np.concatenate([np.asarray(r.track_ms) for r in kept]) if kept \
        else np.zeros(0)
    out = {
        **stats,
        "n_runs": n_runs,
        "track_ms_mean": float(tt.mean()) if tt.size else float("nan"),
        "track_ms_std": float(tt.std()) if tt.size else float("nan"),
        "fps_mean": float(1000.0 / tt.mean()) if tt.size else float("nan"),
        "lost_fracs": [r.lost_frac for r in results],
        "rmses": [r.ate_rmse for r in results],
    }
    res = [r.resources for r in kept if r.resources]
    if res:
        out["cpu_mean"] = float(np.mean([r["cpu_mean"] for r in res]))
        out["ram_mb_mean"] = float(np.mean([r["ram_mb_mean"] for r in res]))
    return out


def run_system_once(system_factory, frame_iter_factory, gt_xyz=None,
                    gt_ts=None, sample_resources: bool = True) -> RunResult:
    """Drive one System over a frame iterator, timing each track call
    through a synchronisation of the System's device when it is CUDA.

    ``frame_iter_factory()`` yields (ts, *images) tuples; the system's
    matching ``track_*`` method is chosen by tuple arity (3 = RGB-D or
    stereo per system.config.sensor, 2 = monocular).
    """
    system = system_factory()
    track_ms = []
    lost = 0
    n = 0
    sampler = ResourceSampler() if sample_resources else None
    with sampler or contextlib.nullcontext():
        for tup in frame_iter_factory():
            ts, imgs = tup[0], tup[1:]
            t0 = time.perf_counter()
            if len(imgs) == 1:
                state, _, _ = system.track_monocular(imgs[0], ts)
            elif system.config.sensor == "stereo":
                state, _, _ = system.track_stereo(imgs[0], imgs[1], ts)
            else:
                state, _, _ = system.track_rgbd(imgs[0], imgs[1], ts)
            if system.device.type == "cuda":
                torch.cuda.synchronize(system.device)
            track_ms.append((time.perf_counter() - t0) * 1e3)
            lost += int(state in (3, 5))  # LOST or RECENTLY_LOST
            n += 1
    rmse = float("nan")
    if gt_xyz is not None and n:
        traj = system.trajectory_tum()
        gt_xyz = np.asarray(gt_xyz)
        if gt_ts is not None:
            pairs = associate(traj[:, 0], np.asarray(gt_ts), max_dt=0.05)
            if len(pairs) >= 3:
                ei = np.asarray([p[0] for p in pairs])
                gi = np.asarray([p[1] for p in pairs])
                rmse = evaluation.ate_rmse(traj[ei, 1:4], gt_xyz[gi],
                                           align=True)
        else:
            m = min(len(traj), len(gt_xyz))
            rmse = evaluation.ate_rmse(traj[:m, 1:4], gt_xyz[:m], align=True)
    return RunResult(rmse, lost / max(n, 1), track_ms,
                     sampler.stats() if sampler else None)




def main(argv=None):
    """CLI: N runs of the synthetic sequence or a TUM RGB-D sequence; prints
    the aggregate as JSON."""
    import argparse

    from ..geometry import cameras
    from ..slam import System, SystemConfig

    ap = argparse.ArgumentParser(description="plvs_tpu_torch sequence "
                                             "benchmark")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--tum", type=str, default=None)
    ap.add_argument("--settings", type=str, default=None)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the System (cuda by default)")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    if args.settings:
        from ..slam.settings import Settings

        st = Settings.from_yaml(args.settings)
        cam, cfg = st.camera, st.config
    else:
        cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320,
                              height=240, bf=24.0)
        cfg = SystemConfig(num_features=512, n_levels=4)

    def make():
        return System(cam, cfg, device=device)

    if args.synthetic:
        from . import synthetic

        def run_once(seed: int) -> RunResult:
            scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, seed=seed)
            frames = list(scene.sequence(n_frames=args.frames))
            gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
            return run_system_once(
                make, lambda: [(ts, g, d) for ts, g, d, _, _ in frames],
                gt_xyz=gt)
    elif args.tum:
        from .datasets import TumRGBD

        ds = TumRGBD(args.tum)
        gt = ds.groundtruth()

        def run_once(seed: int) -> RunResult:
            return run_system_once(
                make, lambda: ds.frames(),
                gt_xyz=gt[:, 1:4] if gt is not None else None,
                gt_ts=gt[:, 0] if gt is not None else None)
    else:
        ap.error("choose --synthetic or --tum")

    report = run_sequence_benchmark(run_once, n_runs=args.runs, warmup=True)
    print(json.dumps(report, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
