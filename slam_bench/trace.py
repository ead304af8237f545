"""One profiled span of a traced run, reduced to what the per-layer readers
and the result's ``breakdown`` need.

The method is scripts/profile_port_frame.py's (:225-272): ``torch.profiler``
over a few steady frames gives the device operations; the profiler slows
the host several-fold, so the device's idle share is taken against the wall
time of the same frames in an unprofiled session (``idle_share``). Device
busy time is the union of the device operations' intervals (kernels, copies
and memsets), so two overlapping operations count once.
"""

from __future__ import annotations

import collections
import time

import numpy as np


def _union(iv: np.ndarray) -> np.ndarray:
    """Sorted, merged [M, 2] intervals of [N, 2] (start, end) rows."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return np.asarray(out, np.int64)


def idle_share(busy_s: float, wall_s: float) -> float | None:
    """1 - busy / wall, as a share in [0, 1]; None without a wall time."""
    if not wall_s or wall_s <= 0:
        return None
    return 1.0 - busy_s / wall_s


def _events(prof):
    """(device rows [(name, start_ns, end_ns)], host rows [(name, start_ns,
    end_ns)]) of a finished profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            dev.append((e.name(), start, end))
        else:
            host.append((e.name(), start, end))
    return dev, host


def profile_span(run_frames, host_log: list | None = None,
                 cuda: bool = True) -> dict:
    """Profile ``run_frames()`` (device synchronised at both ends) and
    reduce it: busy seconds, the span's wall seconds, device time and count
    by operation name, and the longest idle gaps named by the host activity
    during them (the benchmark's stopwatch scope from ``host_log`` [(name,
    start_ns, end_ns)] on ``time.time_ns``, then the innermost profiled host
    operation). ``cuda`` False profiles the host alone (the CPU tests)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_frames()
        sync()
        t1 = time.perf_counter()
    dev, host = _events(prof)
    by_name: dict = collections.defaultdict(lambda: [0, 0])
    for name, s, e in dev:
        by_name[name][0] += 1
        by_name[name][1] += e - s
    iv = _union(np.asarray([(s, e) for _, s, e in dev], np.int64)
                .reshape(-1, 2))
    busy_ns = int((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0
    gaps = []
    if len(iv) > 1:
        g_start, g_end = iv[:-1, 1], iv[1:, 0]
        order = np.argsort(-(g_end - g_start), kind="stable")[:10]
        h_name = [h[0] for h in host]
        h_s = np.asarray([h[1] for h in host], np.int64)
        h_e = np.asarray([h[2] for h in host], np.int64)
        log = host_log or []
        for i in order:
            mid = (int(g_start[i]) + int(g_end[i])) // 2
            scope = "untimed"
            best = None
            for name, s, e in log:
                if s <= mid <= e and (best is None or e - s < best):
                    scope, best = name, e - s
            op = "no_op"
            if len(h_s):
                cov = np.nonzero((h_s <= mid) & (h_e >= mid))[0]
                if len(cov):
                    op = h_name[cov[np.argmin(h_e[cov] - h_s[cov])]]
            gaps.append([f"{scope}|{op}", (int(g_end[i]) - int(g_start[i]))
                         * 1e-9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "busy_s": busy_ns * 1e-9,
        "window_s": t1 - t0,
        "by_name": {k: (v[0], v[1] * 1e-9) for k, v in by_name.items()},
        "breakdown": {"device_ops": [[k, v[1] * 1e-9] for k, v in top],
                      "idle_gaps": gaps},
    }


def kernel_time(span: dict, kernel: str):
    """(launches seen, device seconds) of the operations whose name holds
    ``kernel``."""
    n, s = 0, 0.0
    for name, (cnt, sec) in span["by_name"].items():
        if kernel in name:
            n += cnt
            s += sec
    return n, s
