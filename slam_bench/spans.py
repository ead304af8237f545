"""The program's spans laid over a ``torch.profiler`` trace: CUDA runtime
calls and device operations counted inside the per-frame program's spans.

The spans are ``plvs_tpu_torch.utils.profiling.Span`` records (or any rows
with the same fields: name, start_ns, end_ns, parent, thread, attrs) that a
Stopwatch keeps while its ``spans`` is a list. They are stamped on
``time.time_ns``, the clock of the profiler's events, and carry the OS id
of their thread: the id the profiler gives the CUDA runtime calls of the
thread that started it (``device_resource_id``). The runtime calls of other
threads carry another id there, so they never join a span.

Rows, as :func:`profiler_rows` reads them from a finished profile:

* runtime rows ``(name, start_ns, end_ns, thread, correlation)``: the host
  side of every CUDA API call (`cuda*` and `cu*`);
* device rows ``(name, start_ns, end_ns, correlation)``: kernels, copies
  and memsets; a device row shares its correlation id with the runtime call
  that queued it.

A runtime call belongs to the innermost span open on its thread at its
start; it is inside a span when that span or one of its ancestors is.
"""

from __future__ import annotations

import collections
import re

import numpy as np

# host-side calls that queue work on the device
LAUNCH = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel|cudaMemcpyAsync$"
                    r"|cudaMemsetAsync$)")
# calls that block the host until the device has drained (a synchronous
# cudaMemcpy included)
SYNC = re.compile(r"^(cuda\w*Synchronize|cudaMemcpy)$")
# CUDA API names (`cuda*` and `cu*`), as the profiler lists them
RUNTIME = re.compile(r"^cu(da)?[A-Z]")

# the per-frame program (track_host_ms's scopes) and the span of one
# frame's launch inside it
PROGRAM = ("frame_build", "track", "resolve")
LAUNCH_SPAN = "resolve.launch"
# the keyframe backend's scopes, which run nested in a resolve
BACKEND = ("local_mapping", "dense_mapping", "loop_closing", "global_ba",
           "map_objects", "map_objects.detect")
BACKEND_PREFIX = ("lm.", "lc.", "dense.")


def is_backend(name: str) -> bool:
    return name in BACKEND or name.startswith(BACKEND_PREFIX)


def profiler_rows(prof):
    """(runtime rows, device rows) of a finished ``torch.profiler``
    profile."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    runtime, device = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == cuda:
            device.append((e.name(), start, end, e.correlation_id()))
        elif RUNTIME.match(e.name()):
            runtime.append((e.name(), start, end, e.device_resource_id(),
                            e.correlation_id()))
    return runtime, device


def flags(spans) -> dict:
    """Per span index: inside the per-frame program (``program``), inside a
    backend scope (``backend``), inside a frame's launch (``launch``), and
    the outermost backend span (``backend_top``). A parent precedes its
    children in ``spans``."""
    n = len(spans)
    out = {k: np.zeros(n, bool)
           for k in ("program", "backend", "launch", "backend_top")}
    for i, s in enumerate(spans):
        p = s.parent
        for key, own in (("program", s.name in PROGRAM),
                         ("backend", is_backend(s.name)),
                         ("launch", s.name == LAUNCH_SPAN)):
            out[key][i] = own or (p >= 0 and out[key][p])
        out["backend_top"][i] = (is_backend(s.name)
                                 and not (p >= 0 and out["backend"][p]))
    return out


def innermost(spans, thread: int, times) -> np.ndarray:
    """For each time in ``times``: the index of the innermost span of
    ``thread`` open at it, or -1. Spans of one thread nest (scopes are
    context managers); a span still open counts as open to the end."""
    big = np.iinfo(np.int64).max
    own = [(s.start_ns, big if s.end_ns is None else s.end_ns, i)
           for i, s in enumerate(spans) if s.thread == thread]
    # by start; at a tie, the outer (longer) span first
    own.sort(key=lambda r: (r[0], -r[1]))
    times = np.asarray(times, np.int64)
    order = np.argsort(times, kind="stable")
    out = np.full(len(times), -1, np.int64)
    stack, j = [], 0
    for k in order:
        t = times[k]
        while j < len(own) and own[j][0] <= t:
            while stack and stack[-1][1] < own[j][0]:
                stack.pop()
            stack.append(own[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[k] = stack[-1][2]
    return out


def join(spans, runtime, device, thread: int) -> dict:
    """Over one profiled stretch, on ``thread`` (the tracking thread's OS
    id): the frames launched (``resolve.launch`` spans), the launch calls
    inside them, the blocking calls inside the per-frame program but not
    nested under a backend scope (each also counted under the name of its
    innermost span), and the device seconds of the operations the launches
    inside ``resolve.launch`` queued."""
    f = flags(spans)
    frames = sum(1 for s in spans
                 if s.name == LAUNCH_SPAN and s.thread == thread)
    mine = [r for r in runtime if r[3] == thread]
    at = innermost(spans, thread, [r[1] for r in mine])
    launches, syncs = collections.Counter(), collections.Counter()
    corr = set()
    for r, i in zip(mine, at):
        if i < 0:
            continue
        if LAUNCH.match(r[0]) and f["launch"][i]:
            launches[spans[i].name] += 1
            corr.add(r[4])
        elif SYNC.match(r[0]) and f["program"][i] and not f["backend"][i]:
            syncs[spans[i].name] += 1
    device_ns = sum(e - s for _, s, e, c in device if c in corr)
    return {"frames": frames, "launches": sum(launches.values()),
            "syncs": sum(syncs.values()), "device_s": device_ns * 1e-9,
            "launches_by_span": dict(launches), "syncs_by_span": dict(syncs)}


def nested_backend_s(spans, under: str = "resolve") -> float:
    """Seconds of the outermost backend spans that run inside a span named
    ``under`` (the backend time a per-frame scope also holds)."""
    f = flags(spans)
    inside = np.zeros(len(spans), bool)
    for i, s in enumerate(spans):
        p = s.parent
        inside[i] = s.name == under or (p >= 0 and inside[p])
    return sum((s.end_ns - s.start_ns) * 1e-9 for i, s in enumerate(spans)
               if f["backend_top"][i] and inside[i] and s.end_ns is not None)


def uncovered(gaps, spans, thread: int) -> list:
    """The pieces of the intervals ``gaps`` [(start_ns, end_ns)], sorted and
    disjoint (the device's idle stretches), that no span of ``thread``
    covers."""
    merged = []
    for s, e in sorted((s.start_ns, s.end_ns) for s in spans
                       if s.thread == thread and s.end_ns is not None):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    out, j = [], 0
    for gs, ge in gaps:
        while j < len(merged) and merged[j][1] <= gs:
            j += 1
        t, k = gs, j
        while k < len(merged) and merged[k][0] < ge:
            if merged[k][0] > t:
                out.append((t, merged[k][0]))
            t = max(t, merged[k][1])
            k += 1
        if t < ge:
            out.append((t, ge))
    return out


def covered_share(gaps, spans, thread: int) -> float | None:
    """The share of ``gaps`` (as :func:`uncovered` takes them) that some
    span of ``thread`` covers."""
    total = sum(e - s for s, e in gaps)
    if not total:
        return None
    return 1.0 - sum(e - s for s, e in uncovered(gaps, spans, thread)) / total
