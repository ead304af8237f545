"""Stage timing: tick/tock stopwatch, per-stage statistics and span records.

Counterpart of plvs_tpu/utils/profiling.py. Device work is asynchronous
under PyTorch too, so a scope may synchronise a device before it stops the
clock (``block_on``: the device whose queued work is charged to the stage);
a stopwatch made with ``sync_device`` synchronises that device at both ends
of every scope, so each stage holds its own device time.

While ``Stopwatch.spans`` is a list, every scope also appends a
:class:`Span` to it: its interval on ``time.time_ns`` (the clock
``torch.profiler`` stamps its events with, so a span can be laid over a
profiler trace), the enclosing scope open on the same thread, the thread's
OS id (the id the profiler's CUDA runtime events carry) and the scope's
attributes (``frame``: the tracker's sequence number of the frame the scope
works on; ``kf``: the keyframe's uid). ``spans`` is None by default, and
then nothing is recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import defaultdict

import numpy as np
import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(slots=True)
class Span:
    """One scope's record: ``parent`` is the index in ``Stopwatch.spans``
    of the innermost scope open on the same thread when it started (-1 at
    a root); ``end_ns`` is None while it is open."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int
    thread: int
    attrs: dict


class Stopwatch:
    """Accumulates wall-time samples per named stage (and span records
    while ``spans`` is a list)."""

    def __init__(self, sync_device=None):
        self.samples: dict[str, list[float]] = defaultdict(list)
        self.spans: list[Span] | None = None
        self.sync_device = sync_device
        # per thread: the open scopes, innermost last, each
        # [name, perf_counter start, Span | None, index in spans]
        self._stacks: dict[int, list] = {}
        self._lock = threading.Lock()

    def _stack(self) -> list:
        return self._stacks.setdefault(threading.get_ident(), [])

    def tick(self, name: str):
        _sync(self.sync_device)
        stack = self._stack()
        spans = self.spans
        rec, idx = None, -1
        if spans is not None:
            parent = next((e[3] for e in reversed(stack) if e[2] is not None),
                          -1)
            rec = Span(name, time.time_ns(), None, parent,
                       threading.get_native_id(), {})
            with self._lock:
                idx = len(spans)
                spans.append(rec)
        stack.append([name, time.perf_counter(), rec, idx])

    def tock(self, name: str, block_on=None):
        _sync(block_on)
        _sync(self.sync_device)
        t1 = time.perf_counter()
        stack = self._stack()
        for i in range(len(stack) - 1, -1, -1):
            if stack[i][0] == name:
                _, t0, rec, _ = stack.pop(i)
                if rec is not None:
                    rec.end_ns = time.time_ns()
                self.samples[name].append(t1 - t0)
                return

    @contextlib.contextmanager
    def scope(self, name: str, block_on=None, **attrs):
        """Time the block as stage ``name``; ``attrs`` go into its span."""
        self.tick(name)
        if attrs and self.spans is not None:
            rec = self._stack()[-1][2]
            if rec is not None:
                rec.attrs.update(attrs)
        try:
            yield
        finally:
            self.tock(name, block_on)

    def stats(self) -> dict[str, dict]:
        out = {}
        for k, v in self.samples.items():
            a = np.asarray(v)
            out[k] = {"mean_ms": float(a.mean() * 1e3),
                      "std_ms": float(a.std() * 1e3),
                      "median_ms": float(np.median(a) * 1e3),
                      "total_ms": float(a.sum() * 1e3),
                      "count": len(a)}
        return out

    def report(self) -> str:
        """Per-stage table: mean, median and std ms and the count."""
        lines = [f"{'stage':<28}{'mean ms':>10}{'median':>10}{'std':>10}{'n':>7}"]
        for k, s in sorted(self.stats().items()):
            lines.append(
                f"{k:<28}{s['mean_ms']:>10.2f}{s['median_ms']:>10.2f}"
                f"{s['std_ms']:>10.2f}{s['count']:>7}"
            )
        return "\n".join(lines)

    def reset(self):
        """Drop the samples, the open scopes and the recorded spans."""
        self.samples.clear()
        self._stacks.clear()
        if self.spans is not None:
            self.spans.clear()
