"""Stage timing: tick/tock stopwatch and per-stage statistics.

Counterpart of plvs_tpu/utils/profiling.py. Device work is asynchronous
under PyTorch too, so a scope may synchronise a device before it stops the
clock (``block_on``: the device whose queued work is charged to the stage);
a stopwatch made with ``sync_device`` synchronises that device at both ends
of every scope, so each stage holds its own device time.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np
import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Stopwatch:
    """Accumulates wall-time samples per named stage."""

    def __init__(self, sync_device=None):
        self.samples: dict[str, list[float]] = defaultdict(list)
        self._open: dict[str, float] = {}
        self.sync_device = sync_device

    def tick(self, name: str):
        _sync(self.sync_device)
        self._open[name] = time.perf_counter()

    def tock(self, name: str, block_on=None):
        _sync(block_on)
        _sync(self.sync_device)
        t0 = self._open.pop(name, None)
        if t0 is not None:
            self.samples[name].append(time.perf_counter() - t0)

    @contextlib.contextmanager
    def scope(self, name: str, block_on=None):
        self.tick(name)
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
