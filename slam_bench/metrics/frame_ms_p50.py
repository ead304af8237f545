"""Median per-frame latency: from the start of a frame's ``track_*`` call
to the return of the call (or the flush or reset) after which its pose is in
``System.trajectory``, on the harness's clock, over the unprofiled frames of
the traced run's window."""

import numpy as np

UNIT = "ms"
LAYER = "System facade and runtime"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(ctx):
    lat = ctx["latencies_ms"]
    return float(np.percentile(lat, 50)) if lat else None
