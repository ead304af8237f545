"""95th-percentile per-frame latency over every unprofiled frame of the
traced run's window (not over chunks), measured as ``frame_ms_p50``."""

import numpy as np

UNIT = "ms"
LAYER = "System facade and runtime"
SOURCE = "host_clock"
MOVES = "frames_per_s"


def read(ctx):
    lat = ctx["latencies_ms"]
    return float(np.percentile(lat, 95)) if lat else None
