"""The device's idle share over the profiled frames: 1 - (union of the
device operations' intervals in the profiled span) / (host time of the same
frames in the unprofiled sessions of the same run's window), as
scripts/profile_port_frame.py takes it: the profiler slows the host, so its
own span would read idler."""

UNIT = "%"
LAYER = "Device"
SOURCE = "device_trace"
MOVES = "frames_per_s"


def read(ctx):
    wall = ctx["span_wall_unprofiled_s"]
    share = ctx["trace"].idle_share(ctx["span"]["busy_s"], wall)
    return None if share is None else 100.0 * share
