"""K2's share of its roofline over the profiled span: the launches (the
program's ``ops.cc_labels.launches`` diffed over the span), each at the
cell's line-image grid (half the image on each side), times
``roofline.k2_bound_ms``, over the device time the profiler gives
``cc_cluster_kernel``; scaled to the launches the profiler saw."""

UNIT = "%"
LAYER = "Kernels"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNEL = "cc_cluster_kernel"


def read(ctx):
    span = ctx["span"]
    n_launch = span["k2_launches"]
    n_seen, dev_s = ctx["trace"].kernel_time(span, KERNEL)
    if not n_launch or not n_seen or dev_s <= 0:
        return None
    h2, w2 = ctx["k2_shape"]
    bound_ms = ctx["roofline"].k2_bound_ms(h2, w2)[0]
    return 100.0 * bound_ms * 1e-3 * n_seen / dev_s
