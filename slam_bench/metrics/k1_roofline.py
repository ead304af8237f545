"""K1's share of its roofline over the profiled span: the least time of
each launch (``roofline.k1_bound_ms`` at its (Q, K) shape, from the
program's ``ops.hamming.shapes`` counter diffed over the span) summed, over
the device time the profiler gives ``hamming_bmma_kernel``. Where the
profiler saw fewer launches than the counter (it drops an event now and
then), the bound is scaled to the launches it saw."""

UNIT = "%"
LAYER = "Kernels"
SOURCE = "device_trace"
MOVES = "frames_per_s"
KERNEL = "hamming_bmma_kernel"


def read(ctx):
    span = ctx["span"]
    shapes = span["k1_shapes"]
    n_launch = sum(shapes.values())
    n_seen, dev_s = ctx["trace"].kernel_time(span, KERNEL)
    if not n_launch or not n_seen or dev_s <= 0:
        return None
    bound_ms = sum(n * ctx["roofline"].k1_bound_ms(q, k)[0]
                   for (q, k), n in shapes.items())
    return 100.0 * bound_ms * 1e-3 * (n_seen / n_launch) / dev_s
