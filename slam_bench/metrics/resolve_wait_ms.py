"""Host time the tracking thread spends blocked on the read-back of a
launched group of frames: the program's Stopwatch scope ``resolve.wait``
(``Tracker.resolve_batch``: the helper thread's future, or the inline
fetch) summed over the window, over the frames resolved in it. A program
without the scope gives nothing."""

UNIT = "ms/frame"
LAYER = "System facade and runtime"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    waits, n = ctx["stopwatch"].get("resolve.wait"), ctx["frames"]
    return sum(waits) / n * 1e3 if waits and n else None
