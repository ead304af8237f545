"""Host time to queue a frame's device program: the program's Stopwatch
scope ``resolve.launch`` (one per frame in ``Tracker._launch_group``:
decompression, ORB, lines, matching and the pose solves, the host reads
inside them included) summed over the window, over the frames resolved in
it. A program without the scope gives nothing."""

UNIT = "ms/frame"
LAYER = "Per-frame program"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    launches, n = ctx["stopwatch"].get("resolve.launch"), ctx["frames"]
    return sum(launches) / n * 1e3 if launches and n else None
