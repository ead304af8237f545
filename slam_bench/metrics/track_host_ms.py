"""Host time of the per-frame program a resolved frame: the program's
Stopwatch scopes ``frame_build`` + ``track`` + ``resolve`` (unsynchronised:
host time, device waits included) summed over the window, over the frames
resolved in it."""

UNIT = "ms/frame"
LAYER = "Per-frame program"
SOURCE = "program_span"
MOVES = "frames_per_s"
SCOPES = ("frame_build", "track", "resolve")


def read(ctx):
    sw, n = ctx["stopwatch"], ctx["frames"]
    total = sum(sum(sw.get(k, ())) for k in SCOPES)
    return total / n * 1e3 if n and total > 0 else None
