"""Host time of place recognition and loop detection a keyframe made: the
program's Stopwatch scopes ``lc.*`` summed over the window, over the
keyframes the window's sessions made."""

UNIT = "ms/kf"
LAYER = "Place recognition and loop closing"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    sw, n = ctx["stopwatch"], ctx["keyframes"]
    total = sum(sum(v) for k, v in sw.items() if k.startswith("lc."))
    return total / n * 1e3 if n and total > 0 else None
