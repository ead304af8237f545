"""Host time of the keyframe backend a keyframe made: the program's
Stopwatch scopes ``lm.*`` summed over the window, over the keyframes the
window's sessions made."""

UNIT = "ms/kf"
LAYER = "Keyframe backend"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    sw, n = ctx["stopwatch"], ctx["keyframes"]
    total = sum(sum(v) for k, v in sw.items() if k.startswith("lm."))
    return total / n * 1e3 if n and total > 0 else None
