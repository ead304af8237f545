"""Host time of the dense stage a keyframe made: the program's Stopwatch
scopes ``dense.*`` summed over the window (a scope nested in another
measured ``dense.*`` scope, such as ``dense.mesh.extract`` in
``dense.mesh``, counts once, in its parent), over the keyframes the
window's sessions made."""

UNIT = "ms/kf"
LAYER = "Dense stage"
SOURCE = "program_span"
MOVES = "frames_per_s"


def read(ctx):
    sw, n = ctx["stopwatch"], ctx["keyframes"]
    names = [k for k in sw if k.startswith("dense.")]
    top = [k for k in names if k.rsplit(".", 1)[0] not in names]
    total = sum(sum(sw[k]) for k in top)
    return total / n * 1e3 if n and total > 0 else None
