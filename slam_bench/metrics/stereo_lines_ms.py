"""Host time of the stereo front end's lines a resolved frame: the
program's Stopwatch scope ``frame.stereo_lines`` (both line extractions and
the left-right line match of ``build_frame_lines_stereo``) summed over the
window, over the frames resolved in it. A program without the scope gives
nothing."""

UNIT = "ms/frame"
LAYER = "Per-frame program"
SOURCE = "program_span"
MOVES = "frames_per_s"
SCOPE = "frame.stereo_lines"


def read(ctx):
    spans, n = ctx["stopwatch"].get(SCOPE), ctx["frames"]
    return sum(spans) / n * 1e3 if spans and n else None
