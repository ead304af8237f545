"""Host time of the stereo front end's points a resolved frame: the
program's Stopwatch scope ``frame.stereo_points`` (both ORB pyramids and the
left-right point match of ``build_frame_stereo``) summed over the window,
over the frames resolved in it. A program without the scope gives
nothing."""

UNIT = "ms/frame"
LAYER = "Per-frame program"
SOURCE = "program_span"
MOVES = "frames_per_s"
SCOPE = "frame.stereo_points"


def read(ctx):
    spans, n = ctx["stopwatch"].get(SCOPE), ctx["frames"]
    return sum(spans) / n * 1e3 if spans and n else None
