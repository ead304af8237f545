"""The stereo front end's spans and counters, and the benchmark's readers
of them.

``System.track_stereo`` opens ``frame.stereo_points`` (both ORB pyramids
and the left-right point match) and ``frame.stereo_lines`` (both line
extractions and the left-right line match) inside ``frame_build``, each
with the frame's sequence number, on the clock ``torch.profiler`` stamps
its events with. ``frame.stereo_counts()`` reads the keypoints and
keylines the stereo builders gave a depth (summed on the device, read
once); ``local_mapping.lines_made`` counts the line landmarks the backend
triangulates. The cases run a tiny copy of the benchmark's stereo cell
(``slam_bench/tests/tiny.py``: 320x240, 400 features, 6 frames of the
room orbit) on the CPU.
"""

import time

import pytest
import torch

from plvs_tpu_torch.slam import frame as frame_mod
from plvs_tpu_torch.utils.fetch import SyncFetch
from plvs_tpu_torch.utils.profiling import Stopwatch
from slam_bench import harness, registry, traffic
from slam_bench.tests import tiny

CELL = "euroc_stereo.mapping"
FRAMES = 6
SEED = 2 ** 31 + 57
STEREO = ("frame.stereo_points", "frame.stereo_lines")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tiny.make(str(tmp_path_factory.mktemp("tiny")), cell=CELL,
                     frames=FRAMES)
    cell = registry.load_cell(root, CELL, root + "/slam_bench")
    session = traffic.build_session(cell.traffic, cell.config, SEED)
    system = harness.build_system(cell, "cpu")
    system._submit_backend_fetch = SyncFetch()
    watch = Stopwatch()
    watch.spans = []
    system.set_stopwatch(watch)
    counts = [frame_mod.stereo_counts()]
    t0 = time.time_ns()
    for frame in session.frames:
        harness._feed(system, session.sensor, frame)
        counts.append(frame_mod.stereo_counts())
    t1 = time.time_ns()
    system.flush()
    system.shutdown()
    torch.set_num_threads(n)
    return watch, counts, (t0, t1)


def test_every_stereo_frame_has_both_spans_with_its_id(run):
    watch, _, (t0, t1) = run
    sp = watch.spans
    roots = [s for s in sp if s.name == "system.track_stereo"]
    assert [s.attrs["frame"] for s in roots] == list(range(FRAMES))
    for name in STEREO:
        got = [s for s in sp if s.name == name]
        assert [s.attrs["frame"] for s in got] == list(range(FRAMES))
        for s in got:
            assert t0 <= s.start_ns <= s.end_ns <= t1
            build = sp[s.parent]
            assert build.name == "frame_build"
            assert sp[build.parent].name == "system.track_stereo"
            assert sp[build.parent].attrs["frame"] == s.attrs["frame"]
    # the Stopwatch times each scope once a frame
    for name in STEREO:
        assert len(watch.samples[name]) == FRAMES


def test_stereo_counters_advance_every_frame(run):
    _, counts, _ = run
    for a, b in zip(counts, counts[1:]):
        assert b["stereo.points_matched"] - a["stereo.points_matched"] > 50
        assert b["stereo.lines_matched"] >= a["stereo.lines_matched"]
    assert counts[-1]["stereo.lines_matched"] > counts[0][
        "stereo.lines_matched"]


@pytest.mark.parametrize("name, scope", [
    ("stereo_points_ms", "frame.stereo_points"),
    ("stereo_lines_ms", "frame.stereo_lines"),
])
def test_readers_take_their_scope_per_resolved_frame(name, scope):
    mod = registry.load_reader(registry.HERE, name)
    assert (mod.UNIT, mod.LAYER, mod.SOURCE, mod.MOVES) == (
        "ms/frame", "Per-frame program", "program_span", "frames_per_s")
    ctx = {"stopwatch": {scope: [0.010, 0.030], "frame_build": [1.0]},
           "frames": 4}
    assert mod.read(ctx) == pytest.approx(10.0)
    # a program without the scope (the tree before it) gives nothing
    assert mod.read({"stopwatch": {"frame_build": [1.0]}, "frames": 4}) \
        is None
    assert mod.read({"stopwatch": {scope: [0.01]}, "frames": 0}) is None
