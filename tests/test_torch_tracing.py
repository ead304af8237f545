"""The port's spans: the Stopwatch's span records, the scopes the per-frame
program and the runtime open, the pose solve's counters, and the
benchmark's join of spans with a profiler trace (``slam_bench/spans.py``).

The System cases run a tiny copy of the benchmark's RGB-D cell on the CPU
(``slam_bench/tests/tiny.py``: 320x240, 400 features, 12 frames, its
pipelined runtime at depth 4 with the interleaved backend, local BA, loop
detection and dense mapping), with the two timing decisions taken out (the
overlap thread off, the backend's fetches inline) so that the same frames
resolve together in every run.
"""

import threading

import pytest
import torch

from plvs_tpu_torch.geometry import cameras as cam_mod
from plvs_tpu_torch.geometry import lie
from plvs_tpu_torch.solvers import pose_opt
from plvs_tpu_torch.utils.fetch import SyncFetch
from plvs_tpu_torch.utils.profiling import Span, Stopwatch
from slam_bench import harness, registry, spans, traffic
from slam_bench.tests import tiny

FRAMES = 12
SEED = 2 ** 31 + 29
# the scopes a run of the tiny cell opens (name: count) before the program
# had spans: what the same run of the parent tree counts, spans off
OLD_COUNTS = {"dense.integrate": 2, "dense.mesh": 4, "dense.mesh.dirty": 2,
              "dense_mapping": 6, "frame_build": 1, "lc.bow_add": 2,
              "lc.detect": 2, "lm.await": 3, "lm.ba": 3, "lm.cull": 2,
              "lm.cull_kf": 2, "lm.fuse": 1, "lm.maint": 4,
              "local_mapping": 6, "loop_closing": 2, "resolve": 25,
              "track": 12}
# the scopes the spans brought
NEW_NAMES = {"system.track_rgbd", "system.flush", "frame.pack",
             "resolve.launch", "resolve.wait", "resolve.finish", "frame.orb",
             "frame.lines", "frame.match_pose"}


# -- the Stopwatch's records ---------------------------------------------------

def test_span_records_have_parent_links():
    sw = Stopwatch()
    sw.spans = []
    with sw.scope("outer", frame=3):
        with sw.scope("inner"):
            pass
        with sw.scope("inner", kf=1):
            pass
    with sw.scope("second_root"):
        pass
    names = [(s.name, s.parent, s.attrs) for s in sw.spans]
    assert names == [("outer", -1, {"frame": 3}), ("inner", 0, {}),
                     ("inner", 0, {"kf": 1}), ("second_root", -1, {})]
    for s in sw.spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        assert s.thread == threading.get_native_id()
    outer, a, b, _ = sw.spans
    assert outer.start_ns <= a.start_ns and b.end_ns <= outer.end_ns
    assert {k: len(v) for k, v in sw.samples.items()} == {
        "outer": 1, "inner": 2, "second_root": 1}


def test_nested_same_name_scopes_each_close():
    sw = Stopwatch()
    sw.spans = []
    with sw.scope("resolve"):
        with sw.scope("resolve"):
            pass
    outer, inner = sw.spans
    assert inner.parent == 0 and outer.parent == -1
    assert outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns
    assert len(sw.samples["resolve"]) == 2
    assert sw.samples["resolve"][1] >= sw.samples["resolve"][0]


def test_second_thread_scope_stays_out_of_the_main_tree():
    sw = Stopwatch()
    sw.spans = []
    entered, leave = threading.Event(), threading.Event()

    def helper():
        with sw.scope("helper"):
            entered.set()
            leave.wait(10.0)

    with sw.scope("main"):
        th = threading.Thread(target=helper)
        th.start()
        assert entered.wait(10.0)
        with sw.scope("main.child"):
            pass
        leave.set()
        th.join(10.0)
    assert not th.is_alive()
    by = {s.name: s for s in sw.spans}
    assert by["helper"].parent == -1
    assert by["main.child"].parent == sw.spans.index(by["main"])
    assert by["helper"].thread != by["main"].thread
    assert all(s.end_ns is not None for s in sw.spans)


def test_spans_off_records_nothing_and_reset_drops_spans():
    sw = Stopwatch()
    with sw.scope("a", frame=1):
        pass
    assert sw.spans is None and len(sw.samples["a"]) == 1
    sw.spans = []
    sw.tick("open")
    with sw.scope("b"):
        pass
    sw.reset()
    assert sw.spans == [] and not sw.samples
    sw.tock("open")          # its tick went with the reset
    assert not sw.samples


def test_span_contains_the_op_it_encloses_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile

    sw = Stopwatch()
    sw.spans = []
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with sw.scope("matmul"):
            y = x @ x
    assert y.shape == (256, 256)
    span = sw.spans[0]
    ops = [e for e in prof.profiler.kineto_results.events()
           if e.name() in ("aten::mm", "aten::matmul")]
    assert ops
    for e in ops:
        assert span.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= span.end_ns


# -- the pose solve's counters -------------------------------------------------

def _pose_problem(noise: float, seed: int = 3):
    cam = cam_mod.pinhole(500.0, 500.0, 160.0, 120.0, width=320, height=240,
                          bf=40.0)
    g = torch.Generator().manual_seed(seed)
    n = 60
    Xw = torch.cat([torch.rand(n, 2, generator=g) * 4 - 2,
                    torch.rand(n, 1, generator=g) * 2 + 3], 1)
    R = torch.eye(3)
    t = torch.zeros(3)
    uv = cam_mod.project(cam, Xw)
    uR = uv[:, :1] - 40.0 / Xw[:, 2:]
    uvr = torch.cat([uv, uR], 1)
    uvr = uvr + noise * torch.randn(uvr.shape, generator=g)
    lines = pose_opt.empty_lines()
    obs = pose_opt.PoseObs(Xw, uvr, torch.ones(n), torch.ones(n, dtype=bool),
                           *lines)
    return cam, R, t, obs


@pytest.mark.parametrize("noise, start", [(0.0, "truth"), (0.5, "offset")])
def test_pose_opt_counts_the_iterations_it_ran(noise, start):
    cam, R, t, obs = _pose_problem(noise)
    if start == "offset":
        dR, dt = lie.se3_exp(torch.tensor([0.01, -0.02, 0.01, 0.05, 0.02,
                                           -0.03]))
        R, t = lie.se3_compose(dR, dt, R, t)
    ran = []
    exp = pose_opt.lie.se3_exp

    def counted(dx):
        ran.append(1)
        return exp(dx)

    it0, s0 = pose_opt.iterations, pose_opt.solves
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pose_opt.lie, "se3_exp", counted)
        pose_opt.pose_optimize(cam, R, t, obs)
    assert pose_opt.solves - s0 == 1
    assert pose_opt.iterations - it0 == len(ran) > 0
    if start == "truth":
        # the step at the truth is negligible: every round breaks early
        assert len(ran) < 4 * 10


# -- the System's scopes -------------------------------------------------------

def _tiny_run(root, watch, spans_on: bool):
    """The tiny cell's frames through a fresh System on the CPU; returns
    (the seqs resolved through the deferred path, the seqs queued by the
    packed path)."""
    cell = registry.load_cell(root, "tum2_rgbd.mapping",
                              root + "/slam_bench")
    session = traffic.build_session(cell.traffic, cell.config, SEED)
    system = harness.build_system(cell, "cpu")
    system._submit_backend_fetch = SyncFetch()
    system.set_stopwatch(watch)
    if spans_on:
        watch.spans = []
    tr = system.tracker
    resolved, packed = [], []
    on_resolved, process_packed = tr.on_resolved, tr.process_frame_packed

    def record_resolved(res, ts, seq=None):
        resolved.append(seq)
        return on_resolved(res, ts, seq)

    def record_packed(*a, **kw):
        seq = tr.frame_id
        res = process_packed(*a, **kw)
        if res is not None:
            packed.append(seq)
        return res

    tr.on_resolved = record_resolved
    tr.process_frame_packed = record_packed
    for frame in session.frames:
        harness._feed(system, session.sensor, frame)
    system.flush()
    system.shutdown()
    return resolved, packed


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    root = tiny.make(str(tmp_path_factory.mktemp("tiny")), frames=FRAMES,
                     config_over={"SystemConfig.pipeline_overlap": False})
    off = harness.make_stopwatch(Stopwatch)
    off.log = []
    got_off = _tiny_run(root, off, False)
    on = Stopwatch()
    got_on = _tiny_run(root, on, True)
    torch.set_num_threads(n)
    return off, got_off, on, got_on


def test_harness_stopwatch_sees_every_scope(runs):
    off, *_ = runs
    assert off.spans is None
    logged = {}
    for name, s, e in off.log:
        assert s <= e
        logged[name] = logged.get(name, 0) + 1
    assert logged == {k: len(v) for k, v in off.samples.items()}


def test_old_scopes_keep_their_counts(runs):
    off, _, on, _ = runs
    counts = {k: len(v) for k, v in off.samples.items()}
    old = {k: n for k, n in counts.items() if k not in NEW_NAMES}
    assert old == OLD_COUNTS
    assert set(counts) - set(old) <= NEW_NAMES
    # turning the spans on records, and times, the same scopes
    assert {k: len(v) for k, v in on.samples.items()} == counts
    assert len(on.spans) == sum(counts.values())


def test_every_resolved_frame_has_one_finish_and_its_launch(runs):
    *_, on, (resolved, packed) = runs
    assert resolved and packed
    finish = [s.attrs["frame"] for s in on.spans if s.name == "resolve.finish"]
    launch = [s.attrs["frame"] for s in on.spans if s.name == "resolve.launch"]
    assert sorted(finish) == sorted(resolved)
    assert len(set(finish)) == len(finish)
    assert sorted(launch) == sorted(packed)
    assert set(packed) <= set(resolved)
    tracked = [s.attrs["frame"] for s in on.spans
               if s.name == "system.track_rgbd"]
    assert tracked == list(range(FRAMES))


def test_frame_spans_nest_under_their_launch(runs):
    *_, on, _ = runs
    sp = on.spans
    for s in sp:
        if s.name in ("frame.orb", "frame.lines", "frame.match_pose"):
            assert sp[s.parent].name == "resolve.launch"
        if s.name == "resolve.launch":
            assert sp[s.parent].name in ("resolve", "track")
        if s.name in ("resolve.wait", "resolve.finish"):
            assert sp[s.parent].name == "resolve"
        if s.name in ("local_mapping", "dense_mapping", "loop_closing"):
            assert "kf" in s.attrs
    roots = {s.name for s in sp if s.parent == -1}
    assert roots <= {"system.track_rgbd", "system.flush"}


def test_backend_nested_in_resolve_is_seen_through_parent_links(runs):
    *_, on, _ = runs
    nested = spans.nested_backend_s(on.spans)
    top = sum((s.end_ns - s.start_ns) * 1e-9 for s in on.spans
              if s.name == "resolve")
    assert 0 < nested < top


# -- the join with a trace (slam_bench/spans.py) -------------------------------

def _span(name, s, e, parent=-1, thread=1, **attrs):
    return Span(name, s, e, parent, thread, attrs)


def _synthetic():
    """The tracking thread (1) resolving one frame: a launch span with two
    launches and a read, a wait, a finish holding a local-mapping stage
    with a launch and a read of its own; a helper thread (2) reads too."""
    sp = [_span("system.track_rgbd", 0, 1000, frame=5),      # 0
          _span("resolve", 10, 900, 0),                       # 1
          _span("resolve.launch", 20, 300, 1, frame=5),       # 2
          _span("frame.match_pose", 100, 290, 2),             # 3
          _span("resolve.wait", 310, 400, 1, frames=1),       # 4
          _span("resolve.finish", 410, 890, 1, frame=5),      # 5
          _span("local_mapping", 500, 800, 5, kf=2),          # 6
          _span("lm.ba", 600, 700, 6)]                        # 7
    runtime = [("cudaLaunchKernel", 30, 35, 1, 101),
               ("cudaLaunchKernelExC", 150, 155, 1, 102),
               ("cudaStreamSynchronize", 200, 210, 1, 103),
               ("cudaMemcpyAsync", 320, 325, 1, 104),
               ("cudaStreamSynchronize", 330, 390, 1, 105),
               ("cudaLaunchKernel", 550, 555, 1, 106),
               ("cudaStreamSynchronize", 650, 660, 1, 107),
               ("cudaStreamSynchronize", 340, 350, 2, 108),
               ("cudaLaunchKernel", 40, 45, 2, 109),
               ("cudaLaunchKernel", 950, 955, 1, 110)]
    device = [("k_a", 40, 60, 101), ("k_b", 160, 200, 102),
              ("copy", 330, 331, 104), ("k_lm", 560, 600, 106),
              ("k_helper", 60, 70, 109)]
    return sp, runtime, device


def test_join_counts_launches_inside_the_frames_launch():
    sp, runtime, device = _synthetic()
    got = spans.join(sp, runtime, device, thread=1)
    assert got["frames"] == 1
    # the two kernel launches in resolve.launch; not the wait's copy, the
    # backend's launch, the helper's or the one after the resolve
    assert got["launches"] == 2
    assert got["launches_by_span"] == {"resolve.launch": 1,
                                       "frame.match_pose": 1}
    assert got["device_s"] == pytest.approx((20 + 40) * 1e-9)


def test_join_counts_reads_of_the_program_but_not_of_helpers_or_backend():
    sp, runtime, device = _synthetic()
    got = spans.join(sp, runtime, device, thread=1)
    # the read in match_pose and the wait's; not the helper thread's, not
    # the one nested in local_mapping under resolve.finish
    assert got["syncs"] == 2
    assert got["syncs_by_span"] == {"frame.match_pose": 1, "resolve.wait": 1}
    assert spans.join(sp, runtime, device, thread=2)["syncs"] == 0


def test_nested_backend_and_idle_cover_on_synthetic_spans():
    sp, _, _ = _synthetic()
    assert spans.nested_backend_s(sp) == pytest.approx(300e-9)
    assert spans.covered_share([(900, 1100)], sp, thread=1) == \
        pytest.approx(0.5)
    assert spans.covered_share([(0, 10)], sp, thread=2) == 0.0
    at = spans.innermost(sp, 1, [5, 150, 650, 1500])
    assert list(at) == [0, 3, 7, -1]
