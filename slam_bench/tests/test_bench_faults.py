"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run on the CPU (the harness's look for a
card skipped: ``run_cell(device="cpu")``) over a tiny copy of the cell
(320x240, 400 features, 10 frames), one session, with a fault of
``faults.py`` planted, and holds it to the cell's own committed limits
(``limits/<cell>.json``); the healthy run comes out correct under them."""

import pytest

from slam_bench import faults, harness, registry
from slam_bench.tests import tiny

@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(str(tmp_path_factory.mktemp("tiny")), frames=10)


def _run(root, planted):
    return harness.run_cell(root, "tum2_rgbd.mapping", 2 ** 31 + 11, 120.0,
                            False, device="cpu",
                            bench_dir=root + "/slam_bench", max_sessions=1,
                            faults=planted)


def test_healthy_run_is_correct(root):
    r = _run(root, [])
    assert r["correct"], r["checks"]
    assert r["attempted"] == 10 and r["failed"] == 0
    bench = registry.load_benchmark(root)
    assert set(r["metrics"]) == {m["name"] for m in bench["end_to_end"]}
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name, number", [
    ("pose_unchanged", "ate_mm_max"),
    ("depth_scaled", "points_p50_mm"),
    ("k1_altered", "k1_wrong"),
    ("k2_altered", "k2_wrong"),
    ("line_altered", "keyline_gap_px"),
])
def test_fault_makes_the_run_not_correct(root, name, number):
    r = _run(root, [faults.FAULTS[name]()])
    assert not r["correct"]
    c = r["checks"][number]
    assert c["value"] is None or c["value"] > c["limit"], r["checks"]
