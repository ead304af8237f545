"""On the card: one session of the cell at its own size comes out correct,
and the lower-precision control (TF32 on for every float32 matmul and
convolution) does not. Skips without a CUDA card; on the card:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider \\
        -m cuda slam_bench/tests/test_bench_card.py -q
"""

import pytest

from slam_bench import harness
from slam_bench.tests import tiny

CELL = "tum2_rgbd.mapping"


def _card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _session(seed, tf32):
    return harness.run_cell(tiny.ROOT, CELL, seed, 600.0, False,
                            device="cuda", tf32=tf32, max_sessions=1)


@pytest.mark.cuda
def test_one_session_on_the_card_is_correct():
    _card()
    r = _session(2300000001, False)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0


@pytest.mark.cuda
def test_tf32_control_is_not_correct():
    _card()
    r = _session(2300000002, True)
    assert not r["correct"], r["checks"]
    c = r["checks"]["keyline_gap_p50_px"]
    assert c["value"] > c["limit"]
