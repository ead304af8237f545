"""The port's asynchronous mapper actor (``async_mapping=True``), held to
tests/test_async.py's bounds for the JAX package's: the backend runs on its
own thread while the tracker goes on.

On the CPU, as in that file: the port tracks and maps (at least 2
keyframes, over 300 points, ATE under 5 cm); a keyframe frame costs at most
2.5 x a normal frame plus 20 ms at the median (the backend is not on the
tracking thread); the ATE stays within 2 x the synchronous run's (or 4 cm);
``shutdown()`` joins the actor's thread. Beyond that file: an exception in
the actor is raised on the tracking thread at the next keyframe insert,
and the deferred resolution runs with the actor too.
"""

import time

import numpy as np
import pytest
import torch

from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import evaluation, synthetic as tsyn
from plvs_tpu_torch.slam import System, SystemConfig
from plvs_tpu_torch.slam.tracking import OK

CAM = tcam.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                   bf=24.0)
FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread keeps this file from
    oversubscribing the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(async_mapping: bool, n_frames: int = 30, **kw):
    """tests/test_async.py's run: its scene (seed 1), its configuration,
    per-frame latency on the tracking thread and keyframe flags."""
    scene = tsyn.SyntheticRGBD(CAM, wall_z=3.0, seed=1)
    system = System(CAM, SystemConfig(**FLAGS, async_mapping=async_mapping,
                                      **kw), device="cpu")
    lat, kf_flags, gt, states = [], [], [], []
    n_kf_before = 0
    for ts, gray, depth, R_gt, t_gt in scene.sequence(n_frames=n_frames):
        t0 = time.perf_counter()
        state, _, _ = system.track_rgbd(gray, depth, ts)
        lat.append(time.perf_counter() - t0)
        states.append(int(state))
        n_kf = system.store._next_kf_uid
        kf_flags.append(n_kf > n_kf_before)
        n_kf_before = n_kf
        gt.append(-R_gt.T @ t_gt)
    if system.actor is not None:
        assert system.actor.wait_idle(120.0)
    traj = system.trajectory_tum()
    ate = evaluation.ate_rmse(traj[:, 1:4], np.stack(gt), align=True)
    return system, np.asarray(lat), np.asarray(kf_flags), ate, states


@pytest.fixture(scope="module")
def async_run():
    out = _run(async_mapping=True)
    yield out
    out[0].shutdown()


def test_tracks_and_maps(async_run):
    system, _, _, ate, states = async_run
    stats = system.map_statistics()
    assert all(s == OK for s in states[1:]), states
    assert stats["keyframes"] >= 2
    assert stats["points"] > 300
    assert ate < 0.05, ate
    # the actor ran the backend: one local BA per keyframe after the first
    assert len(system.local_mapper.ba_log) >= 1


def test_kf_latency_not_dominated_by_backend(async_run):
    """tests/test_async.py:59-69: after the first 5 frames, the median
    keyframe frame costs at most 2.5 x the median other frame + 20 ms."""
    _, lat, kf_flags, _, _ = async_run
    lat, kf_flags = lat[5:], kf_flags[5:]
    assert kf_flags.sum() > 0
    med_kf = np.median(lat[kf_flags])
    med_nokf = np.median(lat[~kf_flags])
    assert med_kf <= 2.5 * med_nokf + 0.02, (med_kf, med_nokf)


def test_matches_sync_quality(async_run):
    _, _, _, ate_async, _ = async_run
    _, _, _, ate_sync, _ = _run(async_mapping=False)
    assert ate_async <= max(ate_sync * 2.0, 0.04), (ate_async, ate_sync)


def test_shutdown_clean():
    system, *_ = _run(async_mapping=True, n_frames=12)
    system.shutdown()
    assert not system.actor.thread.is_alive()
    assert system.actor.idle()


def test_actor_error_raised_at_next_insert():
    """An exception inside the actor's backend pass is kept and raised on
    the tracking thread by the next keyframe insert; the actor carries on
    with later keyframes."""
    system = System(CAM, SystemConfig(**FLAGS, async_mapping=True),
                    device="cpu")
    try:
        def failing(kf_id, dense_payload=None):
            raise ValueError(f"backend failed on keyframe {kf_id}")

        system._backend_keyframe = failing
        actor = system.actor
        actor.insert_keyframe(3)
        assert actor.wait_idle(30.0)
        with pytest.raises(RuntimeError, match="keyframe 3"):
            actor.insert_keyframe(4)
        assert actor.wait_idle(30.0)
        with pytest.raises(RuntimeError, match="keyframe 4"):
            actor.insert_keyframe(5)
    finally:
        system.shutdown()
    assert not system.actor.thread.is_alive()


def test_pipelined_with_the_actor():
    """bench.py's realtime combination on the CPU: deferred resolution at
    depth 4 with the overlap thread and the actor (tests/test_pipelined.py
    ::test_combined_with_async_mapper's bounds)."""
    system, _, _, ate, states = _run(async_mapping=True, pipelined=True,
                                     pipeline_depth=4)
    try:
        assert len(system.trajectory) == 30
        assert all(s == OK for s in states[1:]), states
        assert ate < 0.05, ate
        assert system.store.num_keyframes >= 2
        assert not system.tracker._pending and not system._backend_q
    finally:
        system.shutdown()
