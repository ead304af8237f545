"""Relocalization: the port's lost-state machine and keyframe-database
recovery against the JAX package's, on tests/test_slam_e2e.py's kidnapped
camera (a blackout of blank frames mid-sweep) and its RECENTLY_LOST grace
case, both packages fed the same rendered frames.

Both must give the same per-frame tracking states (exactly: the states
follow from frame counts, timestamps and whether relocalization succeeds on
the first frame after the blackout), and the final camera centres must lie
within 0.1 m of each other and of ground truth (the test_slam_e2e bound;
the two RANSACs draw different samples, so the poses are not equal).
"""

import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam.tracking import LOST, OK, RECENTLY_LOST

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384,
             loop_closing=False, max_kf_interval=4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread keeps this file from
    oversubscribing the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(system, frames, blackout):
    a, b = blackout
    states = []
    for i, (ts, gray, depth, _, _) in enumerate(frames):
        if a <= i < b:
            gray, depth = np.zeros_like(gray), np.zeros_like(depth)
        states.append(int(system.track_rgbd(gray, depth, ts)[0]))
    _, R, t = system.trajectory[-1]
    return states, -R.T @ t


def _both(seed, n_frames, blackout, tracker_kw=None):
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                               seed=seed)
    frames = list(scene.sequence(poses=tsyn.default_trajectory(n_frames)))
    out = []
    for system in (JSystem(jcam.pinhole(*CAM_ARGS, **CAM_KW), JConfig(**FLAGS)),
                   TSystem(tcam.pinhole(*CAM_ARGS, **CAM_KW), TConfig(**FLAGS),
                           device="cpu")):
        for k, v in (tracker_kw or {}).items():
            setattr(system.tracker, k, v)
        out.append(_run(system, frames, blackout))
    R, t = frames[-1][3], frames[-1][4]
    return out, -R.T @ t


def test_kidnapped_camera_recovers_like_jax():
    """Blank frames 15-19 of a 30-frame sweep on a young map: LOST, then
    relocalized on the first frame after the blackout."""
    ((js, jc), (ts, tc)), c_gt = _both(7, 30, (15, 20))
    assert ts == js, (ts, js)
    assert LOST in ts[14:22] and all(s == OK for s in ts[23:]), ts
    assert np.linalg.norm(tc - jc) < 0.1
    assert np.linalg.norm(tc - c_gt) < 0.1, np.linalg.norm(tc - c_gt)
    assert np.linalg.norm(jc - c_gt) < 0.1


def test_recently_lost_grace_then_lost_like_jax():
    """A mature map (3 keyframes here) enters RECENTLY_LOST, falls to LOST
    when the 4.5-frame deadline passes inside a 12-frame blackout, and
    relocalizes once the view returns."""
    ((js, jc), (ts, tc)), c_gt = _both(
        9, 34, (16, 28), dict(min_kf_recently_lost=3,
                              time_recently_lost=4.5 / 30.0))
    assert ts == js, (ts, js)
    assert ts[16] == RECENTLY_LOST and LOST not in ts[16:20], ts
    assert LOST in ts[20:28] and OK in ts[28:], ts
    assert np.linalg.norm(tc - jc) < 0.1
    assert np.linalg.norm(tc - c_gt) < 0.1


def test_lost_state_machine_matches_jax():
    """The lost-state machine alone, both trackers fed the same outcomes
    (every relocalization attempt fails): RECENTLY_LOST until the deadline,
    then LOST; after ``new_map_after_lost`` LOST frames on a map of 5
    keyframes a new map of the atlas starts and the tracker waits to
    initialize; a map of 4 keyframes is kept."""
    from plvs_tpu.slam import map_store as jms
    from plvs_tpu.slam import tracking as jtr
    from plvs_tpu_torch.slam import map_store as tms
    from plvs_tpu_torch.slam import tracking as ttr

    def tracker(mod, ms, cam, n_kf, **kw):
        st = ms.MapStore(max_kf=16, max_pts=64, n_kp=8)
        for _ in range(n_kf):
            st.kf_mask[st.alloc_kf()] = True
        tr = mod.Tracker(cam, st, new_map_after_lost=3, **kw)
        tr.time_recently_lost = 0.1
        tr._relocalize = lambda fr, ts: mod.TrackResult(
            tr.state, tr.R, tr.t, 0, np.full((4,), -1))
        return tr

    for n_kf in (5, 4):
        out = []
        for tr in (tracker(jtr, jms, jcam.pinhole(*CAM_ARGS, **CAM_KW), n_kf),
                   tracker(ttr, tms, tcam.pinhole(*CAM_ARGS, **CAM_KW), n_kf,
                           device="cpu")):
            tr.state, tr._lost_ts = RECENTLY_LOST, 0.0
            seq = []
            for i in range(10):
                state = tr.process_frame(None, i / 30.0).state
                seq.append((int(state), int(tr.state), tr.lost_frames,
                            tr.store.active_map, tr.store.n_maps))
                if tr.state not in (LOST, RECENTLY_LOST):
                    break
            out.append(seq)
        assert out[1] == out[0], (n_kf, out)
        states = [s[1] for s in out[1]]
        assert states[:3] == [RECENTLY_LOST] * 3 and LOST in states
        assert (out[1][-1][3:] == (1, 2)) == (n_kf == 5), out[1]
