"""Map reuse in the port against the JAX package: tests/test_map_reuse.py's
four scenarios through both packages.

One module fixture runs the JAX package's 40-frame RGB-D session at
320x240 / 512 features (local BA and loop closing on, as in the JAX test)
and saves its atlas. Each scenario loads that file into a JAX System and a
port System (``device="cpu"``) of the same configuration and replays the
same frames through both. The port is held to JAX's state sequence, its
first OK frame, and its median camera-centre error + 1 cm (the two
packages' float32 pose solves agree to a few mm, not bit for bit).
"""

import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.io import serialization as jser
from plvs_tpu.io import synthetic as jsyn
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu.slam.map_store import MapStore as JStore
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import serialization as tser
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam.map_store import MapStore as TStore
from plvs_tpu_torch.slam.tracking import LOST, OK, RELOCALIZE_IN_LOADED_MAP

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
CFG = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def saved_session(tmp_path_factory):
    """The JAX package's 40-frame session, saved with shutdown()."""
    cam = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    scene = jsyn.SyntheticRGBD(cam, wall_z=3.0, seed=3)
    system = JSystem(cam, JConfig(**CFG))
    for ts, gray, depth, _, _ in scene.sequence(
            poses=jsyn.default_trajectory(40)):
        system.track_rgbd(gray, depth, ts)
    path = str(tmp_path_factory.mktemp("reuse") / "atlas.npz")
    system.shutdown(save_map_path=path)
    return path


def _systems(path, freeze=True, force=True):
    js = JSystem(jcam.pinhole(*CAM_ARGS, **CAM_KW), JConfig(**CFG))
    js.load_map(path, freeze=freeze, force_relocalization=force)
    ts = TSystem(tcam.pinhole(*CAM_ARGS, **CAM_KW), TConfig(**CFG),
                 device="cpu")
    ts.load_map(path, freeze=freeze, force_relocalization=force)
    return js, ts


def _replay(system, poses, frames, scene):
    states, errs = [], []
    for i in frames:
        R_gt, t_gt = poses[i]
        gray, depth = scene.render(R_gt, t_gt)
        state, R, t = system.track_rgbd(gray, depth, i / 30.0)
        states.append(int(state))
        if state == OK:
            errs.append(float(np.linalg.norm(-R.T @ t - (-R_gt.T @ t_gt))))
    return states, errs


def _scene():
    return tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                              seed=3)


def test_relocalize_in_loaded_map(saved_session):
    js, ts = _systems(saved_session)
    for s in (js, ts):
        assert s.tracker.state == RELOCALIZE_IN_LOADED_MAP
        assert s.store.kf_fixed[s.store.kf_mask].all()
    # the port's store is the file's: numbering carries on after it
    live = np.nonzero(ts.store.kf_mask)[0]
    assert ts.tracker.frame_id == js.tracker.frame_id == \
        int(ts.store.kf_frame_id[live].max()) + 1
    assert ts.tracker.ref_kf == js.tracker.ref_kf
    poses = tsyn.default_trajectory(40)
    scene = _scene()
    j_states, j_errs = _replay(js, poses, range(18, 30), scene)
    t_states, t_errs = _replay(ts, poses, range(18, 30), scene)
    assert OK in j_states, j_states
    assert t_states == j_states
    assert np.median(t_errs) <= np.median(j_errs) + 0.01, (t_errs, j_errs)
    assert np.median(t_errs) < 0.05
    assert ts.store.n_maps == js.store.n_maps == 1
    # relocalization searched the loaded map, not a fresh one
    assert ts.tracker.maps_created == 0


def test_frozen_keyframes_never_move(saved_session):
    js, ts = _systems(saved_session)
    frozen = np.nonzero(ts.store.kf_fixed)[0]
    np.testing.assert_array_equal(frozen, np.nonzero(js.store.kf_fixed)[0])
    R0 = ts.store.kf_R[frozen].copy()
    t0 = ts.store.kf_t[frozen].copy()
    n_pts0 = ts.store.num_points
    ext = tsyn.default_trajectory(80)
    scene = _scene()
    j_states, _ = _replay(js, ext, range(20, 60), scene)
    t_states, _ = _replay(ts, ext, range(20, 60), scene)
    assert t_states == j_states
    np.testing.assert_array_equal(ts.store.kf_R[frozen], R0)
    np.testing.assert_array_equal(ts.store.kf_t[frozen], t0)
    np.testing.assert_array_equal(js.store.kf_R[frozen], R0)
    # the session extended the map, and frozen landmarks were not culled
    assert ts.store.num_keyframes > len(frozen)
    assert ts.store.num_points >= 0.5 * n_pts0


def test_no_force_reloc_starts_lost(saved_session):
    js, ts = _systems(saved_session, freeze=False, force=False)
    assert ts.tracker.state == js.tracker.state == LOST
    assert not ts.store.kf_fixed[ts.store.kf_mask].any()


def test_pipelined_tracker_relocalizes_before_it_queues(saved_session):
    """With deferred resolution, a frame in RELOCALIZE_IN_LOADED_MAP is
    relocalized at once, never queued; the frames after it queue as in OK,
    and flush() resolves them into the trajectory."""
    ts = TSystem(tcam.pinhole(*CAM_ARGS, **CAM_KW),
                 TConfig(**CFG, pipelined=True, pipeline_depth=4,
                         pipeline_overlap=False), device="cpu")
    ts.load_map(saved_session)
    poses, scene = tsyn.default_trajectory(40), _scene()
    gray, depth = scene.render(*poses[18])
    assert ts.track_rgbd(gray, depth, 18 / 30.0)[0] == OK
    assert not ts.tracker._pending and len(ts.trajectory) == 1
    gray, depth = scene.render(*poses[19])
    assert ts.track_rgbd(gray, depth, 19 / 30.0)[0] == OK
    ts.flush()
    assert not ts.tracker._pending and len(ts.trajectory) == 2
    assert ts.trajectory[1][0] == 19 / 30.0


def _two_map_store(cls):
    st = cls(max_kf=8, max_pts=64, n_kp=4)
    a = st.alloc_kf()
    st.kf_mask[a] = True
    st.create_map()
    b = st.alloc_kf()
    st.kf_mask[b] = True
    return st


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("reader", ["port", "jax"])
def test_multi_map_ids_survive(tmp_path, writer, reader):
    ser = {"port": tser, "jax": jser}
    st = _two_map_store({"port": TStore, "jax": JStore}[writer])
    p = str(tmp_path / "atlas.npz")
    ser[writer].save_atlas(p, st)
    st2, _ = ser[reader].load_atlas(p)
    np.testing.assert_array_equal(st2.kf_map[:2], st.kf_map[:2])
    assert st2.active_map == st.active_map == 1
    assert st2.n_maps == 2
