"""The port System's lifecycle and trajectory exports against the JAX
package's: tests/test_reset.py and tests/test_retro_trajectory.py through
both packages, the localization mode, ``reset_active_map``, the keyframe
trajectory, the trajectory files a System writes, ``shutdown`` with its
paths and ``print_time_stats``.

Poses are float32 host arrays composed with the same numpy products in
both packages, so the retro-corrected trajectories are compared exactly;
files are compared as tests/test_torch_io.py does (a quaternion field may
differ by one unit in its last decimal: XLA's CPU sqrt is not always
correctly rounded).
"""

import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.io import serialization as jser
from plvs_tpu.io import synthetic as jsyn
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu.slam.map_store import MapStore as JStore
from plvs_tpu_torch import convert
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import serialization as tser
from plvs_tpu_torch.io import trajectory as ttraj
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam.map_store import MapStore as TStore
from plvs_tpu_torch.slam.tracking import NOT_INITIALIZED, OK

CAM = (155.0, 155.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=17.0)
CAM_R = (153.0, 153.0, 161.0, 119.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _rig_T():
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.11, 0.0, 0.0]
    return T


def _port(cfg, **kw):
    return TSystem(tcam.pinhole(*CAM, **CAM_KW), TConfig(**cfg),
                   device="cpu", **kw)


def _jax(cfg, **kw):
    return JSystem(jcam.pinhole(*CAM, **CAM_KW), JConfig(**cfg), **kw)


# -- tests/test_reset.py ------------------------------------------------------

def test_reset_keeps_stereo_rig():
    T = _rig_T()
    cfg = dict(sensor="stereo", num_features=256, n_levels=4)
    sys_ = _port(cfg, cam2=tcam.pinhole(*CAM_R, width=320, height=240),
                 T_c1_c2=T)
    js = _jax(cfg, cam2=jcam.pinhole(*CAM_R, width=320, height=240),
              T_c1_c2=T)
    rig_gate = sys_.tracker.max_depth
    sys_.reset()
    js.reset()
    assert sys_.cam2 is not None, "reset dropped the rig camera"
    assert sys_.R_lr is not None and sys_.t_lr is not None
    np.testing.assert_allclose(sys_.t_lr, T[:3, 3])
    np.testing.assert_array_equal(sys_.t_lr, js.t_lr)
    np.testing.assert_array_equal(sys_.R_lr, js.R_lr)
    assert sys_.config.sensor == "stereo"
    assert sys_.tracker.max_depth == rig_gate == js.tracker.max_depth
    assert sys_.device.type == "cpu" and sys_.store.num_keyframes == 0


def test_reset_keeps_imu():
    T_bc = np.eye(4, dtype=np.float32)
    T_bc[:3, 3] = [0.0, 0.02, 0.0]
    from plvs_tpu.imu.preintegration import ImuCalib as JCalib
    from plvs_tpu_torch.imu.preintegration import ImuCalib as TCalib

    cfg = dict(sensor="rgbd", use_imu=True, num_features=256, n_levels=4)
    calib = dict(gyro_noise=1e-2, acc_noise=2e-2)
    sys_ = _port(cfg, imu_T_b_c=T_bc, imu_calib=TCalib(**calib))
    js = _jax(cfg, imu_T_b_c=T_bc, imu_calib=JCalib(**calib))
    sys_.reset()
    js.reset()
    assert sys_.inertial is not None, "reset dropped the inertial runtime"
    np.testing.assert_allclose(sys_.inertial.t_cb, [0.0, -0.02, 0.0],
                               atol=1e-6)
    np.testing.assert_array_equal(sys_.inertial.t_cb, js.inertial.t_cb)
    np.testing.assert_array_equal(sys_.inertial.R_cb, js.inertial.R_cb)
    assert tuple(sys_.inertial.calib) == tuple(js.inertial.calib)
    assert sys_.config.use_imu


def test_reset_keeps_trajectory_log():
    sys_ = _port(dict(num_features=256, n_levels=4))
    sys_.trajectory.append((0.0, np.eye(3, dtype=np.float32),
                            np.zeros(3, np.float32)))
    sys_.reset()
    assert len(sys_.trajectory) == 1


# -- tests/test_retro_trajectory.py -------------------------------------------

@pytest.mark.parametrize("cls", [TStore, JStore], ids=["port", "jax"])
def test_live_kf_resolves_to_current_pose(cls):
    st = cls(max_kf=8, max_pts=64, n_kp=16)
    k = st.alloc_kf()
    st.kf_mask[k] = True
    st.kf_R[k] = _rot_z(0.3)
    st.kf_t[k] = np.asarray([1.0, 2.0, 3.0], np.float32)
    uid = int(st.kf_uid[k])
    R, t = st.resolve_kf_pose(uid)
    np.testing.assert_allclose(R, st.kf_R[k], atol=1e-6)
    np.testing.assert_allclose(t, st.kf_t[k], atol=1e-6)
    st.kf_t[k] = np.asarray([-1.0, 0.0, 5.0], np.float32)
    np.testing.assert_allclose(st.resolve_kf_pose(uid)[1], st.kf_t[k],
                               atol=1e-6)
    assert st.resolve_kf_pose(123) is None


def _culled_pair(cls):
    st = cls(max_kf=8, max_pts=64, n_kp=16)
    ka = st.alloc_kf()
    st.kf_mask[ka] = True
    kb = st.alloc_kf()
    st.kf_mask[kb] = True
    st.kf_R[ka] = _rot_z(0.2)
    st.kf_t[ka] = np.asarray([0.5, 0.0, 0.0], np.float32)
    st.kf_R[kb] = _rot_z(-0.1)
    st.kf_t[kb] = np.asarray([0.0, 0.3, 0.0], np.float32)
    p = st.alloc_pts(20)
    st.pt_mask[p] = True
    st.add_observations(ka, p, np.arange(20) % st.n_kp)
    st.add_observations(kb, p, np.arange(20) % st.n_kp)
    uid_a = int(st.kf_uid[ka])
    st.remove_keyframe(ka)
    st.kf_R[kb] = (st.kf_R[kb] @ _rot_z(0.4)).astype(np.float32)
    st.kf_t[kb] = (st.kf_R[kb] @ np.asarray([0.1, -0.2, 0.05], np.float32)
                   + st.kf_t[kb]).astype(np.float32)
    return st, uid_a


def test_tombstone_chain_matches_jax():
    """A culled keyframe resolves through its tombstone and the moved
    anchor to the same pose in both packages."""
    ts, uid = _culled_pair(TStore)
    js, uid_j = _culled_pair(JStore)
    assert uid == uid_j
    Rt, tt = ts.resolve_kf_pose(uid)
    Rj, tj = js.resolve_kf_pose(uid)
    np.testing.assert_array_equal(Rt, Rj)
    np.testing.assert_array_equal(tt, tj)


def _retro_case(system):
    st = system.store
    k = st.alloc_kf()
    st.kf_mask[k] = True
    st.kf_R[k] = np.eye(3, dtype=np.float32)
    st.kf_t[k] = np.zeros(3, np.float32)
    system.tracker.ref_kf = k

    class Res:
        state = 2
        R = _rot_z(0.1)
        t = np.asarray([0.2, 0.0, 0.0], np.float32)
        is_keyframe = False
        kf_id = -1

    system._post_track(Res(), 1.0)
    st.kf_t[k] = np.asarray([0.5, 0.0, 0.0], np.float32)  # a loop moved it
    return Res


def test_export_reanchors_after_manual_correction():
    cfg = dict(num_features=256, n_levels=4, local_ba=False,
               loop_closing=False)
    sys_, js = _port(cfg), _jax(cfg)
    Res = _retro_case(sys_)
    _retro_case(js)
    retro = sys_.retro_trajectory()
    assert len(retro) == 1
    _, R, t = retro[0]
    np.testing.assert_allclose(R, Res.R, atol=1e-6)
    np.testing.assert_allclose(
        t, Res.t + Res.R @ np.asarray([0.5, 0, 0], np.float32), atol=1e-5)
    (_, Rj, tj), = js.retro_trajectory()
    np.testing.assert_array_equal(R, Rj)
    np.testing.assert_array_equal(t, tj)
    np.testing.assert_allclose(sys_.trajectory[0][2], Res.t, atol=1e-6)
    # reset freezes the retro-corrected pose into the log
    sys_.reset()
    js.reset()
    np.testing.assert_array_equal(sys_.trajectory[0][2], js.trajectory[0][2])
    np.testing.assert_array_equal(sys_.trajectory[0][2], t)


# -- a tracked session's exports and lifecycle ----------------------------------

CFG = dict(num_features=512, n_levels=4, max_kf=32, max_pts=8192,
           loop_closing=False)


@pytest.fixture(scope="module")
def sessions():
    """12 RGB-D frames through both packages (local BA on)."""
    jc = jcam.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                      bf=24.0)
    tc = tcam.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                      bf=24.0)
    js = JSystem(jc, JConfig(**CFG))
    ts = TSystem(tc, TConfig(**CFG), device="cpu")
    scene = jsyn.SyntheticRGBD(jc, wall_z=3.0, seed=0)
    for t_, gray, depth, _, _ in scene.sequence(n_frames=12):
        assert js.track_rgbd(gray, depth, t_)[0] == OK
        assert ts.track_rgbd(gray, depth, t_)[0] == OK
    return js, ts


def _lines(p):
    return open(p).read().splitlines()


def test_trajectory_files_of_a_session(sessions, tmp_path):
    js, ts = sessions
    assert [s for s, *_ in ts.trajectory] == [s for s, *_ in js.trajectory]
    for name in ("tum", "kitti", "euroc"):
        pt, pj = str(tmp_path / f"t.{name}"), str(tmp_path / f"j.{name}")
        getattr(ts, f"save_trajectory_{name}")(pt)
        getattr(js, f"save_trajectory_{name}")(pj)
        lt, lj = _lines(pt), _lines(pj)
        assert len(lt) == len(lj) == 12 + (name == "euroc")
    tum = ttraj.read_tum(str(tmp_path / "t.tum"))
    np.testing.assert_array_equal(tum, ts.trajectory_tum().round(6))
    jtum = ttraj.read_tum(str(tmp_path / "j.tum"))
    np.testing.assert_array_equal(tum[:, 0], jtum[:, 0])
    np.testing.assert_allclose(tum[:, 1:4], jtum[:, 1:4], atol=5e-3)
    # the keyframe trajectory: the live keyframes by timestamp, their
    # stored poses as they are
    kt = ts.keyframe_trajectory()
    st = ts.store
    live = np.nonzero(st.kf_mask)[0]
    assert len(kt) == len(live) == len(js.keyframe_trajectory())
    assert [k[0] for k in kt] == sorted(st.kf_timestamp[live].tolist())
    for (_, R, t), k in zip(kt, live[np.argsort(st.kf_timestamp[live])]):
        np.testing.assert_array_equal(R, st.kf_R[k])
        np.testing.assert_array_equal(t, st.kf_t[k])
    ts.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    ts.save_keyframe_trajectory_euroc(str(tmp_path / "kf.csv"))
    assert len(_lines(str(tmp_path / "kf.txt"))) == len(kt)
    assert len(_lines(str(tmp_path / "kf.csv"))) == len(kt) + 1
    report = ts.print_time_stats()
    assert "track" in report


def test_shutdown_saves_the_atlas_jax_reads(sessions, tmp_path):
    js, ts = sessions
    p = str(tmp_path / "atlas.npz")
    ts.shutdown(save_map_path=p, save_dense_path=str(tmp_path / "d.npz"))
    assert not (tmp_path / "d.npz").exists()   # no dense mapper
    st, voc = tser.load_atlas(p)
    jst, _ = jser.load_atlas(p)
    for f in tser._STORE_FIELDS:
        np.testing.assert_array_equal(getattr(st, f), getattr(ts.store, f))
        np.testing.assert_array_equal(getattr(jst, f), getattr(ts.store, f))
    assert tser._vocab_checksum(voc) == tser._vocab_checksum(ts.kfdb.voc)
    # the JAX session's atlas loads in the port to its converted store
    pj = str(tmp_path / "jatlas.npz")
    js.shutdown(save_map_path=pj)
    tj, _ = tser.load_atlas(pj)
    ref = convert.map_store_from_numpy(vars(js.store))
    for f in tser._STORE_FIELDS:
        np.testing.assert_array_equal(getattr(tj, f), getattr(ref, f))


def test_localization_mode_and_reset_active_map():
    cam = tcam.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                       bf=24.0)
    sys_ = TSystem(cam, TConfig(num_features=512, n_levels=4,
                                loop_closing=False, local_ba=False),
                   device="cpu")
    sys_.activate_localization_mode()
    assert sys_.tracker.only_tracking
    sys_.deactivate_localization_mode()
    assert not sys_.tracker.only_tracking
    scene = jsyn.SyntheticRGBD(jcam.pinhole(300.0, 300.0, 160.0, 120.0,
                                            width=320, height=240, bf=24.0),
                               wall_z=3.0, seed=0)
    frames = list(scene.sequence(n_frames=4))
    for t_, gray, depth, _, _ in frames:
        assert sys_.track_rgbd(gray, depth, t_)[0] == OK
    st = sys_.store
    st.create_map()                       # a second, empty map...
    st.active_map = 0                     # ...while map 0 stays active
    sys_.reset_active_map()
    assert st.num_keyframes == 0 and st.num_points == 0
    assert st.n_maps == 2
    assert sys_.tracker.state == NOT_INITIALIZED
    # only the active map's contents go: a keyframe of map 1 survives
    k = st.alloc_kf()
    st.kf_mask[k] = True
    st.kf_map[k] = 1
    sys_.reset_active_map()
    assert st.num_keyframes == 1
    # tracking starts over from the next frame
    t_, gray, depth, _, _ = frames[0]
    assert sys_.track_rgbd(gray, depth, t_)[0] == OK
