"""The port's non-rectified stereo rig against the JAX package's: the rig
frame (build_frame_stereo_rig) on tests/test_stereo_rig.py's KB8 pair (matches,
triangulated depths, the epipolar gate against a foreign texture), and a
rig System and a ``rectify=True`` System (the pair warped to a common
pinhole, with dense mapping) through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.io import evaluation
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu.slam import frame as jframe
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam import frame as tframe
from plvs_tpu_torch.slam.tracking import OK

# tests/test_stereo_rig.py's pair: right camera 11 cm to the right with a
# ~1 degree yaw
KB_L = (155.0, 155.0, 160.0, 120.0, 0.02, -0.008, 0.002, -0.0005)
KB_R = (153.0, 153.0, 161.0, 119.0, 0.019, -0.0075, 0.0021, -0.0004)
SIZE = dict(width=320, height=240)
T12 = np.eye(4, dtype=np.float32)
T12[:3, :3] = tsyn._so3_exp_np(np.array([0.0, 0.017, 0.0]))
T12[:3, 3] = [0.11, 0.0, 0.0]
FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384,
             sensor="stereo", loop_closing=False, max_kf_interval=5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cams(mod):
    return (mod.kannala_brandt8(*KB_L, **SIZE),
            mod.kannala_brandt8(*KB_R, **SIZE))


def _rig(seed):
    return tsyn.SyntheticRig(*_cams(tcam), T12, wall_z=3.0, seed=seed)


def _frames(gl, gr):
    jl, jr = _cams(jcam)
    tl, tr = _cams(tcam)
    jf = jframe.build_frame_stereo_rig(
        jnp.asarray(gl), jnp.asarray(gr), jl, jr, jnp.asarray(T12[:3, :3]),
        jnp.asarray(T12[:3, 3]), 512, 4, 1.2)
    tf = tframe.build_frame_stereo_rig(
        torch.from_numpy(gl), torch.from_numpy(gr), tl, tr,
        torch.from_numpy(T12[:3, :3].copy()),
        torch.from_numpy(T12[:3, 3].copy()), 512, 4, 1.2)
    return jf, tf


def test_rig_frame_matches_jax():
    """Keypoints, masks and the set of triangulated matches are identical
    (the epipolar gate, K1's plain version and the ratio test pick the same
    right keypoints). Depths agree within 2e-3 relative, and half within
    1e-4: the 17-step parabola's costs are sums of 81 bilinear taps of
    order 1e4 that XLA and PyTorch add in another order (1-2 ulp apart,
    measured), and a parabola through three nearly equal costs amplifies
    that into the sub-pixel shift (measured: 1.0e-3 relative at most, 54%
    within 1e-4). The port's depths also pass the JAX test's gates against
    the rendered ground truth."""
    gl, gr, depth_gt = _rig(5).render(np.eye(3, dtype=np.float32),
                                      np.zeros(3, np.float32))
    jf, tf = _frames(gl, gr)
    np.testing.assert_array_equal(tf.kp.xy.numpy(), np.asarray(jf.kp.xy))
    np.testing.assert_array_equal(tf.kp.mask.numpy(), np.asarray(jf.kp.mask))
    jd, td = np.asarray(jf.depth), tf.depth.numpy()
    np.testing.assert_array_equal(td > 0, jd > 0)
    np.testing.assert_array_equal(tf.uvr.numpy(), np.asarray(jf.uvr))
    ok = td > 0
    rel = np.abs(td[ok] - jd[ok]) / jd[ok]
    assert rel.max() < 2e-3 and (rel <= 1e-4).mean() >= 0.5, np.sort(rel)
    np.testing.assert_allclose(tf.xyz_cam.numpy()[ok],
                               np.asarray(jf.xyz_cam)[ok], rtol=2e-3,
                               atol=1e-6)
    np.testing.assert_allclose(tf.inv_sigma2.numpy(),
                               np.asarray(jf.inv_sigma2))
    assert ok.sum() > 100, ok.sum()
    xy = tf.kp.xy.numpy()[ok]
    xi = np.clip(np.round(xy[:, 0]).astype(int), 0, 319)
    yi = np.clip(np.round(xy[:, 1]).astype(int), 0, 239)
    gt = depth_gt[yi, xi]
    err = (td[ok] - gt) / gt
    assert abs(np.median(err)) < 0.02, np.median(err)
    assert np.median(np.abs(err)) < 0.08, np.median(np.abs(err))
    np.testing.assert_allclose(tf.xyz_cam.numpy()[ok, 2], td[ok], rtol=1e-5)


def test_rig_frame_rejects_a_foreign_right_image():
    """A right image of another texture: the epipolar gate, descriptor gate
    and reprojection check leave the same few depths (< 40) in both."""
    gl, _ = tsyn.SyntheticRGBD(_cams(tcam)[0], wall_z=3.0, seed=5).render(
        np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    gr, _ = tsyn.SyntheticRGBD(_cams(tcam)[1], wall_z=3.0, seed=99).render(
        np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    jf, tf = _frames(gl, gr)
    good = tf.depth.numpy() > 0
    np.testing.assert_array_equal(good, np.asarray(jf.depth) > 0)
    assert good.sum() < 40, good.sum()


def _run(system, frames, dense=False):
    states = [int(system.track_stereo(gl, gr, ts)[0])
              for ts, gl, gr, _, _ in frames]
    out = dict(states=states, traj=system.trajectory_tum(),
               map=system.map_statistics())
    if dense:
        pts, _ = system.dense_mapper.cloud()
        out.update(occupied=len(pts), faces=len(system.dense_mapper.mesh()[1]),
                   cloud=pts)
    return out


@pytest.fixture(scope="module", params=["rig", "rectified"])
def runs(request):
    """16 frames through the rig (local BA on, as the JAX test), or 12
    frames warped to the common pinhole with 4 cm dense mapping, through
    both Systems."""
    rectify = request.param == "rectified"
    n = 12 if rectify else 16
    frames = list(_rig(7).sequence(tsyn.default_trajectory(24)[:n]))
    flags = dict(FLAGS, rectify=rectify, dense_mapping=rectify,
                 dense_voxel_size=0.04)
    jres = _run(JSystem(_cams(jcam)[0], JConfig(**flags),
                        cam2=_cams(jcam)[1], T_c1_c2=T12), frames, rectify)
    tsys = TSystem(_cams(tcam)[0], TConfig(**flags), device="cpu",
                   cam2=_cams(tcam)[1], T_c1_c2=T12)
    tres = _run(tsys, frames, rectify)
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    return request.param, jres, tres, gt, tsys


def test_rig_system_states_and_map_agree(runs):
    """Every frame OK in both, the same states and keyframes, and live
    points within 5% (a depth 1e-3 apart can cross a gate: measured 311
    and 313 on the rig, 333 and 332 rectified)."""
    _, jres, tres, _, _ = runs
    assert all(s == OK for s in jres["states"][1:]), jres["states"]
    assert tres["states"] == jres["states"]
    assert tres["map"]["keyframes"] == jres["map"]["keyframes"] >= 2
    jp, tp = jres["map"]["points"], tres["map"]["points"]
    assert abs(tp - jp) <= 0.05 * jp, (jp, tp)


def test_rig_system_poses_and_ate_agree(runs):
    """Positions within 2 cm of JAX's (6 and 5.5 mm measured on the rig and
    rectified runs), and each ATE within the chip smoke's bound of the
    other package's: max(1.5 x, + 1 cm)."""
    _, jres, tres, gt, _ = runs
    jt, tt = jres["traj"], tres["traj"]
    np.testing.assert_allclose(tt[:, 0], jt[:, 0])
    assert np.linalg.norm(tt[:, 1:4] - jt[:, 1:4], axis=1).max() < 0.02
    ate_j = evaluation.ate_rmse(jt[:, 1:4], gt, align=True)
    ate_t = evaluation.ate_rmse(tt[:, 1:4], gt, align=True)
    assert ate_t <= max(1.5 * ate_j, ate_j + 0.01), (ate_j, ate_t)
    assert ate_j <= max(1.5 * ate_t, ate_t + 0.01), (ate_j, ate_t)


def test_rig_system_wiring(runs):
    """The rig keeps its two cameras, the baseline's close/far gate (40
    baselines, as a KB8 camera has no bf) and the rig's initialization
    floor; rectification swaps in the common pinhole, drops the second
    camera, and its dense map agrees with JAX's within 2% (occupied voxels
    and triangles)."""
    name, jres, tres, _, tsys = runs
    if name == "rig":
        assert tsys.cam2 is not None and tsys.rectifier is None
        assert tsys.tracker.max_depth == pytest.approx(40 * 0.11)
        assert tsys.tracker.min_init_pts == 120   # max(80, 120 s^2)
        np.testing.assert_array_equal(tsys.t_lr, T12[:3, 3])
    else:
        assert tsys.cam2 is None and tsys.R_lr is None
        assert tsys.cam is tsys.rectifier.cam and tsys.cam.bf > 0
        assert tsys.tracker.min_init_pts == 300   # max(100, 300 s^2)
        for key in ("occupied", "faces"):
            assert abs(tres[key] - jres[key]) <= 0.02 * jres[key], (
                key, jres[key], tres[key])
        zj = np.median(np.abs(jres["cloud"][:, 2] - 3.0))
        zt = np.median(np.abs(tres["cloud"][:, 2] - 3.0))
        assert abs(zt - zj) < 0.01, (zj, zt)
