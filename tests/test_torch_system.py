"""End-to-end parity: the same synthetic RGB-D sequence through the JAX
System and the PyTorch port's System (CPU), with points and lines on and
the keyframe backend off."""

import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.io import evaluation, synthetic as jsyn
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam.tracking import LOST, OK

N_FRAMES = 12
CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384,
             use_lines=True, max_lines=64, local_ba=False,
             loop_closing=False, dense_mapping=False, pipelined=False,
             depth_upload_decimation=2)


def _frames():
    tex = tsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                               texture=tex, tex_scale=220.0)
    poses = tsyn.default_trajectory(36)[:N_FRAMES]
    return list(scene.sequence(poses))


def _run(system, frames):
    states = [int(system.track_rgbd(g, d, ts)[0]) for ts, g, d, _, _ in frames]
    return states, system.trajectory_tum(), system.map_statistics()


@pytest.fixture(scope="module")
def runs():
    frames = _frames()
    jres = _run(JSystem(jcam.pinhole(*CAM_ARGS, **CAM_KW), JConfig(**FLAGS)),
                frames)
    tres = _run(TSystem(tcam.pinhole(*CAM_ARGS, **CAM_KW), TConfig(**FLAGS),
                        device="cpu"), frames)
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    return jres, tres, gt


def test_renderer_matches_reference():
    """The port's numpy renderer (rays from its own unproject) reproduces
    the JAX package's frames (rays from jax unproject): float32 rays agree
    to ~1e-7, which moves bilinear texture samples by far less than the u8
    quantization step the tracker sees."""
    cam = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    tex = jsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    np.testing.assert_array_equal(
        tex, tsyn.make_structured_texture(1024, rng=np.random.default_rng(7)))
    js = jsyn.SyntheticRGBD(cam, wall_z=3.0, texture=tex, tex_scale=220.0)
    ts_ = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                             texture=tex, tex_scale=220.0)
    R, t = tsyn.default_trajectory(36)[5]
    np.testing.assert_allclose(js._rays_c, ts_._rays_c, atol=1e-6)
    gj, dj = js.render(R, t)
    gt_, dt_ = ts_.render(R, t)
    np.testing.assert_allclose(gt_, gj, atol=1e-2)
    np.testing.assert_allclose(dt_, dj, atol=1e-5)


def test_both_track_every_frame(runs):
    (js, _, jmap), (ts_, _, tmap), _ = runs
    assert all(s == OK for s in js[1:]), js
    assert all(s == OK for s in ts_[1:]), ts_
    assert tmap["frames"] == jmap["frames"] == N_FRAMES
    assert tmap["keyframes"] >= 2 and tmap["points"] > 300


def test_per_frame_poses_agree(runs):
    """Per frame within 5 mm / 0.2 deg, all but at most one frame; that one
    within 3 cm / 1 deg. Float32 sums run in another order in the two
    frameworks: the line detector's moment sums cancel catastrophically
    (sxx/c - cx^2), so keyline endpoints differ by up to ~5e-3 px and a
    borderline line association can flip on a frame. Measured on this
    sequence: 11 frames within 1.3e-5 m and one (frame 6, one extra line
    match) 1.8e-2 m apart, re-anchored by the next frame."""
    (_, jt, _), (_, tt, _), _ = runs
    np.testing.assert_allclose(tt[:, 0], jt[:, 0])
    dpos = np.linalg.norm(tt[:, 1:4] - jt[:, 1:4], axis=1)
    # angle between the two orientations from the quaternion inner product
    dot = np.abs((tt[:, 4:8] * jt[:, 4:8]).sum(1)).clip(0.0, 1.0)
    dang = np.degrees(2.0 * np.arccos(dot))
    off = (dpos >= 5e-3) | (dang >= 0.2)
    assert off.sum() <= 1, (dpos, dang)
    assert dpos.max() < 3e-2 and dang.max() < 1.0, (dpos, dang)


def test_ate_agrees(runs):
    """Both ATEs against ground truth within 20% of each other (plus 0.5 mm
    of slack: both are a few millimetres)."""
    (_, jt, _), (_, tt, _), gt = runs
    ate_j = evaluation.ate_rmse(jt[:, 1:4], gt, align=True)
    ate_t = evaluation.ate_rmse(tt[:, 1:4], gt, align=True)
    assert ate_t < 0.03, ate_t
    assert abs(ate_t - ate_j) <= 0.2 * max(ate_j, ate_t) + 5e-4, (ate_j, ate_t)


def test_unsupported_settings_raise():
    cam = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    for kw in (dict(local_ba=True), dict(loop_closing=True),
               dict(dense_mapping=True), dict(pipelined=True),
               dict(async_mapping=True), dict(use_imu=True),
               dict(sensor="stereo")):
        with pytest.raises(NotImplementedError):
            TSystem(cam, TConfig(**{**FLAGS, **kw}), device="cpu")


def test_cuda_requested_without_cuda_raises():
    """The entry points never carry on silently on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cam = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    with pytest.raises(RuntimeError):
        TSystem(cam, TConfig(**FLAGS))
    with pytest.raises(RuntimeError):
        TSystem(cam, TConfig(**FLAGS), device="cuda")


def test_relocalization_is_not_ported():
    """A lost tracker raises instead of relocalizing (no keyframe database
    in this slice)."""
    system = TSystem(tcam.pinhole(*CAM_ARGS, **CAM_KW), TConfig(**FLAGS),
                     device="cpu")
    system.tracker.state = LOST
    with pytest.raises(NotImplementedError):
        system.tracker.process_frame(None, 0.0)
