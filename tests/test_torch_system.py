"""End-to-end parity: the same synthetic RGB-D sequence through the JAX
System and the PyTorch port's System (CPU), with points and lines and dense
mapping on and the keyframe backend off."""

import jax
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
             loop_closing=False, dense_mapping=True, dense_voxel_size=0.04,
             pipelined=False, depth_upload_decimation=2)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames():
    tex = tsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                               texture=tex, tex_scale=220.0)
    poses = tsyn.default_trajectory(36)[:N_FRAMES]
    return list(scene.sequence(poses))


def _run(system, frames):
    states = [int(system.track_rgbd(g, d, ts)[0]) for ts, g, d, _, _ in frames]
    dm = system.dense_mapper
    dense = dict(blocks=dm.volume.n_blocks, occupied=len(dm.cloud()[0]),
                 cached_tris=sum(len(t) for t in
                                 dm.mesher._block_tris.values()),
                 remeshed=list(dm.remesh_counts))
    return states, system.trajectory_tum(), system.map_statistics(), dense


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
    (js, _, jmap, _), (ts_, _, tmap, _), _ = runs
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
    (_, jt, _, _), (_, tt, _, _), _ = runs
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
    (_, jt, _, _), (_, tt, _, _), gt = runs
    ate_j = evaluation.ate_rmse(jt[:, 1:4], gt, align=True)
    ate_t = evaluation.ate_rmse(tt[:, 1:4], gt, align=True)
    assert ate_t < 0.03, ate_t
    assert abs(ate_t - ate_j) <= 0.2 * max(ate_j, ate_t) + 5e-4, (ate_j, ate_t)


def test_rgbd_dense_map_agrees(runs):
    """The dense maps of both runs: the same keyframes, remeshed-block
    counts and allocated blocks; occupied voxels and cached mesh triangles
    within 1% (the dense input is the same quantized depth; the keyframe
    poses agree to ~1e-5 m, test_per_frame_poses_agree)."""
    (_, _, jmap, jd), (_, _, tmap, td), _ = runs
    assert tmap["keyframes"] == jmap["keyframes"] >= 2
    assert td["remeshed"] == jd["remeshed"]
    assert td["blocks"] == jd["blocks"]
    for key in ("occupied", "cached_tris"):
        assert jd[key] > 1000 and abs(td[key] - jd[key]) <= 0.01 * jd[key], (
            key, jd[key], td[key])


def test_unsupported_settings_raise():
    """Every setting constructs: the sharded backend (on the CPU, as on one
    card, with no mesh: the solves run unsharded, as the JAX package's do
    on one device; tests/test_torch_local_mapping.py holds a System with a
    mesh set to JAX's), the monocular sensor (with and without the IMU),
    the image scale, rectification, the non-rectified rig and the dense
    segmentation (tests/test_torch_mono.py, tests/test_torch_stereo_rig.py
    and tests/test_torch_segmentation.py hold them to JAX)."""
    cam = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    s = TSystem(cam, TConfig(**{**FLAGS, "sharded_backend": True,
                                "local_ba": True, "loop_closing": True}),
                device="cpu")
    assert s.mesh is None and s.local_mapper.mesh is None
    assert s.loop_closer.mesh is None
    s = TSystem(cam, TConfig(**{**FLAGS, "sensor": "mono"}), device="cpu")
    assert s.local_mapper.triangulate_new_points and s.inertial is None
    s = TSystem(cam, TConfig(**{**FLAGS, "sensor": "mono", "use_imu": True,
                                "loop_closing": True}), device="cpu")
    assert not s.inertial.fix_scale and s.loop_closer.fix_scale
    s = TSystem(cam, TConfig(**{**FLAGS, "image_scale": 0.5}), device="cpu")
    assert (s.cam.width, s.cam.height) == (160, 120)
    assert s.cam.fx == 150.0 and s.cam.bf == 12.0
    assert s.tracker.min_init_pts == 100
    rig = np.eye(4, dtype=np.float32)
    rig[0, 3] = 0.1
    s = TSystem(cam, TConfig(**{**FLAGS, "sensor": "stereo"}), device="cpu",
                cam2=cam, T_c1_c2=rig)
    assert s.cam2 is cam and s.rectifier is None
    s = TSystem(cam, TConfig(**{**FLAGS, "sensor": "stereo",
                                "rectify": True}), device="cpu",
                cam2=cam, T_c1_c2=rig)
    assert s.cam2 is None and s.cam.bf == pytest.approx(0.1 * 300.0)
    s = TSystem(cam, TConfig(**{**FLAGS, "dense_segmentation": True}),
                device="cpu")
    assert s.dense_mapper.use_segmentation


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
    """Relocalization is ported now: a lost tracker tries the keyframe
    database instead of raising, and a blank frame leaves it LOST
    (tests/test_torch_relocalization.py holds the recovery against JAX)."""
    system = TSystem(tcam.pinhole(*CAM_ARGS, **CAM_KW), TConfig(**FLAGS),
                     device="cpu")
    tex = tsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    g, d = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                              texture=tex, tex_scale=220.0).render(
        *tsyn.default_trajectory(36)[0])
    assert system.track_rgbd(g, d, 0.0)[0] == OK
    system.tracker.state = LOST
    state, _, _ = system.track_rgbd(np.zeros_like(g), np.zeros_like(d),
                                    1 / 30)
    assert state == LOST and system.tracker.lost_frames == 1


def _scale_ns(scale, h, w):
    import types

    return types.SimpleNamespace(
        config=types.SimpleNamespace(image_scale=scale),
        cam=types.SimpleNamespace(height=h, width=w))


@pytest.mark.parametrize("scale", [0.5, 0.75])
def test_maybe_scale_matches_jax(scale):
    """The input resize to the working resolution against the JAX
    System's ``_maybe_scale``: gray (linear, antialiased) within 1e-3 on
    0..255 (tests/test_torch_features.py's pyramid bound: the same
    resampling matrices, XLA's float32 order) and depth (nearest) exact."""
    rng = np.random.default_rng(2)
    big = tcam.pinhole(600.0, 600.0, 320.0, 240.0, width=640, height=480,
                       bf=48.0)
    gray = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    depth = rng.uniform(0.5, 5.0, (480, 640)).astype(np.float32)
    s = TSystem(big, TConfig(**{**FLAGS, "image_scale": scale}),
                device="cpu")
    ns = _scale_ns(scale, s.cam.height, s.cam.width)
    jg = JSystem._maybe_scale(ns, gray)
    jd = JSystem._maybe_scale(ns, depth, nearest=True)
    tg = s._maybe_scale(gray)
    td = s._maybe_scale(depth, nearest=True)
    assert tg.shape == jg.shape == (s.cam.height, s.cam.width)
    np.testing.assert_allclose(tg, jg, atol=1e-3)
    np.testing.assert_array_equal(td, jd)


OBJ_FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384,
                 use_lines=False, local_ba=False, loop_closing=False,
                 dense_mapping=False, pipelined=False, image_scale=0.5,
                 max_kf_interval=5, depth_upload_decimation=2)


@pytest.fixture(scope="module")
def object_runs():
    """RGB-D at 640x480 with image_scale=0.5 (320x240 working size) and one
    map object (tests/test_objects_e2e.py's template) over 16 frames of
    seed 1's wall, through both Systems. The JAX template is extracted by
    its jitted ORB (the same function; eager dispatch compiles op by op),
    and the port's plane RANSACs are handed the samples JAX drew."""
    from plvs_tpu.features import orb as jorb
    from plvs_tpu.slam import map_objects as jmo
    from plvs_tpu_torch.slam import map_objects as tmo

    from test_torch_map_objects import _plane_samples

    args = (600.0, 600.0, 320.0, 240.0)
    kw = dict(width=640, height=480, bf=48.0)
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*args, **kw), wall_z=3.0, seed=1)
    frames = list(scene.sequence(n_frames=16))
    tpl = scene.tex[20:276, 20:276]
    metric_w = 256 / scene.tex_scale
    samples = []
    orig_extract, orig_ransac = jorb.extract, jmo.ransac_plane_homography

    def ransac(p_plane, p_img, valid, sigma2, key, **k):
        samples.append(_plane_samples(key, np.asarray(valid)))
        return orig_ransac(p_plane, p_img, valid, sigma2, key, **k)

    jorb.extract = jax.jit(orig_extract, static_argnames=(
        "num_features", "n_levels", "scale"))
    jmo.ransac_plane_homography = ransac
    try:
        js = JSystem(jcam.pinhole(*args, **kw), JConfig(**OBJ_FLAGS))
        js.add_map_object(tpl, metric_w)
        jstates = [int(js.track_rgbd(g, d, ts)[0])
                   for ts, g, d, _, _ in frames]
    finally:
        jorb.extract, jmo.ransac_plane_homography = orig_extract, orig_ransac
    queue = list(samples)
    orig_draw = tmo.draw_samples
    tmo.draw_samples = lambda valid, gen, n_hyp=512: torch.from_numpy(
        queue.pop(0)).long()
    try:
        ts_ = TSystem(tcam.pinhole(*args, **kw), TConfig(**OBJ_FLAGS),
                      device="cpu")
        ts_.add_map_object(tpl, metric_w)
        tstates = [int(ts_.track_rgbd(g, d, t)[0])
                   for t, g, d, _, _ in frames]
    finally:
        tmo.draw_samples = orig_draw
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    return dict(j=js, t=ts_, jstates=jstates, tstates=tstates, gt=gt,
                left=len(queue), off=20 / scene.tex_scale, width=metric_w)


def test_image_scale_system_with_object_matches_jax(object_runs):
    """Every frame OK in both at the same keyframes; the trajectories
    within 5 mm (tests/test_torch_system.py's per-frame bound: the inputs
    resized in two float32 orders differ by 1e-3 before quantization, so a
    pixel near a quantization step may differ by one level); the object
    detected at the same keyframes with every JAX sample used, inlier
    counts within 10%, its corners within 1 cm of JAX's and on the wall
    within tests/test_objects_e2e.py's gates. Measured: trajectories 7e-7 m
    apart, the same map (4 keyframes, 1048 points), 18 inliers in both,
    corners 4.5 mm apart (the Sim3 refinement's float32 steps, scale
    included, at every keyframe)."""
    r = object_runs
    assert r["jstates"] == r["tstates"] and all(
        s_ == OK for s_ in r["tstates"])
    js, ts_ = r["j"], r["t"]
    assert ts_.map_statistics()["keyframes"] == js.map_statistics()[
        "keyframes"] >= 2
    jt, tt = js.trajectory_tum(), ts_.trajectory_tum()
    assert np.linalg.norm(tt[:, 1:4] - jt[:, 1:4], axis=1).max() < 5e-3
    jo, to = js.object_store.objects[0], ts_.object_store.objects[0]
    assert jo.detected and to.detected and r["left"] == 0
    assert sorted(to.obs) == sorted(jo.obs)
    assert abs(to.n_inliers - jo.n_inliers) <= 0.1 * jo.n_inliers + 1
    jc, tc = jo.corners_world(), to.corners_world()
    np.testing.assert_allclose(tc, jc, atol=1e-2)
    assert np.allclose(tc[:, 2], 3.0, atol=0.25), tc
    assert np.linalg.norm(tc[0, :2] - r["off"]) < 0.25
    w = np.linalg.norm(tc[1] - tc[0])
    assert abs(w - r["width"]) < 0.2 * r["width"]
