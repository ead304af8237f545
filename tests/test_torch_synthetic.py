"""The port's sensor-artifact model and bar-dominated texture
(``plvs_tpu_torch/io/synthetic.py``) against the JAX package's: both are
numpy / scipy on the host, so equal inputs give bit-equal outputs."""

import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.io import synthetic as jsyn
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
BENCH_ARGS = (520.9, 521.0, 325.1, 249.7)
BENCH_KW = dict(width=640, height=480, bf=40.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frame(seed):
    """A gray image and a depth image with a 1.5 m step at column 41 (edge
    shadowing) and a few invalid pixels."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(0, 255, (60, 90)).astype(np.float32)
    d = rng.uniform(1.0, 4.0, (60, 90)).astype(np.float32)
    d[:, 41:] += 1.5
    d[rng.random(d.shape) < 0.01] = 0.0
    return g, d


@pytest.mark.parametrize("blur", [False, True])
@pytest.mark.parametrize("seed", [0, 5, 11])
def test_sensor_apply_bit_equal(seed, blur):
    g, d = _frame(seed)
    flow = np.array([7.0, -3.0]) if blur else None
    jm, tm = jsyn.SensorModel(seed=seed), tsyn.SensorModel(seed=seed)
    for idx in (0, 3):
        jg, jd = jm.apply(g, d, idx, bf=24.0, flow_px=flow)
        tg, td = tm.apply(g, d, idx, bf=24.0, flow_px=flow)
        np.testing.assert_array_equal(tg, jg)
        np.testing.assert_array_equal(td, jd)
        assert (td[:, 39:44] == 0).all()    # the shadow band at the step
    # a camera without bf quantizes with the model's own stereo_bf
    np.testing.assert_array_equal(tm.apply(g, d, 1)[1], jm.apply(g, d, 1)[1])


@pytest.mark.parametrize("flow", [(8.0, 0.0), (0.0, 8.0), (3.0, 4.0),
                                  (-20.0, 5.0), (1e-12, 0.0)])
def test_directional_blur_bit_equal(rng, flow):
    img = rng.uniform(0, 255, (40, 50)).astype(np.float32)
    L = min(float(np.hypot(*flow)), 6.0)
    np.testing.assert_array_equal(
        tsyn._directional_blur(img, np.asarray(flow), max(L, 1.0)),
        jsyn._directional_blur(img, np.asarray(flow), max(L, 1.0)))


@pytest.mark.parametrize("seed", [3, 11])
def test_make_line_texture_bit_equal(seed):
    np.testing.assert_array_equal(
        tsyn.make_line_texture(rng=np.random.default_rng(seed)),
        jsyn.make_line_texture(rng=np.random.default_rng(seed)))
    np.testing.assert_array_equal(tsyn.make_line_texture(256),
                                  jsyn.make_line_texture(256))


def test_center_flow_equal():
    poses = tsyn.default_trajectory(12)
    cam_j = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    cam_t = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    for (R0, t0), (R1, t1) in zip(poses, poses[1:]):
        for depth in (3.0, 0.0):
            np.testing.assert_array_equal(
                tsyn._center_flow(cam_t, R0, t0, depth, R1, t1),
                jsyn._center_flow(cam_j, R0, t0, depth, R1, t1))
    # a point that ends up behind the camera has no flow
    R, t = poses[0]
    assert tsyn._center_flow(cam_t, R, t, 3.0, R,
                             t - np.array([0, 0, 5.0], np.float32)) is None


@pytest.mark.parametrize("scene", ["wall_320x240", "bench_wall_640x480",
                                   "room_320x240"])
def test_sensor_sequence_matches_reference(scene):
    """Within test_torch_system.py's render tolerance (gray 1e-2, depth
    1e-5): the two renderers' rays differ by ~1e-7, the artifacts are the
    same numpy code on the same seeds. Measured: bit-equal on all three."""
    if scene == "bench_wall_640x480":
        args, kw = BENCH_ARGS, BENCH_KW
        tex = jsyn.make_structured_texture(2048,
                                           rng=np.random.default_rng(7))
        make = dict(wall_z=3.0, texture=tex, tex_scale=420.0)
    else:
        args, kw = CAM_ARGS, CAM_KW
        make = dict(wall_z=3.0, seed=1)
    if scene.startswith("room"):
        js = jsyn.SyntheticRoom(jcam.pinhole(*args, **kw), seed=3)
        ts_ = tsyn.SyntheticRoom(tcam.pinhole(*args, **kw), seed=3)
        poses = tsyn.orbit_loop_trajectory(24)[:6]
        jf = js.sequence(poses, sensor=jsyn.SensorModel(seed=11))
        tf = ts_.sequence(poses, sensor=tsyn.SensorModel(seed=11))
    else:
        js = jsyn.SyntheticRGBD(jcam.pinhole(*args, **kw), **make)
        ts_ = tsyn.SyntheticRGBD(tcam.pinhole(*args, **kw), **make)
        jf = js.sequence(n_frames=6, sensor=jsyn.SensorModel(seed=11))
        tf = ts_.sequence(n_frames=6, sensor=tsyn.SensorModel(seed=11))
    n = 0
    for (jt, jg, jd, jR, jtr), (tt, tg, td, tR, ttr) in zip(jf, tf):
        assert jt == tt
        np.testing.assert_array_equal(tR, jR)
        np.testing.assert_array_equal(ttr, jtr)
        np.testing.assert_allclose(tg, jg, atol=1e-2)
        np.testing.assert_allclose(td, jd, atol=1e-5)
        n += 1
    assert n == 6
    # the artifacts are there: holes, quantized steps, noise on the gray
    ideal_g, ideal_d = ts_.render(*poses[5]) if scene.startswith("room") \
        else ts_.render(*tsyn.default_trajectory(6)[5])
    assert (td == 0).mean() > 0.001 and (ideal_d == 0).mean() == 0
    assert np.abs(tg - ideal_g).std() > 1.0


def test_sequence_without_sensor_unchanged():
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), seed=1)
    poses = tsyn.default_trajectory(4)
    for (_, g, d, R, t) in scene.sequence(poses):
        g0, d0 = scene.render(R, t)
        np.testing.assert_array_equal(g, g0)
        np.testing.assert_array_equal(d, d0)
