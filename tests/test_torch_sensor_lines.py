"""End-to-end parity on the scenes of ``chip_smoke.py`` phase 18, at
320x240 and 12 frames, the same frames through the JAX System and the
port's System (CPU):

* tests/test_sensor_realism.py's configuration (512 features, 4 levels,
  the default flags: keyframe backend and loop closing on) over the first
  12 of its 40 poses, every frame through ``SensorModel(seed=11)``: depth
  holes, quantized depth steps, axial noise, motion blur, photometric
  noise;
* stereo with lines and the keyframe backend (``local_ba``,
  ``backend_fixed_shapes``) on the bar-dominated wall
  (``make_line_texture(rng=default_rng(11))``), the right image one
  baseline to the right, as tests/test_lines_e2e.py renders it.

Each package's ATE is taken against ground truth (as the other System
parity files do): the two within 20% + 1 mm of each other and under the
JAX gate of the scene; the live keyframes, points and lines within 25%.

On the bar-dominated wall the line detector leaves keyline slots with
non-finite endpoints, and the JAX pose solve weighs masked line rows by
multiplying with 0: 0 x NaN makes the frame's pose NaN, so the JAX System
loses every such frame (about one in two there, and its own slow tests in
tests/test_lines_e2e.py fail on it). The port zeroes masked rows in
``make_pose_obs``; the stereo-lines run gives the JAX package the same
repair at run time (its ``make_pose_obs`` wrapped, nothing edited), and
``test_masked_line_rows_do_not_poison_the_pose`` shows the fault.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.io import evaluation
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu.solvers import pose_opt as jpose_opt
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam.tracking import OK

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
N_FRAMES = 12
SENSOR_FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384)
STEREO_FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384,
                    use_lines=True, max_lines=64, sensor="stereo",
                    local_ba=True, backend_fixed_shapes=True,
                    loop_closing=False, pipelined=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sensor_frames():
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                               seed=1)
    return list(scene.sequence(tsyn.default_trajectory(40)[:N_FRAMES],
                               sensor=tsyn.SensorModel(seed=11)))


def _stereo_frames():
    scene = tsyn.SyntheticRGBD(
        tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
        texture=tsyn.make_line_texture(rng=np.random.default_rng(11)))
    shift = np.array([CAM_KW["bf"] / CAM_ARGS[0], 0, 0], np.float32)
    return [(ts, g, scene.render(R, t - shift)[0], R, t) for ts, g, _, R, t
            in scene.sequence(tsyn.default_trajectory(40)[:N_FRAMES])]


@contextlib.contextmanager
def _jax_masked_rows_repaired():
    """The JAX ``make_pose_obs`` giving masked line rows a zero line and
    weight, as the port's does; the jit caches are cleared on both sides so
    the tracker's programs are traced with it and without it again."""
    make = jpose_opt.make_pose_obs

    def repaired(Xw, uvr, inv_sigma2, mask, line_Xs=None, line_Xe=None,
                 line_nld=None, line_inv_sigma2=None, line_mask=None):
        if line_Xs is not None:
            line_nld = jnp.where(line_mask[:, None], line_nld, 0.0)
            line_inv_sigma2 = jnp.where(line_mask, line_inv_sigma2, 0.0)
        return make(Xw, uvr, inv_sigma2, mask, line_Xs, line_Xe, line_nld,
                    line_inv_sigma2, line_mask)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpose_opt, "make_pose_obs", repaired)
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


def _run(system, frames, stereo: bool) -> dict:
    track = system.track_stereo if stereo else system.track_rgbd
    states = [int(track(a, b, ts)[0]) for ts, a, b, _, _ in frames]
    st = system.store
    lns = np.nonzero(st.ln_mask)[0]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    est = system.trajectory_tum()[:, 1:4]
    return dict(states=states, map=system.map_statistics(),
                ate=evaluation.ate_rmse(est, gt, align=True),
                lines_multi_view=int((st.ln_n_obs[lns] >= 2).sum()))


@pytest.fixture(scope="module", params=["sensor", "stereo_lines"])
def runs(request):
    stereo = request.param == "stereo_lines"
    frames = _stereo_frames() if stereo else _sensor_frames()
    flags = STEREO_FLAGS if stereo else SENSOR_FLAGS
    with (_jax_masked_rows_repaired() if stereo
          else contextlib.nullcontext()):
        jres = _run(JSystem(jcam.pinhole(*CAM_ARGS, **CAM_KW),
                            JConfig(**flags)), frames, stereo)
    tsys = TSystem(tcam.pinhole(*CAM_ARGS, **CAM_KW), TConfig(**flags),
                   device="cpu")
    tres = _run(tsys, frames, stereo)
    tres["ba"] = list(tsys.local_mapper.ba_log)   # the port's solve log
    return request.param, jres, tres


def test_states_like_jax(runs):
    """Every frame after the first OK in both (the JAX sensor gate allows
    2 non-OK frames of 40; neither package loses one here)."""
    _, jres, tres = runs
    assert all(s == OK for s in jres["states"][1:]), jres["states"]
    assert tres["states"] == jres["states"]


def test_ate_like_jax(runs):
    """Each package's ATE against ground truth: within 20% + 1 mm of each
    other, and under the JAX tests' gates (8 cm with sensor artifacts,
    tests/test_sensor_realism.py; 10 cm for stereo lines,
    tests/test_lines_e2e.py)."""
    name, jres, tres = runs
    ate_j, ate_t = jres["ate"], tres["ate"]
    assert abs(ate_t - ate_j) <= 0.2 * max(ate_j, ate_t) + 1e-3, (ate_j,
                                                                  ate_t)
    assert ate_t < (0.08 if name == "sensor" else 0.10), ate_t


def test_live_map_like_jax(runs):
    name, jres, tres = runs
    for key in ("keyframes", "points", "lines"):
        j, t = jres["map"][key], tres["map"][key]
        assert abs(t - j) <= 0.25 * j, (key, j, t)
    assert tres["map"]["keyframes"] >= 2 and tres["map"]["points"] > 300
    if name == "stereo_lines":
        # tests/test_lines_e2e.py's stereo and multi-view gates
        assert tres["map"]["lines"] > 0 and tres["lines_multi_view"] >= 3


def test_local_ba_finite_and_non_increasing(runs):
    _, _, tres = runs
    assert tres["ba"], "the keyframe backend solved no window"
    for b in tres["ba"]:
        assert np.isfinite(b["cost"]) and b["cost"] <= b["cost0"], b


def test_masked_line_rows_do_not_poison_the_pose(rng):
    """A masked line row with non-finite endpoints (an empty keyline slot):
    the port's pose is finite and equal to the pose without that row; the
    JAX package's is NaN (its frame is then lost)."""
    from plvs_tpu_torch.solvers import pose_opt as tpose_opt

    cam_j = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    cam_t = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    X = np.stack([rng.uniform(-1, 1, 40), rng.uniform(-1, 1, 40),
                  rng.uniform(2, 4, 40)], -1).astype(np.float32)
    uv = np.stack([300 * X[:, 0] / X[:, 2] + 160, 300 * X[:, 1] / X[:, 2]
                   + 120, np.full(40, -1.0)], -1).astype(np.float32)
    inv = np.ones(40, np.float32)
    m = np.ones(40, bool)
    Xs = np.array([[0.0, -0.5, 3.0], [0.0, 0.0, 0.0]], np.float32)
    Xe = np.array([[0.0, 0.5, 3.0], [0.0, 0.0, 0.0]], np.float32)
    nld = np.array([[1.0, 0.0, -160.0], [np.nan, np.nan, np.nan]],
                   np.float32)
    lis2 = np.array([1.0, np.nan], np.float32)
    lm = np.array([True, False])
    R0, t0 = np.eye(3, dtype=np.float32), np.array([0.02, -0.01, 0.03],
                                                   np.float32)

    def port(rows):
        obs = tpose_opt.make_pose_obs(
            *map(torch.from_numpy, (X, uv, inv, m, Xs[rows], Xe[rows],
                                    nld[rows], lis2[rows], lm[rows])))
        return tpose_opt.pose_optimize(cam_t, torch.from_numpy(R0),
                                       torch.from_numpy(t0), obs)

    with_row, without = port(slice(0, 2)), port(slice(0, 1))
    assert torch.isfinite(with_row[1]).all()
    np.testing.assert_allclose(with_row[1].numpy(), without[1].numpy(),
                               atol=1e-6)
    assert int(with_row[4]) == int(without[4]) == 41
    jobs = jpose_opt.make_pose_obs(*map(jnp.asarray, (X, uv, inv, m, Xs, Xe,
                                                      nld, lis2, lm)))
    jt = np.asarray(jpose_opt.pose_optimize(cam_j, jnp.asarray(R0),
                                            jnp.asarray(t0), jobs)[1])
    assert np.isnan(jt).all()
