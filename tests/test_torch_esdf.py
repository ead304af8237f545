"""The port's ESDF against the JAX package's: jump flooding on random
occupancy grids (the same seeds), the field and sign channel built from one
carried-across TSDF volume, and the trilinear query."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.dense import esdf as jesdf
from plvs_tpu.dense import tsdf as jtsdf
from plvs_tpu.geometry import cameras as jcam
from plvs_tpu_torch import convert
from plvs_tpu_torch.dense import esdf as tesdf
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn

CAM_ARGS = (100.0, 100.0, 40.0, 30.0)
CAM_KW = dict(width=80, height=60)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("shape,n_seeds,steps", [
    ((24, 20, 16), 12, 0), ((9, 31, 5), 3, 0), ((17, 17, 17), 60, 0),
    ((16, 8, 12), 5, 2)])
def test_jfa_exact(rng, shape, n_seeds, steps):
    """The same nearest seeds as JAX's: the seed coordinates are small
    integers in float32, so every squared distance is exact, and the 26
    offsets are tried in the same order with the same strict tie rule
    (also with fewer passes than needed, ``max_steps=2``, where JFA's
    approximation shows). The distances agree within one float32 ulp: the
    final sqrt of XLA on the CPU is not always correctly rounded (measured:
    24 of 96800 voxels of test_esdf_from_tsdf_same_volume one ulp apart,
    none here). Against the exact EDT the JAX test's bounds hold."""
    from scipy.ndimage import distance_transform_edt

    occ = np.zeros(shape, bool)
    pts = rng.integers(0, shape, size=(n_seeds, 3))
    occ[pts[:, 0], pts[:, 1], pts[:, 2]] = True
    vs = 0.05
    j = np.asarray(jesdf.esdf_jfa(jnp.asarray(occ), vs, max_steps=steps))
    t = tesdf.esdf_jfa(torch.from_numpy(occ), vs, max_steps=steps).numpy()
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    np.testing.assert_allclose(t, j, rtol=2.5e-7, atol=0)
    if not steps:
        err = np.abs(t - distance_transform_edt(~occ, sampling=vs))
        assert np.median(err) < 1e-5 and (err < vs).mean() > 0.99


def test_jfa_empty_grid_is_inf():
    got = tesdf.esdf_jfa(torch.zeros((8, 8, 8), dtype=torch.bool), 0.1)
    assert torch.isinf(got).all()
    assert tesdf.jfa_steps((8, 8, 8)) == 3 and tesdf.jfa_steps((1, 1, 1)) == 1


@pytest.fixture(scope="module")
def walls():
    """A JAX volume of a fronto-parallel wall and a slanted one (two
    frames), and its copy in the port."""
    jvol = jtsdf.TSDFVolume(jcam.pinhole(*CAM_ARGS, **CAM_KW),
                            voxel_size=0.05, max_blocks=2048)
    depth = np.full((60, 80), 2.0, np.float32)
    slant = (1.5 + 0.01 * np.arange(80, dtype=np.float32))[None, :].repeat(
        60, 0)
    eye = np.eye(3, dtype=np.float32)
    jvol.integrate(depth, np.zeros((60, 80, 3), np.float32), eye,
                   np.zeros(3, np.float32))
    R = tsyn._so3_exp_np(np.array([0.0, 0.3, 0.0])).astype(np.float32)
    jvol.integrate(slant, np.zeros((60, 80, 3), np.float32), R,
                   np.array([0.2, 0.0, 0.1], np.float32))
    tvol = convert.tsdf_volume_from_numpy(
        tcam.pinhole(*CAM_ARGS, **CAM_KW), convert.tsdf_state(jvol),
        device="cpu", voxel_size=0.05)
    return jvol, tvol


def test_esdf_from_tsdf_same_volume(walls):
    """On one state: the same grid origin and shape, the field within one
    float32 ulp (the same occupancy through JFA, see test_jfa_exact) and
    the same sign channel."""
    jvol, tvol = walls
    jo, jg, js = jesdf.esdf_from_tsdf(jvol)
    to, tg, ts = tesdf.esdf_from_tsdf(tvol)
    np.testing.assert_array_equal(to, jo)
    assert tg.shape == jg.shape and tg.size > 1000
    np.testing.assert_allclose(tg, jg, rtol=2.5e-7, atol=0)
    np.testing.assert_array_equal(ts, js)
    assert (ts == -1).any() and (tg == 0).any()


def test_query_esdf(walls, rng):
    """Trilinear queries within 1e-6 of JAX's (the same numpy on the same
    grid): in front of the wall the distance is ~|z - 2|, and outside the
    grid +inf."""
    jvol, tvol = walls
    o, g, _ = tesdf.esdf_from_tsdf(tvol)
    q = np.concatenate([
        np.array([[0.0, 0.0, 1.6], [0.0, 0.0, 1.8], [0.0, 0.0, 2.0],
                  [50.0, 50.0, 50.0]], np.float32),
        rng.uniform(-0.5, 2.5, (500, 3)).astype(np.float32)])
    jd = jesdf.query_esdf(*jesdf.esdf_from_tsdf(jvol)[:2], 0.05, q)
    td = tesdf.query_esdf(o, g, 0.05, q)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], atol=1e-6, rtol=0)
    assert abs(td[0] - 0.4) < 0.12 and abs(td[1] - 0.2) < 0.12
    assert td[2] < 0.08 and np.isinf(td[3])
    empty = tesdf.query_esdf(o, np.zeros((0, 0, 0), np.float32), 0.05, q)
    assert np.isinf(empty).all()
