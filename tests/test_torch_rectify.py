"""The port's image-level stereo rectification against the JAX package's:
the rectifying rotations and the common pinhole, the remap tables (built
on the host in float32 through each package's own camera projection), the
bilinear warp, and the per-frame rectifier."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.geometry import rectify as jrect
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.geometry import rectify as trect
from plvs_tpu_torch.io import synthetic as tsyn

# (kind, params, width, height): tests/test_rectify.py's distorted pinhole
# pair and tests/test_stereo_rig.py's KB8 pair
RIGS = {
    "radtan": (("pinhole", (280.0, 280.0, 160.0, 120.0),
                dict(dist=(-0.25, 0.06, 0.0, 0.0, 0.0))),
               ("pinhole", (276.0, 276.0, 158.0, 121.0),
                dict(dist=(-0.22, 0.05, 0.0, 0.0, 0.0))), 0.12, 0.01),
    "kb8": (("kannala_brandt8", (155.0, 155.0, 160.0, 120.0, 0.02, -0.008,
                                 0.002, -0.0005), {}),
            ("kannala_brandt8", (153.0, 153.0, 161.0, 119.0, 0.019, -0.0075,
                                 0.0021, -0.0004), {}), 0.11, 0.017),
    # a wide pair yawed far apart: rectified rays of the right view fall
    # behind its camera and map to -1e6
    "kb8_wide_yaw": (("kannala_brandt8", (90.0, 90.0, 160.0, 120.0, 0.02,
                                          -0.008, 0.002, -0.0005), {}),
                     ("kannala_brandt8", (90.0, 90.0, 161.0, 119.0, 0.019,
                                          -0.0075, 0.0021, -0.0004), {}),
                     0.11, 0.9),
}


def _cams(name):
    (kl, pl, kwl), (kr, pr, kwr), base, yaw = RIGS[name]
    mk = dict(width=320, height=240)
    jl = getattr(jcam, kl)(*pl, **kwl, **mk)
    jr = getattr(jcam, kr)(*pr, **kwr, **mk)
    tl = getattr(tcam, kl)(*pl, **kwl, **mk)
    tr = getattr(tcam, kr)(*pr, **kwr, **mk)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = tsyn._so3_exp_np(np.array([0.0, yaw, 0.0]))
    T[:3, 3] = [base, 0.0, 0.0]
    return jl, jr, tl, tr, T


@pytest.mark.parametrize("name", list(RIGS))
def test_rectify_maps_match(name):
    """The rotations and the common pinhole are equal (the same float64
    numpy in both); the maps agree within 1e-3 px where finite (each
    package projects in float32 in its own op order; measured: 4e-5
    px), and the -1e6
    behind-camera entries sit at the same pixels."""
    jl, jr, tl, tr, T = _cams(name)
    jm = jrect.stereo_rectify(jl, jr, T)
    tm = trect.stereo_rectify(tl, tr, T)
    np.testing.assert_array_equal(tm.R_rect_l, jm.R_rect_l)
    np.testing.assert_array_equal(tm.R_rect_r, jm.R_rect_r)
    assert tm.cam.params == jm.cam.params and tm.cam.bf == jm.cam.bf
    assert (tm.cam.kind, tm.cam.width, tm.cam.height) == (
        jm.cam.kind, jm.cam.width, jm.cam.height)
    for a, b in ((tm.map_l, jm.map_l), (tm.map_r, jm.map_r)):
        assert a.shape == b.shape == (240, 320, 2) and a.dtype == np.float32
        behind = b == -1e6
        np.testing.assert_array_equal(a == -1e6, behind)
        fin = np.isfinite(b) & ~behind
        np.testing.assert_allclose(a[fin], b[fin], atol=1e-3, rtol=0)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    if name == "kb8_wide_yaw":
        assert (jm.map_r == -1e6).any()


def test_remap_bilinear_matches(rng):
    """Within 1e-4 on a [0, 255] image through JAX's own map, with taps off
    the image and behind the camera (both read 0)."""
    jl, jr, _, _, T = _cams("kb8_wide_yaw")
    maps = jrect.stereo_rectify(jl, jr, T)
    img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    for m in (maps.map_l, maps.map_r):
        j = np.asarray(jrect.remap_bilinear(jnp.asarray(img), jnp.asarray(m)))
        t = trect.remap_bilinear(torch.from_numpy(img),
                                 torch.from_numpy(m)).numpy()
        np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)
    assert (j == 0).mean() > 0.01


def test_rectifier_warps_both_images(rng):
    """The per-frame rectifier: both warped images within 1e-2 grey levels
    of JAX's, 1e-4 on average: the maps differ by up to 4e-5 px (measured),
    and the blob texture's edges change by up to ~200 grey levels a pixel.
    The common camera is JAX's."""
    jl, jr, tl, tr, T = _cams("kb8")
    jrec = jrect.StereoRectifier(jl, jr, T)
    trec = trect.StereoRectifier(tl, tr, T, device="cpu")
    tex = tsyn.make_texture(512, np.random.default_rng(4))
    scene = tsyn.SyntheticRGBD(tl, wall_z=3.0, texture=tex)
    gl, _ = scene.render(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    gr = np.roll(gl, 3, axis=1)
    jo = [np.asarray(x) for x in jrec(gl, gr)]
    to = [x.numpy() for x in trec(gl, gr)]
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, atol=1e-2, rtol=0)
        assert np.abs(a - b).mean() < 1e-4
    assert trec.cam.params == jrec.cam.params
