"""The port's dense modules against the JAX package's on equal inputs: the
depth filter, TSDF integration from one carried-across volume, marching
tetrahedra and the incremental mesher on the same volume (the RGB-D run with
dense mapping through both Systems is in test_torch_system, the stereo one
in test_torch_stereo)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.dense import meshing as jmesh
from plvs_tpu.dense import processing as jproc
from plvs_tpu.dense.tsdf import TSDFVolume as JVolume
from plvs_tpu.geometry import cameras as jcam
from plvs_tpu_torch import convert
from plvs_tpu_torch.dense import meshing as tmesh
from plvs_tpu_torch.dense import processing as tproc
from plvs_tpu_torch.dense.mapping import DenseMapper
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
VOXEL = 0.04
N_WARM = 3   # frames the JAX volume integrates before it is carried across


def _frames(n):
    tex = tsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                               texture=tex, tex_scale=220.0)
    return list(scene.sequence(tsyn.default_trajectory(36)[:n]))


def test_filter_depth(rng):
    """Within 2e-6 m: float32 exp in another implementation moves the range
    weights by a few ulps (measured 4.8e-7 m); validity exact."""
    depth = rng.uniform(0.5, 4.0, (48, 64)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.1] = 0.0
    depth[10:20, 10:30] += 0.3   # a depth edge
    j = np.asarray(jproc.filter_depth(jnp.asarray(depth)))
    t = tproc.filter_depth(torch.from_numpy(depth)).numpy()
    np.testing.assert_array_equal(t > 0, j > 0)
    np.testing.assert_allclose(t, j, atol=2e-6)


def test_backproject_image(rng):
    cam_j = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    depth = rng.uniform(0.5, 4.0, (240, 320)).astype(np.float32)
    j = np.asarray(jproc.backproject_image(cam_j, jnp.asarray(depth)))
    t = tproc.backproject_image(tcam.pinhole(*CAM_ARGS, **CAM_KW),
                                torch.from_numpy(depth)).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


def _state(jvol):
    return dict(block_coords=jvol.block_coords, n_blocks=jvol.n_blocks,
                block_map=jvol.block_map, tsdf=jvol.tsdf,
                weight=jvol.weight, color=jvol.color,
                block_version=jvol.block_version, frame_idx=jvol.frame_idx)


@pytest.fixture(scope="module")
def volumes():
    """A JAX volume after N_WARM frames, carried across; then both
    integrate the next frame (3-channel color)."""
    frames = _frames(N_WARM + 1)
    jvol = JVolume(jcam.pinhole(*CAM_ARGS, **CAM_KW), voxel_size=VOXEL,
                   max_blocks=4096)
    for _, g, d, R, t in frames[:N_WARM]:
        jvol.integrate(d, np.repeat(g[..., None], 3, -1), R, t)
    tvol = convert.tsdf_volume_from_numpy(
        tcam.pinhole(*CAM_ARGS, **CAM_KW), _state(jvol), device="cpu",
        voxel_size=VOXEL)
    _, g, d, R, t = frames[N_WARM]
    n0 = jvol.n_blocks
    jvol.integrate(d, np.repeat(g[..., None], 3, -1), R, t)
    tvol.integrate(d, np.repeat(g[..., None], 3, -1), R, t)
    jch = np.asarray(jvol._pending_touch[-1][1])
    tch = tvol._pending_touch[-1][1].numpy()
    return jvol, tvol, n0, jch, tch


def test_integrate_carried_volume(volumes):
    """The same allocated blocks, the same changed-block mask, tsdf and
    weight within 1e-5 and color (0..255) within 1e-3: float32 voxel
    projections and running averages in another summation order (measured
    1.5e-6, 1.5e-6 and 4.6e-5)."""
    jvol, tvol, n0, jch, tch = volumes
    assert jvol.n_blocks > n0 > 100
    assert tvol.n_blocks == jvol.n_blocks
    np.testing.assert_array_equal(tvol.block_coords, jvol.block_coords)
    assert tvol.block_map == jvol.block_map
    np.testing.assert_array_equal(tch, jch)
    assert jch.sum() > 50
    n = jvol.n_blocks
    for name, atol in (("weight", 1e-5), ("tsdf", 1e-5), ("color", 1e-3)):
        np.testing.assert_allclose(getattr(tvol, name)[:n],
                                   getattr(jvol, name)[:n], atol=atol,
                                   err_msg=name)
    # the flush applied both masks: the same block versions
    np.testing.assert_array_equal(tvol.block_version, jvol.block_version)
    jp, jc = jvol.occupied_cloud()
    tp, tc = tvol.occupied_cloud()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_allclose(tc, jc, atol=1e-3)


def test_marching_tetrahedra_same_volume(volumes):
    """The same triangles, vertices within 1e-4 m: both interpolate the same
    float16-rounded field; a 1e-6 tsdf difference rarely moves a float16
    value by one step (measured 9.8e-6 m over 114k vertices)."""
    jvol, tvol, _, _, _ = volumes
    jV, jF = jmesh.marching_tetrahedra(jvol)
    tV, tF = tmesh.marching_tetrahedra(tvol)
    assert len(jF) > 1000
    assert tF.shape == jF.shape
    np.testing.assert_allclose(tV, jV, atol=1e-4)


@pytest.mark.parametrize("budget", [None, 40])
def test_incremental_mesher_same_volume(volumes, budget):
    """Two budgeted updates over the carried volume: the same remeshed
    block counts and cached triangles (vertices within 1e-4 m, as for the
    full mesh)."""
    jvol, tvol, _, _, _ = volumes
    jm, tm = jmesh.IncrementalMesher(jvol), tmesh.IncrementalMesher(tvol)
    for _ in range(2):
        jV, _ = jm.update(budget=budget)
        tV, _ = tm.update(budget=budget)
        assert tm.last_n_remeshed == jm.last_n_remeshed
        assert tm.pending == jm.pending
        assert tV.shape == jV.shape
        np.testing.assert_allclose(tV, jV, atol=1e-4)
    assert len(jV) > 1000


def test_ply_writers(volumes, tmp_path):
    """The cloud and mesh files of both packages: the same headers, and the
    same mesh file from the same vertices and faces."""
    jvol, tvol, _, _, _ = volumes
    jvol.save_ply(str(tmp_path / "j.ply"))
    tvol.save_ply(str(tmp_path / "t.ply"))
    jl = (tmp_path / "j.ply").read_text().splitlines()
    tl = (tmp_path / "t.ply").read_text().splitlines()
    assert len(tl) == len(jl) and tl[:10] == jl[:10]
    V, F = jmesh.marching_tetrahedra(jvol)
    jmesh.save_mesh_ply(str(tmp_path / "jm.ply"), V[:300], F[:100])
    tmesh.save_mesh_ply(str(tmp_path / "tm.ply"), V[:300], F[:100])
    assert (tmp_path / "tm.ply").read_text() == (
        tmp_path / "jm.ply").read_text()


def test_unported_dense_settings_raise():
    cam = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    for kw in (dict(use_segmentation=True), dict(multi_res=True),
               dict(carve_every=5)):
        with pytest.raises(NotImplementedError):
            DenseMapper(cam, device="cpu", **kw)
    # the loop-closure rebuild is ported (tests/test_torch_loop.py); on an
    # empty mapper it re-integrates nothing
    dm = DenseMapper(cam, device="cpu")
    dm.rebuild(lambda k: (None, None))
    assert dm.volume.n_blocks == 0
