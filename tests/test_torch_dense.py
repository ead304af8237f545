"""The port's dense modules against the JAX package's on equal inputs: the
depth filter, TSDF integration from one carried-across volume, marching
tetrahedra and the incremental mesher on the same volume, the TSDF samples
and gradient normals, the camera-range touched-block fallback, SGM
disparity, and the dense mapper's entry points and settings (the
multi-resolution far field, carving, the unfiltered and fixed-shape
variants, the stereo insert, the rebuild of both volumes) fed the same
frames (the RGB-D run with dense mapping through both Systems is in
test_torch_system, the stereo one in test_torch_stereo, segmentation in
test_torch_segmentation, the ESDF in test_torch_esdf)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.dense import meshing as jmesh
from plvs_tpu.dense import processing as jproc
from plvs_tpu.dense import stereo_depth as jsd
from plvs_tpu.dense.mapping import DenseMapper as JMapper
from plvs_tpu.dense.tsdf import TSDFVolume as JVolume
from plvs_tpu.geometry import cameras as jcam
from plvs_tpu_torch import convert
from plvs_tpu_torch.dense import meshing as tmesh
from plvs_tpu_torch.dense import processing as tproc
from plvs_tpu_torch.dense import stereo_depth as tsd
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
        tcam.pinhole(*CAM_ARGS, **CAM_KW), convert.tsdf_state(jvol), device="cpu",
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
    """Every DenseMapper setting of the JAX package is ported now: the
    segmentation, far-field and carving settings construct what JAX's
    do (labels on the fine volume; a coarse volume of a quarter of the
    blocks, at least 512, with twice the range), and on an empty mapper
    the rebuild re-integrates nothing."""
    cam = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    for kw in (dict(use_segmentation=True), dict(multi_res=True),
               dict(carve_every=5)):
        dm = DenseMapper(cam, device="cpu", max_blocks=1024, **kw)
        jm = JMapper(jcam.pinhole(*CAM_ARGS, **CAM_KW), max_blocks=1024,
                     **kw)
        assert dm.volume.with_labels == jm.volume.with_labels
        assert (dm.coarse is None) == (jm.coarse is None)
        if dm.coarse is not None:
            for a in ("voxel_size", "max_blocks", "max_depth"):
                assert getattr(dm.coarse, a) == getattr(jm.coarse, a)
    dm = DenseMapper(cam, device="cpu")
    dm.rebuild(lambda k: (None, None))
    assert dm.volume.n_blocks == 0


# ---------------------------------------------------------------------------
# TSDF samples, gradient normals, the touched-block fallback
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def same_volume(volumes):
    """The JAX volume after N_WARM + 1 frames and its exact copy in the
    port (both hold one state)."""
    jvol = volumes[0]
    tvol = convert.tsdf_volume_from_numpy(
        tcam.pinhole(*CAM_ARGS, **CAM_KW), convert.tsdf_state(jvol),
        device="cpu", voxel_size=VOXEL)
    return jvol, tvol


def test_sample_tsdf_and_vertex_normals_exact(same_volume, rng):
    """On one state: the nearest-voxel samples (mesh vertices, random points
    and unallocated space, which reads 1) and the central-difference
    normals at the mesh vertices are equal (the same numpy arithmetic on
    the same samples)."""
    jvol, tvol = same_volume
    V, _ = jmesh.marching_tetrahedra(jvol)
    pts = np.concatenate([V[:4000], rng.uniform(-2, 4, (500, 3)).astype(
        np.float32), np.full((3, 3), 50.0, np.float32)])
    js = jmesh.sample_tsdf(jvol, pts)
    ts = tmesh.sample_tsdf(tvol, pts)
    np.testing.assert_array_equal(ts, js)
    assert (ts[-3:] == 1.0).all() and (ts < 0).any()
    jn = jmesh.vertex_normals(jvol, V[:4000])
    tn = tmesh.vertex_normals(tvol, V[:4000])
    np.testing.assert_array_equal(tn, jn)
    # the wall faces the camera (-z): normals point from the inside out
    assert np.median(tn[:, 2]) < -0.9


def test_mark_touched_camera_range_fallback(same_volume):
    """Without a changed mask, every block within camera range is bumped
    (the same blocks as JAX's); with one, exactly the masked blocks."""
    jvol, tvol = same_volume
    frames = _frames(N_WARM + 2)
    _, _, _, R, t = frames[-1]
    for vol in (jvol, tvol):
        vol.block_version[:] = 0
        vol.frame_idx = 9
        vol._mark_touched(R, t)
    np.testing.assert_array_equal(tvol.block_version, jvol.block_version)
    assert 0 < (jvol.block_version == 9).sum()
    mask = np.zeros(jvol.n_blocks, bool)
    mask[::7] = True
    for vol in (jvol, tvol):
        vol.frame_idx = 11
        vol._mark_touched(R, t, changed=mask)
    np.testing.assert_array_equal(tvol.block_version, jvol.block_version)
    assert (jvol.block_version[:jvol.n_blocks][mask] == 11).all()
    # a camera far away: nothing in range
    for vol in (jvol, tvol):
        vol.frame_idx = 13
        vol._mark_touched(R, t + np.float32(100.0))
    assert not (tvol.block_version == 13).any()


# ---------------------------------------------------------------------------
# SGM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(40, 24, 16), (7, 3, 5)])
def test_sgm_scan_exact(rng, shape):
    """One directional scan ([S, B, D]) equals JAX's lax.scan: the same
    float32 minimum / add / subtract in the same order."""
    v = rng.uniform(0, 30, shape).astype(np.float32)
    j = np.asarray(jsd._sgm_scan_lr(jnp.asarray(v), 7.0, 100.0))
    t = tsd._sgm_scan_lr(torch.from_numpy(v), 7.0, 100.0).numpy()
    np.testing.assert_array_equal(t, j)


def test_sgm_aggregate_and_box_filter_exact(rng):
    """The 4-path aggregate of a [D, H, W] volume (both directions of an
    axis run as one batch in the port) and the 3x3 box filter (integer
    sums, one division) equal JAX's."""
    vol = rng.integers(0, 25, (16, 24, 40)).astype(np.float32)
    vol[:, :, :3] = 1e3
    j = np.asarray(jsd._box_filter(jnp.asarray(vol), 1))
    t = tsd._box_filter(torch.from_numpy(vol), 1)
    np.testing.assert_array_equal(t.numpy(), j)
    ja = np.asarray(jsd.sgm_aggregate(jnp.asarray(j)))
    ta = tsd.sgm_aggregate(t).numpy()
    np.testing.assert_array_equal(ta, ja)


def _rendered_pair(k):
    """Frame k of the wall and its right view one baseline to the right."""
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                               texture=tsyn.make_structured_texture(
                                   1024, rng=np.random.default_rng(7)),
                               tex_scale=220.0)
    R, t = tsyn.default_trajectory(36)[k]
    base = CAM_KW["bf"] / CAM_ARGS[0]
    gl, _ = scene.render(R, t)
    gr, _ = scene.render(R, t - np.array([base, 0, 0], np.float32))
    return gl, gr


@pytest.mark.parametrize("case", ["shifted_48x160_d16", "rendered_240x320"])
def test_sgm_disparity_matches_jax(rng, case):
    """method="sgm" runs the jnp path's volume, aggregation and WTA tail in
    both packages: the valid masks agree on >= 99.5% of pixels (measured:
    all), and the disparities within 1e-4 px where both are valid (the
    parabola's float32 division; measured 4.8e-7). On the rendered pair
    (true disparity 8 px) most pixels are valid and right."""
    if case.startswith("shifted"):
        base = rng.uniform(0, 255, (48, 160 + 32)).astype(np.float32)
        left, right, d, true_d = base[:, 16:176], base[:, 21:181], 16, 5.0
    else:
        left, right = _rendered_pair(3)
        d, true_d = 64, None
    j = np.asarray(jsd.disparity(jnp.asarray(left), jnp.asarray(right),
                                 max_disp=d, method="sgm"))
    t = tsd.disparity(torch.from_numpy(left), torch.from_numpy(right),
                      max_disp=d, method="sgm").numpy()
    assert ((j > 0) == (t > 0)).mean() >= 0.995
    both = (j > 0) & (t > 0)
    np.testing.assert_allclose(t[both], j[both], atol=1e-4, rtol=0)
    assert both.mean() > 0.5
    if true_d is not None:
        assert np.median(np.abs(t[both] - true_d)) < 0.1
    else:
        depth = tsd.disparity_to_depth(torch.from_numpy(t),
                                       CAM_KW["bf"]).numpy()
        assert np.median(np.abs(depth[both] - 3.0)) < 0.05


def test_sgm_does_not_launch_k3(rng):
    """The SGM path never reaches kernel K3 or its plain version."""
    from plvs_tpu_torch.ops import stereo as tst

    base = rng.uniform(0, 255, (16, 64 + 16)).astype(np.float32)
    before = tst.launches
    called = []
    plain = tst.disparity_wta_plain
    tst.disparity_wta_plain = lambda *a, **k: called.append(1)
    try:
        tsd.disparity(torch.from_numpy(base[:, 8:72]),
                      torch.from_numpy(base[:, 11:75]), max_disp=8,
                      method="sgm")
    finally:
        tst.disparity_wta_plain = plain
    assert tst.launches == before and not called
    with pytest.raises(ValueError):
        tsd.disparity(torch.from_numpy(base[:, :64]),
                      torch.from_numpy(base[:, :64]), method="bm")


# ---------------------------------------------------------------------------
# the dense mapper's entry points and settings
# ---------------------------------------------------------------------------

MAPPERS = {
    # the far field beyond 2.5 m (the orbit sees the room's walls at
    # 2.4-4 m) into the coarse volume, carving every 2 keyframes, the
    # fixed-shape slot floor
    "multi_res_carve": dict(multi_res=True, split_depth=2.5, carve_every=2,
                            fixed_shapes=True),
    "unfiltered": dict(filter_depth=False),
}


def _room_frames(n=5):
    room = tsyn.SyntheticRoom(tcam.pinhole(*CAM_ARGS, **CAM_KW), half=3.0,
                              tex_size=1024, seed=3)
    poses = tsyn.orbit_loop_trajectory(24, radius=0.6, laps=0.5)[::4][:n]
    return list(room.sequence(poses))


@pytest.fixture(scope="module", params=list(MAPPERS))
def mappers(request):
    """Five room keyframes through ``insert_keyframe_rgbd`` (gray color,
    mesh every keyframe) in both packages, then a rebuild of both at
    shifted poses."""
    kw = dict(MAPPERS[request.param], voxel_size=VOXEL, max_blocks=4096,
              mesh_every=1)
    frames = _room_frames()
    jm = JMapper(jcam.pinhole(*CAM_ARGS, **CAM_KW), **kw)
    tm = DenseMapper(tcam.pinhole(*CAM_ARGS, **CAM_KW), device="cpu", **kw)
    for i, (_, g, d, R, t) in enumerate(frames):
        jm.insert_keyframe_rgbd(i, g, d, R, t)
        tm.insert_keyframe_rgbd(i, g, d, R, t)
    before = {}
    for name, m in (("j", jm), ("t", tm)):
        V, F = m.mesh()
        before[name] = dict(cloud=m.cloud()[0], V=V, F=F,
                            remesh=list(m.remesh_counts),
                            cache=m.mesher.n_triangles if name == "t" else
                            sum(len(x) for x in m.mesher._block_tris.values()))
    shift = np.array([0.01, -0.02, 0.0], np.float32)
    for m in (jm, tm):
        m.rebuild(lambda k: (frames[k][3], frames[k][4] + shift)
                  if k != 2 else (None, None))
    return request.param, jm, tm, before


def _same_volume_state(jv, tv, off_frac=0.0):
    """The same blocks, allocation frames, versions and frame counter;
    tsdf and weight within 1e-5 on all voxels but an ``off_frac`` share."""
    assert tv.n_blocks == jv.n_blocks > 0
    n = jv.n_blocks
    np.testing.assert_array_equal(tv.block_coords, jv.block_coords)
    np.testing.assert_array_equal(tv.block_alloc_frame, jv.block_alloc_frame)
    np.testing.assert_array_equal(tv.block_version, jv.block_version)
    assert tv.frame_idx == jv.frame_idx
    for a in ("tsdf", "weight"):
        off = np.abs(getattr(tv, a)[:n] - getattr(jv, a)[:n]) > 1e-5
        assert off.mean() <= off_frac, (a, off.sum())


def test_mapper_insert_matches_jax(mappers):
    """Before the rebuild: the same blocks, allocation frames and versions
    in both volumes, tsdf / weight within 1e-5 (measured 6e-6: float32
    voxel projections, as test_integrate_carried_volume), the same
    remeshed block counts, occupied voxels and triangles (the mesh after
    each keyframe reflects that keyframe: the touched blocks are settled
    first)."""
    name, jm, tm, before = mappers
    jb, tb = before["j"], before["t"]
    assert tb["remesh"] == jb["remesh"] and jb["remesh"][0] > 0
    assert len(tb["cloud"]) == len(jb["cloud"]) > 1000
    assert tb["F"].shape == jb["F"].shape and tb["cache"] == jb["cache"]
    np.testing.assert_allclose(tb["V"], jb["V"], atol=1e-4)
    if name == "multi_res_carve":
        assert (tm.coarse.voxel_size, tm.coarse.max_blocks) == (
            VOXEL * 4, 1024)


def test_mapper_rebuild_both_volumes(mappers):
    """After the rebuild at shifted poses (one keyframe dropped): both
    volumes hold JAX's state again, the tsdf and weight on all but 0.5% of
    the voxels, and the clouds of both volumes within 0.5%. The shifted
    poses of the two keyframes that face a wall squarely put a plane of
    123 voxels right at the truncation edge (sdf = -trunc to within one
    float32 ulp), which one package takes and the other not (measured:
    0.18% of the fine voxels, weight and tsdf off by 1; every other voxel
    within 6e-6)."""
    name, jm, tm, _ = mappers
    _same_volume_state(jm.volume, tm.volume, off_frac=0.005)
    if name == "multi_res_carve":
        _same_volume_state(jm.coarse, tm.coarse, off_frac=0.005)
    jp, tp = jm.cloud()[0], tm.cloud()[0]
    assert len(jp) > 1000 and abs(len(tp) - len(jp)) <= 0.005 * len(jp)
    assert len(tm.keyframes) == len(jm.keyframes) == 5


def test_mapper_far_field_and_carving(rng):
    """The coarse volume receives exactly the depth beyond split_depth, and
    carving clears the same unstable voxels in both packages: a sparse
    noise depth (weight < 2) in an old block is carved at the cadence."""
    frames = _room_frames(4)
    kw = dict(voxel_size=VOXEL, max_blocks=4096, multi_res=True,
              split_depth=2.5, carve_every=4, filter_depth=False)
    jm = JMapper(jcam.pinhole(*CAM_ARGS, **CAM_KW), **kw)
    tm = DenseMapper(tcam.pinhole(*CAM_ARGS, **CAM_KW), device="cpu", **kw)
    for i, (_, g, d, R, t) in enumerate(frames):
        d = d.copy()
        if i == 0:   # speckle: a few pixels 0.5 m in front of the wall
            idx = rng.choice(d.size, 40, replace=False)
            d.reshape(-1)[idx] -= 0.5
        jm.insert_keyframe_rgbd(i, g, d, R, t)
        tm.insert_keyframe_rgbd(i, g, d, R, t)
        if i == 2:
            # a host read applies the lazily fetched changed-block masks,
            # before the carve bumps the old blocks' versions: read both
            jw = jm.volume.weight.copy()
            np.testing.assert_allclose(tm.volume.weight, jw, atol=1e-5)
    _same_volume_state(jm.volume, tm.volume)
    _same_volume_state(jm.coarse, tm.coarse)
    assert jm.coarse.n_blocks > 0
    n = jm.volume.n_blocks
    carved = (jw[:n] > 0) & (jw[:n] < 2.0) & (jm.volume.weight[:n] == 0)
    assert carved.sum() > 0
    np.testing.assert_array_equal(tm.volume.weight[:n][carved], 0.0)


def test_mapper_stereo_insert(rng):
    """``insert_keyframe_stereo``: K3's plain version here against the JAX
    package's jnp box path, which differ at image borders (ROADMAP.md
    queue 3, "Stereo borders"): the occupied voxels within 10% and the wall
    in the same place; the stored color is the left image in 3 channels."""
    kw = dict(voxel_size=VOXEL, max_blocks=4096, mesh_every=1)
    jm = JMapper(jcam.pinhole(*CAM_ARGS, **CAM_KW), **kw)
    tm = DenseMapper(tcam.pinhole(*CAM_ARGS, **CAM_KW), device="cpu", **kw)
    R, t = tsyn.default_trajectory(36)[3]
    gl, gr = _rendered_pair(3)
    jm.insert_keyframe_stereo(0, gl, gr, R, t)
    tm.insert_keyframe_stereo(0, gl, gr, R, t)
    jp, tp = jm.cloud()[0], tm.cloud()[0]
    assert len(jp) > 1000 and abs(len(tp) - len(jp)) <= 0.1 * len(jp)
    assert abs(np.median(tp[:, 2]) - np.median(jp[:, 2])) < 0.01
    assert tuple(tm.keyframes[0].color.shape) == (240, 320, 3)
    assert tm.remesh_counts and tm.remesh_counts[0] > 0
