"""The port's incremental 3D segmentation against the JAX package's: the
depth-noise weight, the normals and the edge stage of ``segment_depth``,
the capped min-label flood fill and area threshold (fed JAX's own
connectivity), ``relabel_compact``, the global label map, the per-voxel
label fusion, the voxel label queries on one carried-across volume, and a
12-frame RGB-D System with ``dense_segmentation`` through both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.dense import labels as jlab
from plvs_tpu.dense import processing as jproc
from plvs_tpu.dense import tsdf as jtsdf
from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.io import evaluation
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu.utils import depth_model as jdm
from plvs_tpu_torch import convert
from plvs_tpu_torch.dense import labels as tlab
from plvs_tpu_torch.dense import processing as tproc
from plvs_tpu_torch.dense import tsdf as ttsdf
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam.tracking import OK
from plvs_tpu_torch.utils import depth_model as tdm

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
JCAM = jcam.pinhole(*CAM_ARGS, **CAM_KW)
TCAM = tcam.pinhole(*CAM_ARGS, **CAM_KW)
VOXEL = 0.04


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _room(n=24):
    room = tsyn.SyntheticRoom(TCAM, half=3.0, tex_size=1024, seed=3)
    poses = tsyn.orbit_loop_trajectory(n, radius=0.6, laps=0.5)
    return list(room.sequence(poses))


def _depth(name):
    """Depth scenes: a room view with two boxes, a slanted plane and 2%
    dropouts; tests/test_segmentation.py's two planes; a planar spiral
    corridor (3 px wide) far longer than the fill's h + w iterations."""
    rng = np.random.default_rng(0)
    if name == "room_boxes":
        d = _room()[10][2].copy()
        d[60:120, 80:160] = 1.5
        d[150:200, 200:260] = 1.7 + 0.002 * np.arange(60)[None, :]
        d[rng.random(d.shape) < 0.02] = 0.0
        return d.astype(np.float32)
    if name == "two_planes":
        d = np.full((240, 320), 2.0, np.float32)
        d[:, 160:] = 1.0
        return d
    m = np.kron(tsyn.spiral(80, 106), np.ones((3, 3), bool))
    d = np.zeros((240, 320), np.float32)
    d[:, :318][m] = 2.0
    return d


def _jax_segment(depth):
    """JAX's segment_depth, with the connectivity it hands its fill."""
    seen = {}
    fill = jproc._propagate_labels

    def recording(labels, connect, n_iters):
        seen["connect"] = np.asarray(connect)
        return fill(labels, connect, n_iters)

    jproc._propagate_labels = recording
    try:
        labels, nrm = jproc.segment_depth(JCAM, jnp.asarray(depth))
    finally:
        jproc._propagate_labels = fill
    return np.asarray(labels), np.asarray(nrm), seen["connect"]


SCENES = ["room_boxes", "two_planes", "spiral"]


def test_depth_noise_weight(rng):
    z = rng.uniform(0.0, 9.0, 4096).astype(np.float32)
    z[:5] = (0.0, 0.4, 0.5, -1.0, 30.0)
    np.testing.assert_array_equal(
        tdm.sigma_z_min_over_sigma_z(torch.from_numpy(z)).numpy(),
        np.asarray(jdm.sigma_z_min_over_sigma_z(jnp.asarray(z))))


@pytest.mark.parametrize("scene", SCENES)
def test_connectivity_and_normals_match(scene):
    """The edge stage: links agree on >= 99.9% of the 4 x H x W edges
    (measured: all), normals within 1e-4 (float32 cross products and norms
    in another op order; measured 8e-6)."""
    depth = _depth(scene)
    _, jn, jc = _jax_segment(depth)
    tc, tn, tv = tproc.segment_connectivity(TCAM, torch.from_numpy(depth))
    assert (tc.numpy() == jc).mean() >= 0.999
    np.testing.assert_array_equal(tv.numpy(), depth > 0)
    np.testing.assert_allclose(tn.numpy(), jn, atol=1e-4)
    assert not tc[0, 0].any() and not tc[3, :, -1].any()   # borders severed


@pytest.mark.parametrize("scene", SCENES)
def test_labels_exact_fed_jax_connectivity(scene):
    """The capped fill (h + w iterations from each pixel's 1-based index,
    invalid pixels at 1 << 30) and the area threshold on JAX's own links
    give JAX's labels exactly; segment_depth end to end agrees on >= 99.9%
    of the pixels (measured: all)."""
    depth = _depth(scene)
    jl, _, jc = _jax_segment(depth)
    tl = tproc.label_components(torch.from_numpy(jc),
                                torch.from_numpy(depth > 0))
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), jl)
    own, _ = tproc.segment_depth(TCAM, torch.from_numpy(depth))
    assert (own.numpy() == jl).mean() >= 0.999
    assert len(np.unique(jl[jl > 0])) >= (2 if scene != "spiral" else 1)


def test_fill_is_capped_like_jax():
    """The fill stops after h + w iterations, converged or not: on the
    spiral corridor (~12k px long) one connected region keeps several
    labels in both packages; with enough iterations it has one."""
    depth = _depth("spiral")
    jl, _, jc = _jax_segment(depth)
    c, v = torch.from_numpy(jc), torch.from_numpy(depth > 0)
    capped = tproc.label_components(c, v).numpy()
    np.testing.assert_array_equal(capped, jl)
    assert len(np.unique(capped[capped > 0])) > 1
    full = tproc.label_components(c, v, n_iters=20000).numpy()
    assert len(np.unique(full[full > 0])) == 1


def test_relabel_compact_exact(rng):
    lab = rng.choice([0, 5, 17, 1 << 20, 3, 99], (48, 64)).astype(np.int32)
    jo, jn = jproc.relabel_compact(lab)
    to, tn = tproc.relabel_compact(lab)
    assert tn == jn == 5
    assert to.dtype == jo.dtype
    np.testing.assert_array_equal(to, jo)
    assert tproc.relabel_compact(np.zeros((4, 4), np.int32))[1] == 0


def test_global_label_map_exact(rng):
    """The same sequence of associations allocates the same global ids:
    new segments, overlaps that pass or miss the thresholds, ties of the
    overlap histogram (argmax takes the lowest global id)."""
    jm, tm = jlab.GlobalLabelMap(), tlab.GlobalLabelMap()
    glob = np.zeros((60, 80), np.int32)
    for k in range(6):
        local = np.zeros((60, 80), np.int32)
        for i in range(1, 5):
            y, x = rng.integers(0, 50), rng.integers(0, 70)
            local[y:y + rng.integers(5, 30), x:x + rng.integers(5, 30)] = i
        local, _ = tproc.relabel_compact(local)
        jl = jm.associate(local, glob)
        tl = tm.associate(local, glob)
        np.testing.assert_array_equal(tl, jl)
        assert tm.next_global == jm.next_global
        glob = np.where(local > 0, tm.apply(local, tl), glob)
        if k == 3:   # a tie: two globals overlap a segment equally
            glob[:, :40], glob[:, 40:] = 7, 8
    assert jm.next_global > 5
    pos = rng.uniform(-3, 3, (40, 3)).astype(np.float32)
    mask = rng.random(40) < 0.8
    np.testing.assert_array_equal(
        tlab.keyframes_in_radius(pos, mask, np.zeros(3), 2.0),
        jlab.keyframes_in_radius(pos, mask, np.zeros(3), 2.0))


@pytest.fixture(scope="module")
def labelled():
    """A JAX volume with labels after three room frames (integrate, then
    integrate_labels of each frame's segmentation twice, so observed
    voxels reach confidence 2), and its copy in the port."""
    frames = _room()[::4][:3]
    jvol = jtsdf.TSDFVolume(JCAM, voxel_size=VOXEL, max_blocks=4096,
                            with_labels=True)
    for i, (_, g, d, R, t) in enumerate(frames):
        jvol.integrate(d, g, R, t)
        lab, _ = jproc.segment_depth(JCAM, jnp.asarray(d))
        lab, _ = jproc.relabel_compact(np.asarray(lab))
        for _ in range(2):
            jvol.integrate_labels(d, lab + 3 * (lab > 0) * i, R, t)
    tvol = convert.tsdf_volume_from_numpy(TCAM, convert.tsdf_state(jvol),
                                          device="cpu", voxel_size=VOXEL)
    return jvol, tvol, frames


def test_label_update_exact(labelled, rng):
    """_label_update on one state and label image: labels and confidences
    equal (a voxel's pixel and band test come from the same float32 voxel
    projection as the TSDF update; measured: no voxel differs)."""
    jvol, tvol, frames = labelled
    n = jvol.n_blocks
    _, _, d, R, t = frames[1]
    img = rng.integers(0, 6, d.shape).astype(np.int32)
    lab0 = jvol.label[:n].copy()
    conf0 = jvol.label_conf[:n].copy()
    conf0[::3] = 1.0      # conflicts that flip
    jl, jc = jtsdf._label_update(
        jnp.asarray(jvol.block_coords[:n]), jnp.asarray(lab0),
        jnp.asarray(conf0), jnp.asarray(d), jnp.asarray(img),
        jnp.asarray(R), jnp.asarray(t), JCAM, VOXEL, jvol.trunc)
    tl, tc = ttsdf._label_update(
        torch.from_numpy(jvol.block_coords[:n]), torch.from_numpy(lab0),
        torch.from_numpy(conf0), torch.from_numpy(d), torch.from_numpy(img),
        torch.from_numpy(R), torch.from_numpy(t), TCAM, VOXEL, tvol.trunc)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    flipped = (np.asarray(jl) != lab0) & (lab0 > 0)
    assert flipped.any() and (np.asarray(jc) != conf0).any()


@pytest.mark.parametrize("max_conf", [64.0, 2.0])
def test_integrate_blocks_labels_exact(labelled, rng, max_conf):
    """The public fixed-shape label entry on the volume's blocks, at the
    default confidence cap and at one that binds: exact, as above."""
    jvol, tvol, frames = labelled
    n = jvol.n_blocks
    _, _, d, R, t = frames[2]
    img = rng.integers(0, 4, d.shape).astype(np.int32)
    lab0, conf0 = jvol.label[:n].copy(), jvol.label_conf[:n].copy()
    jl, jc = jtsdf.integrate_blocks_labels(
        jnp.asarray(jvol.block_coords[:n]), jnp.asarray(lab0),
        jnp.asarray(conf0), jnp.asarray(d), jnp.asarray(img),
        jnp.asarray(R), jnp.asarray(t), JCAM, VOXEL, jvol.trunc,
        max_conf=max_conf)
    lab_t, conf_t = torch.from_numpy(lab0), torch.from_numpy(conf0)
    tl, tc = ttsdf.integrate_blocks_labels(
        torch.from_numpy(jvol.block_coords[:n]), lab_t, conf_t,
        torch.from_numpy(d), torch.from_numpy(img), torch.from_numpy(R),
        torch.from_numpy(t), TCAM, VOXEL, tvol.trunc, max_conf=max_conf)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(lab_t.numpy(), lab0)   # inputs untouched
    assert float(tc.max()) <= max_conf and (tc.numpy() != conf0).any()


def test_voxel_label_queries_exact(labelled, rng):
    """On one carried-across state: labels_at (points on the surface,
    random points and unallocated space), segmented_cloud at two
    confidence floors, and one more integrate_labels of a frame."""
    jvol, tvol, frames = labelled
    pts, _ = jvol.occupied_cloud()
    q = np.concatenate([pts[::7], rng.uniform(-4, 4, (300, 3)).astype(
        np.float32), np.full((2, 3), 40.0, np.float32)])
    got = tvol.labels_at(q)
    np.testing.assert_array_equal(got, jvol.labels_at(q))
    assert (got > 0).sum() > 100 and (got[-2:] == 0).all()
    for min_conf in (1.0, 2.0):
        jp, jl = jvol.segmented_cloud(min_conf=min_conf)
        tp, tl = tvol.segmented_cloud(min_conf=min_conf)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tl, jl)
        assert len(np.unique(jl)) > 2
    _, _, d, R, t = frames[2]
    img = np.full(d.shape, 9, np.int32)
    jvol.integrate_labels(d, img, R, t)
    tvol.integrate_labels(d, img, R, t)
    np.testing.assert_array_equal(tvol.label, jvol.label)
    np.testing.assert_array_equal(tvol.label_conf, jvol.label_conf)


def test_mapper_carried_across_continues_like_jax():
    """A JAX DenseMapper with segmentation and the far field after three
    room keyframes, carried into the port (``dense_mapper_from_numpy``:
    both volumes, the label map's next id, the label images and the stored
    keyframes); both then insert a fourth keyframe and rebuild at the same
    poses: the same association (label image and next id), the same
    segmented cloud and the same voxel labels after the rebuild."""
    from plvs_tpu.dense.mapping import DenseMapper as JMapper

    frames = _room()[::4][:4]
    kw = dict(voxel_size=VOXEL, max_blocks=4096, use_segmentation=True,
              multi_res=True, split_depth=2.5)
    jm = JMapper(JCAM, **kw)
    for i, (_, g, d, R, t) in enumerate(frames[:3]):
        jm.insert_keyframe_rgbd(i, g, d, R, t)
    state = dict(volume=convert.tsdf_state(jm.volume),
                 coarse=convert.tsdf_state(jm.coarse),
                 next_global=jm.label_map.next_global, labels=jm.labels,
                 keyframes=[(k.kf_id, k.depth, np.asarray(k.color))
                            for k in jm.keyframes],
                 n_inserted=jm._n_inserted)
    tm = convert.dense_mapper_from_numpy(TCAM, state, device="cpu", **kw)
    assert tm.coarse.n_blocks == jm.coarse.n_blocks > 0
    _, g, d, R, t = frames[3]
    jm.insert_keyframe_rgbd(3, g, d, R, t)
    tm.insert_keyframe_rgbd(3, g, d, R, t)
    np.testing.assert_array_equal(tm.labels[3], jm.labels[3])
    assert tm.label_map.next_global == jm.label_map.next_global
    for a, b in zip(tm.segment_cloud(), jm.segment_cloud()):
        np.testing.assert_array_equal(a, b)
    poses = {i: (f[3], f[4]) for i, f in enumerate(frames)}
    for m in (jm, tm):
        m.rebuild(lambda k: poses[k])
    n = jm.volume.n_blocks
    assert tm.volume.n_blocks == n and len(tm.keyframes) == 4
    np.testing.assert_array_equal(tm.volume.label[:n], jm.volume.label[:n])
    np.testing.assert_array_equal(tm.volume.label_conf[:n],
                                  jm.volume.label_conf[:n])


# ---------------------------------------------------------------------------
# a System with dense segmentation
# ---------------------------------------------------------------------------

N_FRAMES = 12
FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384,
             dense_mapping=True, dense_segmentation=True,
             dense_voxel_size=VOXEL, loop_closing=False, max_kf_interval=4)


@pytest.fixture(scope="module")
def seg_runs():
    """demo_inseg.py's scene (the room orbit, radius 0.6, half a lap) over
    12 frames through both Systems, local BA on."""
    frames = _room(N_FRAMES * 2)[:N_FRAMES]

    def run(system):
        states = [int(system.track_rgbd(g, d, ts)[0])
                  for ts, g, d, _, _ in frames]
        dm = system.dense_mapper
        pts, lab = dm.segment_cloud()
        return dict(states=states, traj=system.trajectory_tum(),
                    map=system.map_statistics(), labels=dict(dm.labels),
                    seg_pts=pts, seg_lab=lab,
                    next_global=dm.label_map.next_global)

    jres = run(JSystem(JCAM, JConfig(**FLAGS)))
    tres = run(TSystem(TCAM, TConfig(**FLAGS), device="cpu"))
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    return jres, tres, gt


def test_segmentation_system_tracks_like_jax(seg_runs):
    """The same states (the room's panels give few corners at 320x240, so
    both initialize at the same frame after a few; every frame after it
    OK) and keyframes; positions within 1 cm and the ATEs within 20%
    (+1 mm) of each other, as the RGB-D runs of tests/test_torch_system.py
    hold them."""
    jres, tres, gt = seg_runs
    assert tres["states"] == jres["states"]
    first = jres["states"].index(OK)
    assert first < 6 and all(s == OK for s in jres["states"][first:])
    assert tres["map"]["keyframes"] == jres["map"]["keyframes"] >= 2
    jt, tt = jres["traj"], tres["traj"]
    assert np.linalg.norm(tt[:, 1:4] - jt[:, 1:4], axis=1).max() < 1e-2
    ate_j = evaluation.ate_rmse(jt[:, 1:4], gt, align=True)
    ate_t = evaluation.ate_rmse(tt[:, 1:4], gt, align=True)
    assert abs(ate_t - ate_j) <= 0.2 * max(ate_j, ate_t) + 1e-3


def test_segmentation_system_labels_like_jax(seg_runs):
    """The same keyframes segmented, the same global ids allocated, each
    keyframe's global label image equal on >= 99% of its pixels, and the
    segmented surface voxels and labelled ones within 2% (keyframe poses
    within 1e-2 move the voxels under the pixels)."""
    jres, tres, _ = seg_runs
    assert sorted(tres["labels"]) == sorted(jres["labels"])
    assert tres["next_global"] == jres["next_global"] > 1
    for k, jl in jres["labels"].items():
        assert (tres["labels"][k] == jl).mean() >= 0.99, k
    for key in ("seg_pts", "seg_lab"):
        nj = len(jres[key]) if key == "seg_pts" else (jres[key] > 0).sum()
        nt = len(tres[key]) if key == "seg_pts" else (tres[key] > 0).sum()
        assert nj > 1000 and abs(nt - nj) <= 0.02 * nj, (key, nj, nt)
