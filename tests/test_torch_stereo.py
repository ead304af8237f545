"""The port's stereo path against the JAX package's on equal inputs: the
census transform, kernel K3's plain version (against the Pallas kernel run
in interpret mode), the box-method disparity, the stereo frame builders,
and a 12-frame stereo run with dense mapping through both Systems.

The port's stereo line builder departs from the JAX package's in how it
matches left and right lines (``frame.build_frame_lines_stereo``'s
docstring): its endpoint depths are held to the rendered wall, and the
System run gives the JAX package the port's line depths at run time
(``port_stereo_line_depths`` of tests/port_departures.py: the JAX
builder's keylines, the port's depths), as tests/test_torch_sensor_lines.py
repairs its pose solve."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.dense import stereo_depth as jsd
from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.io import evaluation
from plvs_tpu.ops import stereo as jst
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu.slam import frame as jframe
from plvs_tpu_torch.dense import stereo_depth as tsd
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.ops import stereo as tst
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam import frame as tframe
from plvs_tpu_torch.slam.tracking import OK

from port_departures import port_stereo_line_depths

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
BASELINE = CAM_KW["bf"] / CAM_ARGS[0]
N_FRAMES = 12
FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384,
             use_lines=True, max_lines=64, sensor="stereo", local_ba=False,
             loop_closing=False, dense_mapping=True, dense_voxel_size=0.04,
             dense_mesh_every=1, pipelined=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _shifted_pair(rng, h, w, d, true_d):
    base = rng.uniform(0, 255, (h, w + 2 * d)).astype(np.float32)
    return base[:, d:w + d], base[:, d + true_d:w + d + true_d]


def _scene():
    tex = tsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    return tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                              texture=tex, tex_scale=220.0)


def _stereo_frames(n):
    """(ts, left, right, R, t): the right image one baseline to the right."""
    scene = _scene()
    out = []
    for ts, g, _, R, t in scene.sequence(tsyn.default_trajectory(36)[:n]):
        g_r, _ = scene.render(R, t - np.array([BASELINE, 0, 0], np.float32))
        out.append((ts, g, g_r, R, t))
    return out


@pytest.mark.parametrize("window", [1, 2])
def test_census_transform_exact(rng, window):
    img = rng.uniform(0, 255, (37, 61)).astype(np.float32)
    img[5:9, 10:20] = 7.0   # ties: a flat patch
    j = np.asarray(jsd.census_transform(jnp.asarray(img), window))
    t = tsd.census_transform(torch.from_numpy(img), window)
    np.testing.assert_array_equal(t.numpy(), j.view(np.int32))


@pytest.mark.parametrize("case", ["shifted_32x128_d16", "ragged_37x150_d16",
                                  "random_words_24x64_d16",
                                  "textureless_16x128_d16"])
def test_wta_plain_matches_pallas_interpret(rng, case):
    """Exact: integer cost sums and the same float32 steps, each rounded
    once in the same order (measured: bit-identical, validity included)."""
    if case.startswith("shifted") or case.startswith("ragged"):
        h, w = (32, 128) if case.startswith("shifted") else (37, 150)
        left, right = _shifted_pair(rng, h, w, 16, 5)
        cl = np.asarray(jsd.census_transform(jnp.asarray(left), 2))
        cr = np.asarray(jsd.census_transform(jnp.asarray(right), 2))
    elif case.startswith("random"):
        cl = rng.integers(0, 2 ** 32, (24, 64), dtype=np.uint64).astype(
            np.uint32)
        cr = rng.integers(0, 2 ** 32, (24, 64), dtype=np.uint64).astype(
            np.uint32)
    else:
        cl = cr = np.asarray(jsd.census_transform(
            jnp.zeros((16, 128), jnp.float32), 2))
    j = np.asarray(jst.disparity_wta_pallas(jnp.asarray(cl), jnp.asarray(cr),
                                            max_disp=16, interpret=True))
    t = tst.disparity_wta_plain(torch.from_numpy(cl.view(np.int32)),
                                torch.from_numpy(cr.view(np.int32)),
                                max_disp=16).numpy()
    np.testing.assert_array_equal(t, j)
    if case.startswith("textureless"):
        assert (t < 0).all()          # the uniqueness gate rejects all
    elif case.startswith("shifted"):
        assert (t > 0).mean() > 0.8


def test_wta_wrapper_takes_the_plain_version_on_the_cpu(rng):
    left, right = _shifted_pair(rng, 16, 64, 8, 3)
    cl = tsd.census_transform(torch.from_numpy(left))
    cr = tsd.census_transform(torch.from_numpy(right))
    before = tst.launches
    out = tst.disparity_wta(cl, cr, max_disp=8)
    assert tst.launches == before     # no kernel launch for CPU tensors
    assert torch.equal(out, tst.disparity_wta_plain(cl, cr, max_disp=8))
    with pytest.raises(ValueError):
        tst.disparity_wta(cl, cr, max_disp=2)


@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_wta_band_fits_shared_memory(r):
    """K3's band fits one block for every width up to 1280 at r <= 3."""
    for w in range(1, 1281):
        band = tst.band_config(w, r)
        assert band.smem_bytes <= tst.SMEM_PER_BLOCK == 232448
        assert band.threads <= tst.MAX_THREADS and band.threads % 32 == 0
        assert band.threads * band.cols_per_thread >= w + 2 * r
        assert band.rows == (4 if band.cols_per_thread == 1 else 2)


def test_wta_band_at_the_main_path_shape():
    """480x640, r = 3: 120 blocks of 4 rows, one thread per column of the
    band and its halo, 85 KB of shared memory (vertical sums of two
    disparities, double-buffered, in rows of 648 for 16-B loads; right
    winners; 10 right census rows)."""
    band = tst.band_config(640, 3)
    assert band == tst.Band(rows=4, cols_per_thread=1, threads=672,
                            smem_bytes=4 * (2 * 2 * 4 * 648 + 2 * 4 * 640
                                            + 10 * 640))
    assert -(-480 // band.rows) == 120


@pytest.mark.parametrize("w,r,d", [(640, 8, 64), (640, -1, 64),
                                   (1403, 3, 64), (2000, 0, 64),
                                   (640, 3, 8193)])
def test_wta_band_refuses_what_the_kernel_does_not_take(w, r, d):
    with pytest.raises(ValueError):
        tst.band_config(w, r, d)


def test_disparity_matches_jnp_path_away_from_borders(rng):
    """The port (K3 semantics) against the JAX package's jnp volume path,
    masked at the borders as tests/test_ops.py does: the two differ only in
    border handling (ROADMAP.md queue 3, "Stereo borders")."""
    H, W, D, true_d = 32, 128, 16, 5
    left, right = _shifted_pair(rng, H, W, D, true_d)
    ref = np.asarray(jsd.disparity(jnp.asarray(left), jnp.asarray(right),
                                   max_disp=D))
    out = tsd.disparity(torch.from_numpy(left), torch.from_numpy(right),
                        max_disp=D).numpy()
    m = (ref > 0) & (out > 0)
    m[:6] = m[-6:] = False
    m[:, :D + 6] = False
    m[:, -6:] = False
    assert m.sum() > 0.5 * m.size * 0.5
    assert np.abs(ref[m] - out[m]).max() < 0.1
    assert np.abs(out[m] - true_d).max() < 0.6
    assert ((ref > 0) != (out > 0))[6:-6, D + 6:-6].mean() < 0.02
    # an unknown method raises; "sgm" is ported (tests/test_torch_dense.py)
    with pytest.raises(ValueError):
        tsd.disparity(torch.from_numpy(left), torch.from_numpy(right),
                      max_disp=D, method="census")


@pytest.fixture
def pallas_route(monkeypatch):
    """The JAX ``disparity`` on its TPU route: ``use_pallas()`` patched
    true and the Pallas kernel run in interpret mode; a fresh jit of the
    function so no trace of its CPU route is reused."""
    import functools

    import jax
    import plvs_tpu.ops

    traced = []
    kernel = functools.partial(jst.disparity_wta_pallas, interpret=True)

    def interpreted(*a, **kw):
        traced.append(kw.get("max_disp"))
        return kernel(*a, **kw)

    monkeypatch.setattr(plvs_tpu.ops, "use_pallas", lambda: True)
    monkeypatch.setattr(jst, "disparity_wta_pallas", interpreted)
    return jax.jit(jsd.disparity.__wrapped__,
                   static_argnames=("max_disp",)), traced


def test_dense_map_matches_the_pallas_route(pallas_route):
    """The port's disparity (K3's plain version, the kernel's border
    semantics) against the JAX package's Pallas route at 96x128 with 32
    disparities, borders included: exact (measured: bit-equal, validity
    included). Then one TSDF integration of each package's depth: the same
    blocks, tsdf and weight within 1e-5 (float32 voxel projections in
    another order, as tests/test_torch_dense.py states)."""
    args, kw = (120.0, 120.0, 64.0, 48.0), dict(width=128, height=96,
                                                bf=24.0)
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*args, **kw), wall_z=3.0,
                               texture=tsyn.make_structured_texture(
                                   1024, rng=np.random.default_rng(7)),
                               tex_scale=220.0)
    R, t = tsyn.default_trajectory(12)[4]
    left, _ = scene.render(R, t)
    right, _ = scene.render(R, t - np.array([kw["bf"] / args[0], 0, 0],
                                            np.float32))
    route, traced = pallas_route
    ref = np.asarray(route(jnp.asarray(left), jnp.asarray(right),
                           max_disp=32))
    assert traced == [32]     # the JAX call took the Pallas kernel
    out = tsd.disparity(torch.from_numpy(left), torch.from_numpy(right),
                        max_disp=32).numpy()
    np.testing.assert_array_equal(out, ref)
    assert (out > 0).mean() > 0.5 and (out[:, :32] <= 0).any()
    assert abs(np.median(out[out > 0]) - kw["bf"] / 3.0) < 0.5

    from plvs_tpu.dense.tsdf import TSDFVolume as JVolume
    from plvs_tpu_torch.dense.tsdf import TSDFVolume as TVolume

    jd = np.asarray(jsd.disparity_to_depth(jnp.asarray(ref), kw["bf"]))
    td = tsd.disparity_to_depth(torch.from_numpy(out), kw["bf"]).numpy()
    np.testing.assert_array_equal(td, jd)
    color = np.repeat(left[..., None], 3, -1)
    jvol = JVolume(jcam.pinhole(*args, **kw), voxel_size=0.04,
                   max_blocks=2048)
    tvol = TVolume(tcam.pinhole(*args, **kw), voxel_size=0.04,
                   max_blocks=2048, device="cpu")
    jvol.integrate(jd, color, R, t)
    tvol.integrate(td, color, R, t)
    n = jvol.n_blocks
    assert n > 20 and tvol.n_blocks == n
    np.testing.assert_array_equal(tvol.block_coords, jvol.block_coords)
    for name in ("tsdf", "weight"):
        np.testing.assert_allclose(getattr(tvol, name)[:n],
                                   getattr(jvol, name)[:n], atol=1e-5,
                                   err_msg=name)


def test_disparity_to_depth_exact(rng):
    disp = rng.uniform(-2, 60, (24, 40)).astype(np.float32)
    disp[3, :5] = 0.0
    j = np.asarray(jsd.disparity_to_depth(jnp.asarray(disp), 24.0))
    t = tsd.disparity_to_depth(torch.from_numpy(disp), 24.0).numpy()
    np.testing.assert_array_equal(t, j)


def test_build_frame_stereo():
    """Keypoints as in test_torch_features (>= 97% identical positions).
    On identical keypoints the stereo match (uR >= 0) agrees on >= 97%.
    Depths of keypoints matched in both: >= 97% within 1e-5 relative
    (float32 SAD sums in another order; measured <= 3e-6), all within 10%:
    a descriptor 1-2 bits apart (test_torch_features) can pick another
    right keypoint or SAD bin (measured on frames 1, 3, 6: 4, 2 and 0 of
    ~250, up to 6.7%)."""
    _, left, right, _, _ = _stereo_frames(4)[3]
    cam_j = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    cam_t = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    jf = jframe.build_frame_stereo(jnp.asarray(left), jnp.asarray(right),
                                   cam_j, 512, 4, 1.2)
    tf = tframe.build_frame_stereo(torch.from_numpy(left),
                                   torch.from_numpy(right), cam_t, 512, 4, 1.2)
    same = (np.all(tf.kp.xy.numpy() == np.asarray(jf.kp.xy), -1)
            & (tf.kp.mask.numpy() == np.asarray(jf.kp.mask)))
    assert same.mean() >= 0.97, same.mean()
    jm = np.asarray(jf.uvr)[:, 2] >= 0
    tm = tf.uvr.numpy()[:, 2] >= 0
    assert jm[same].sum() > 100
    assert (jm[same] == tm[same]).mean() >= 0.97
    both = same & jm & tm
    jd, td = np.asarray(jf.depth)[both], tf.depth.numpy()[both]
    rel = np.abs(td - jd) / jd
    assert (rel <= 1e-5).mean() >= 0.97, np.sort(rel)[-10:]
    assert rel.max() < 0.1, np.sort(rel)[-10:]


@pytest.mark.parametrize("k", [0, 10])
def test_build_frame_lines_stereo(k):
    """Keylines as in test_torch_features: the same valid set. Endpoint
    depths against the rendered wall (the port's left-right line match
    departs from the JAX package's): at least 5 start points have one, the
    port gets within 5% of the wall at least as many endpoints as the JAX
    package, and every endpoint the JAX package gets within 5%."""
    _, left, right, R, t = _stereo_frames(k + 1)[k]
    _, wall = _scene().render(R, t)
    cam_j = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    cam_t = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    jl = jframe.build_frame_lines_stereo(jnp.asarray(left),
                                         jnp.asarray(right), cam_j, 64)
    tl = tframe.build_frame_lines_stereo(torch.from_numpy(left),
                                         torch.from_numpy(right), cam_t, 64)
    m = np.asarray(jl.kl.mask)
    np.testing.assert_array_equal(tl.kl.mask.numpy(), m)
    for a, xy in (("depth_s", tl.kl.sp), ("depth_e", tl.kl.ep)):
        xi = np.clip(np.round(xy[:, 0].numpy()).astype(int), 0, 319)
        yi = np.clip(np.round(xy[:, 1].numpy()).astype(int), 0, 239)
        truth = wall[yi, xi]
        jd, td = np.asarray(getattr(jl, a)), getattr(tl, a).numpy()
        j_good = (jd > 0) & (np.abs(jd - truth) < 0.05 * truth)
        t_good = (td > 0) & (np.abs(td - truth) < 0.05 * truth)
        assert t_good.sum() >= j_good.sum(), (jd, td, truth)
        assert t_good[j_good].all(), (jd, td, truth)
    assert (tl.depth_s.numpy() > 0).sum() >= 5


@pytest.fixture(scope="module")
def runs():
    frames = _stereo_frames(N_FRAMES)

    def run(system):
        states = [int(system.track_stereo(gl, gr, ts)[0])
                  for ts, gl, gr, _, _ in frames]
        dm = system.dense_mapper
        pts, _ = dm.cloud()
        V, F = dm.mesh()
        return dict(states=states, traj=system.trajectory_tum(),
                    map=system.map_statistics(), cloud=pts, faces=len(F),
                    cached_tris=int(sum(len(t) for t in
                                        dm.mesher._block_tris.values())),
                    blocks=dm.volume.n_blocks)

    with port_stereo_line_depths():
        jres = run(JSystem(jcam.pinhole(*CAM_ARGS, **CAM_KW),
                           JConfig(**FLAGS)))
    tres = run(TSystem(tcam.pinhole(*CAM_ARGS, **CAM_KW), TConfig(**FLAGS),
                       device="cpu"))
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    return jres, tres, gt


def test_stereo_system_tracks_every_frame(runs):
    jres, tres, _ = runs
    assert all(s == OK for s in jres["states"][1:]), jres["states"]
    assert all(s == OK for s in tres["states"][1:]), tres["states"]
    assert tres["map"]["keyframes"] >= 2


def test_stereo_system_poses_and_ate_agree(runs):
    """Per-frame positions within 1 cm and the ATEs within 20% (+1 mm) of
    each other: stereo keypoint depths agree to 1e-3 relative (see
    test_build_frame_stereo) and a borderline match can flip, as for the
    RGB-D run in test_torch_system."""
    jres, tres, gt = runs
    jt, tt = jres["traj"], tres["traj"]
    np.testing.assert_allclose(tt[:, 0], jt[:, 0])
    dpos = np.linalg.norm(tt[:, 1:4] - jt[:, 1:4], axis=1)
    assert dpos.max() < 1e-2, dpos
    ate_j = evaluation.ate_rmse(jt[:, 1:4], gt, align=True)
    ate_t = evaluation.ate_rmse(tt[:, 1:4], gt, align=True)
    assert abs(ate_t - ate_j) <= 0.2 * max(ate_j, ate_t) + 1e-3, (ate_j,
                                                                  ate_t)


def test_stereo_system_dense_map_agrees(runs):
    """Dense map counts within 10% and the wall (z = 3 m) in the same
    place: the port's disparity has the TPU kernel's border semantics where
    the JAX package on the CPU runs its jnp path, so border pixels of each
    keyframe's depth differ."""
    jres, tres, _ = runs
    for key in ("blocks", "faces", "cached_tris"):
        assert abs(tres[key] - jres[key]) <= 0.1 * jres[key], (
            key, jres[key], tres[key])
    nj, nt = len(jres["cloud"]), len(tres["cloud"])
    assert nj > 1000 and abs(nt - nj) <= 0.1 * nj, (nj, nt)
    zj = np.median(np.abs(jres["cloud"][:, 2] - 3.0))
    zt = np.median(np.abs(tres["cloud"][:, 2] - 3.0))
    assert abs(zt - zj) < 0.01, (zj, zt)
