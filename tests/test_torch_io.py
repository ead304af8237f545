"""The port's host-side I/O against the JAX package's: trajectory files,
evaluation, the depth-noise model, map checkpoints in both directions,
dataset loaders, the benchmark harness and the command-line runner
(tests/test_io.py's cases run through both packages).

Tolerances: trajectory positions, timestamps and KITTI files are compared
byte for byte. A quaternion field may differ by one unit in its last
decimal: both packages build it with the same float32 formula, but XLA's
CPU sqrt (the quaternion's norm) is not always correctly rounded, so one
component in ~10 is one float32 ulp (6e-8) away, which flips a rounded
last decimal now and then. Everything else is exact or, for float32
rotations rebuilt from quaternions, within 1e-6.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu import native
from plvs_tpu.dense.tsdf import TSDFVolume as JVolume
from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.geometry import lie as jlie
from plvs_tpu.io import evaluation as jev
from plvs_tpu.io import serialization as jser
from plvs_tpu.io import trajectory as jtraj
from plvs_tpu.slam.map_store import MapStore as JStore
from plvs_tpu.utils import depth_model as jdm
from plvs_tpu.vocab import bow as jbow
from plvs_tpu_torch import convert
from plvs_tpu_torch.dense.tsdf import TSDFVolume as TVolume
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import benchmark as tbm
from plvs_tpu_torch.io import datasets as tds
from plvs_tpu_torch.io import evaluation as tev
from plvs_tpu_torch.io import serialization as tser
from plvs_tpu_torch.io import trajectory as ttraj
from plvs_tpu_torch.slam.map_store import MapStore as TStore
from plvs_tpu_torch.utils import depth_model as tdm
from plvs_tpu_torch.utils.profiling import Stopwatch
from plvs_tpu_torch.vocab import bow as tbow


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- trajectory files ---------------------------------------------------------

def _traj(seed=0, n=12):
    """(ts, R_cw, t_cw) with float32 rotations from the JAX so3_exp, as the
    System records them; tests/test_io.py's five poses first."""
    rng = np.random.default_rng(seed)
    w = np.zeros((n, 3), np.float32)
    w[:5, 1] = 0.1 * np.arange(5)
    w[5:] = rng.normal(size=(n - 5, 3)).astype(np.float32)
    R = np.asarray(jlie.so3_exp(jnp.asarray(w)))
    t = np.zeros((n, 3), np.float32)
    t[:5, 0] = 0.1 * np.arange(5)
    t[5:] = rng.normal(size=(n - 5, 3)).astype(np.float32)
    ts = np.arange(n) / 30.0 + 1403636579.76
    return [(float(ts[i]), R[i], t[i]) for i in range(n)]


def _fields_agree(line_j: str, line_t: str, sep: str, quat: slice,
                  unit: float):
    """Fields equal as text, the quaternion's within one last-decimal
    ``unit``."""
    fj, ft = line_j.strip().split(sep), line_t.strip().split(sep)
    assert len(fj) == len(ft)
    for k, (a, b) in enumerate(zip(fj, ft)):
        if k in range(len(fj))[quat]:
            assert abs(float(a) - float(b)) <= unit * 1.0001, (k, a, b)
        else:
            assert a == b, (k, a, b)


def test_tum_file_agrees_with_jax(tmp_path):
    traj = _traj()
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jtraj.write_tum(pj, traj)
    ttraj.write_tum(pt, traj)
    lj, lt = open(pj).readlines(), open(pt).readlines()
    assert len(lj) == len(lt) == len(traj)
    for a, b in zip(lj, lt):
        _fields_agree(a, b, " ", slice(4, 8), 1e-7)
    arr = ttraj.read_tum(pt)
    assert arr.shape == (len(traj), 8)
    np.testing.assert_array_equal(arr[:, :4], jtraj.read_tum(pj)[:, :4])
    Rwc = traj[1][1].T
    np.testing.assert_allclose(arr[1, 1:4], -Rwc @ traj[1][2], atol=1e-5)


def test_kitti_file_is_byte_equal(tmp_path):
    traj = _traj()
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    jtraj.write_kitti(pj, traj)
    ttraj.write_kitti(pt, traj)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    rows = [l.split() for l in open(pt)]
    assert len(rows) == len(traj) and len(rows[0]) == 12


def test_euroc_file_agrees_with_jax(tmp_path):
    traj = _traj()
    pj, pt = str(tmp_path / "j.csv"), str(tmp_path / "t.csv")
    jtraj.write_euroc(pj, traj)
    ttraj.write_euroc(pt, traj)
    lj, lt = open(pj).readlines(), open(pt).readlines()
    assert lt[0] == lj[0] and lt[0].startswith("#")
    assert len(lt) == len(traj) + 1
    for a, b in zip(lj[1:], lt[1:]):
        _fields_agree(a, b, ",", slice(4, 8), 1e-6)


# -- evaluation ---------------------------------------------------------------

def _circle(n=50, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    ts = np.arange(n) * 0.05
    th = ts * 0.3
    xyz = np.stack([np.cos(th), np.sin(th), 0.1 * th], -1)
    return ts, xyz + noise * rng.standard_normal(xyz.shape)


def test_associate_by_timestamp_matches_jax():
    rng = np.random.default_rng(1)
    est = np.sort(rng.uniform(0, 5, 80))
    gt = np.sort(rng.uniform(0, 5, 60))
    for md in (0.005, 0.02, 0.1):
        ej, gj = jev.associate(est, gt, max_difference=md)
        et, gt_ = tev.associate(est, gt, max_difference=md)
        np.testing.assert_array_equal(et, ej)
        np.testing.assert_array_equal(gt_, gj)
    ei, gi = tev.associate(np.array([0.0, 0.1, 0.2, 0.3]),
                           np.array([0.001, 0.102, 0.9]), 0.02)
    np.testing.assert_array_equal(ei, [0, 1])
    np.testing.assert_array_equal(gi, [0, 1])


def test_ate_timed_matches_jax():
    ts, xyz = _circle()
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1.0]])
    moved = xyz @ R.T + np.array([1.0, -2.0, 0.5])
    gt = np.column_stack([ts, xyz])
    est = np.column_stack([ts + 0.002, moved])
    assert tev.ate_rmse_timed(est, gt) < 1e-9
    scaled = np.column_stack([ts, 3.0 * xyz])
    assert tev.ate_rmse_timed(scaled, gt, with_scale=False) > 0.1
    assert tev.ate_rmse_timed(scaled, gt, with_scale=True) < 1e-9
    _, noisy = _circle(noise=0.02, seed=3)
    est = np.column_stack([ts + 0.001, noisy @ R.T])
    for ws in (False, True):
        assert tev.ate_rmse_timed(est, gt, with_scale=ws) == \
            jev.ate_rmse_timed(est, gt, with_scale=ws)
    assert np.isnan(tev.ate_rmse_timed(est[:2], gt))


def test_rpe_matches_jax():
    ts, xyz = _circle()
    rng = np.random.default_rng(4)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (len(ts), 1))
    gt = np.column_stack([ts, xyz, q])
    t0, r0 = tev.rpe(gt, gt)
    assert t0 < 1e-12 and r0 < 1e-6
    drift = xyz + np.linspace(0, 0.5, len(ts))[:, None]
    qn = rng.normal(size=(len(ts), 4))
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    est = np.column_stack([ts, drift, qn])
    gt2 = np.column_stack([ts, xyz, np.roll(qn, 1, axis=0)])
    for d in (1, 3):
        np.testing.assert_allclose(tev.rpe(est, gt2, delta=d),
                                   jev.rpe(est, gt2, delta=d), rtol=1e-6,
                                   atol=1e-6)
    assert tev.rpe(np.column_stack([ts, drift, q]), gt)[0] > 1e-3


def test_benchmark_statistics_match_jax():
    cases = [([0.02, 0.03, 9.99, 0.025], [0.0, 0.01, 0.5, 0.0]),
             ([0.02] * 4, [0.5, 0.5, 0.5, 0.0]),
             ([], [])]
    for rmses, lost in cases:
        # as JSON text: a failed sequence's nan fields compare equal
        assert json.dumps(tev.benchmark_statistics(rmses, lost)) == \
            json.dumps(jev.benchmark_statistics(rmses, lost))


# -- the depth-noise model ----------------------------------------------------

def test_depth_model_matches_jax():
    z = np.random.default_rng(5).uniform(0.0, 8.0, 257).astype(np.float32)
    z[:4] = [0.0, 0.4, 0.5, 2.0]
    zt, zj = torch.from_numpy(z), jnp.asarray(z)
    np.testing.assert_array_equal(tdm.sigma_z(zt).numpy(),
                                  np.asarray(jdm.sigma_z(zj)))
    np.testing.assert_allclose(tdm.sigma_z_min_over_sigma_z(zt).numpy(),
                               np.asarray(jdm.sigma_z_min_over_sigma_z(zj)),
                               rtol=1e-6)
    for f in (1.0, 6.0, 9.0):
        np.testing.assert_allclose(tdm.depth_inv_sigma2(zt, f).numpy(),
                                   np.asarray(jdm.depth_inv_sigma2(zj, f)),
                                   rtol=1e-6)
    w1 = float(tdm.depth_inv_sigma2(torch.tensor(2.0), 1.0))
    w6 = float(tdm.depth_inv_sigma2(torch.tensor(2.0), 6.0))
    assert abs(w1 / w6 - 36.0) < 1e-3
    w = tdm.sigma_z_min_over_sigma_z(torch.tensor([0.5, 1.0, 3.0, 6.0]))
    assert bool(((w > 0) & (w <= 1)).all()) and bool((w[1:] <= w[:-1]).all())


# -- map checkpoints ------------------------------------------------------------

def _filled_store(cls, seed=0):
    """A two-map store with keyframes, points, observations and lines (the
    same calls on either package's MapStore)."""
    rng = np.random.default_rng(seed)
    st = cls(max_kf=8, max_pts=64, max_obs=256, n_kp=16, max_lines=16,
             max_lobs=64, n_kl=8)
    for m in range(2):
        if m:
            st.create_map()
        for _ in range(2):
            kf = st.alloc_kf()
            st.kf_mask[kf] = True
            st.kf_R[kf] = np.asarray(jlie.so3_exp(jnp.asarray(
                rng.normal(size=3).astype(np.float32))))
            st.kf_t[kf] = rng.normal(size=3)
            st.kf_timestamp[kf] = rng.uniform(0, 10)
            st.kf_frame_id[kf] = kf * 3
            st.kf_map[kf] = st.active_map
            st.kf_kp_xy[kf] = rng.uniform(0, 320, (16, 2))
            st.kf_kp_desc[kf] = rng.integers(0, 2 ** 32, (16, 8),
                                             dtype=np.uint64)
            st.kf_kp_mask[kf] = rng.random(16) < 0.8
            pts = st.alloc_pts(5)
            st.pt_xyz[pts] = rng.normal(size=(5, 3))
            st.pt_desc[pts] = rng.integers(0, 2 ** 32, (5, 8),
                                           dtype=np.uint64)
            st.pt_mask[pts] = True
            st.add_observations(kf, pts, np.arange(5))
            ln = st.alloc_lines(2)
            st.ln_Xs[ln] = rng.normal(size=(2, 3))
            st.ln_Xe[ln] = rng.normal(size=(2, 3))
            st.ln_mask[ln] = True
            st.add_line_observations(kf, ln, np.arange(2))
    st.kf_fixed[1] = True
    return st


def _assert_stores_equal(a, b):
    for f in tser._STORE_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    for c in tser._COUNTERS + ["active_map", "n_maps", "max_kf", "max_pts",
                               "max_obs", "n_kp", "max_lines", "max_lobs",
                               "n_kl"]:
        assert int(getattr(a, c)) == int(getattr(b, c)), c


def _jax_voc(seed):
    desc = np.random.default_rng(0).integers(0, 2 ** 32, (2000, 8),
                                             dtype=np.uint32)
    return jbow.train(desc, k=4, depth=2, seed=seed)


def test_atlas_saved_by_jax_loads_in_the_port(tmp_path):
    jst = _filled_store(JStore)
    jvoc = _jax_voc(0)
    p = str(tmp_path / "atlas.npz")
    jser.save_atlas(p, jst, voc=jvoc)
    tst, tvoc = tser.load_atlas(p)
    _assert_stores_equal(tst, convert.map_store_from_numpy(vars(jst)))
    ref = convert.vocabulary_from_numpy(jvoc._asdict())
    assert isinstance(tvoc, tbow.Vocabulary)
    for f in ref._fields:
        np.testing.assert_array_equal(np.asarray(getattr(tvoc, f)),
                                      np.asarray(getattr(ref, f)))
    assert tser._vocab_checksum(tvoc) == jser._vocab_checksum(jvoc)
    # the JAX test's checks on the port's store
    assert tst.num_keyframes == 4 and tst.num_points == 20
    okf, _, _ = tst.live_obs()
    assert len(okf) == 20
    np.testing.assert_array_equal(tst.kf_map[:4], [0, 0, 1, 1])


def test_atlas_saved_by_the_port_loads_in_jax(tmp_path):
    tst = _filled_store(TStore, seed=1)
    tvoc = convert.vocabulary_from_numpy(_jax_voc(1)._asdict())
    p = str(tmp_path / "atlas.npz")
    tser.save_atlas(p, tst, voc=tvoc, extra={"note": 3})
    jst, jvoc = jser.load_atlas(p, expected_vocab=_jax_voc(1))
    _assert_stores_equal(jst, tst)
    np.testing.assert_array_equal(np.asarray(jvoc.nodes), tvoc.nodes)
    assert int(np.load(p)["x_note"]) == 3
    # and back into the port
    tst2, _ = tser.load_atlas(p, expected_vocab=tvoc)
    _assert_stores_equal(tst2, tst)


def test_vocabulary_checksum_guard_in_both_packages(tmp_path):
    j1, j2 = _jax_voc(0), _jax_voc(1)
    t1, t2 = (tbow.train(np.random.default_rng(0).integers(
        0, 2 ** 32, (2000, 8), dtype=np.uint32), k=4, depth=2, seed=s)
        for s in (0, 1))
    # the port's training gives the JAX package's tables, so the same digest
    assert tser._vocab_checksum(t1) == jser._vocab_checksum(j1)
    assert tser._vocab_checksum(t2) == jser._vocab_checksum(j2)
    assert tser._vocab_checksum(None) == jser._vocab_checksum(None) == ""
    for save, voc in ((jser.save_atlas, j1), (tser.save_atlas, t1)):
        p = str(tmp_path / f"{save.__module__}.npz")
        save(p, _filled_store(TStore), voc=voc)
        assert tser.load_atlas(p, expected_vocab=t1)[1] is not None
        assert jser.load_atlas(p, expected_vocab=j1)[1] is not None
        with pytest.raises(ValueError, match="checksum"):
            tser.load_atlas(p, expected_vocab=t2)
        with pytest.raises(ValueError, match="checksum"):
            jser.load_atlas(p, expected_vocab=j2)


def test_default_vocabulary_digest_matches_jax():
    from plvs_tpu.slam import keyframe_database as jkdb
    from plvs_tpu_torch.slam import keyframe_database as tkdb

    jvoc = jbow.load_vocabulary(jkdb._DEFAULT_VOCAB)
    tvoc = tbow.load_vocabulary(tkdb._DEFAULT_VOCAB)
    assert tser._vocab_checksum(tvoc) == jser._vocab_checksum(jvoc)


def _volumes():
    cam = (150.0, 150.0, 80.0, 60.0)
    jv = JVolume(jcam.pinhole(*cam, width=160, height=120), voxel_size=0.05,
                 max_blocks=512)
    rng = np.random.default_rng(2)
    depth = (2.0 + 0.1 * rng.random((120, 160))).astype(np.float32)
    color = rng.uniform(0, 255, (120, 160, 3)).astype(np.float32)
    jv.integrate(depth, color, np.eye(3, dtype=np.float32),
                 np.zeros(3, np.float32))
    tcam_ = tcam.pinhole(*cam, width=160, height=120)
    tv = TVolume(tcam_, voxel_size=0.05, max_blocks=512, device="cpu")
    tv.integrate(depth, color, np.eye(3, dtype=np.float32),
                 np.zeros(3, np.float32))
    return jv, tv, tcam_


def _assert_volumes_equal(a, b):
    n = a.n_blocks
    assert b.n_blocks == n
    for f in ("block_coords", "tsdf", "weight", "color"):
        np.testing.assert_array_equal(getattr(b, f)[:n], getattr(a, f)[:n],
                                      err_msg=f)
    assert float(a.voxel_size) == float(b.voxel_size)
    assert float(a.trunc_factor) == float(b.trunc_factor)


def test_dense_volumes_roundtrip_across_packages(tmp_path):
    jv, tv, tcam_ = _volumes()
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jser.save_dense(pj, jv)
    tser.save_dense(pt, tv)
    t_from_j = tser.load_dense(pj, tcam_, device="cpu")
    _assert_volumes_equal(jv, t_from_j)
    assert t_from_j.device.type == "cpu"
    j_from_t = jser.load_dense(pt, jv.cam)
    _assert_volumes_equal(tv, j_from_t)
    t_from_t = tser.load_dense(pt, tcam_, device="cpu")
    _assert_volumes_equal(tv, t_from_t)
    assert len(t_from_t.occupied_cloud()[0]) == len(tv.occupied_cloud()[0])
    assert len(t_from_j.occupied_cloud()[0]) == len(jv.occupied_cloud()[0])


# -- dataset loaders ----------------------------------------------------------

def _png(path, arr):
    from PIL import Image

    Image.fromarray(arr).save(path)


def _images(rng, h=24, w=32):
    """An 8-bit gray, an RGB and an RGBA image."""
    return (rng.integers(0, 256, (h, w), dtype=np.uint8),
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
            rng.integers(0, 256, (h, w, 4), dtype=np.uint8))


def _assert_frames_equal(fj, ft):
    assert len(fj) == len(ft) > 0
    for a, b in zip(fj, ft):
        assert len(a) == len(b)
        assert a[0] == b[0]
        for x, y in zip(a[1:], b[1:]):
            assert x.dtype == y.dtype == np.float32
            np.testing.assert_array_equal(y, x)


def test_tum_loader_matches_jax(tmp_path):
    from plvs_tpu.io import datasets as jds

    assert native.available(), native.build_error()
    rng = np.random.default_rng(0)
    root = tmp_path / "seq"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb_lines, d_lines = [], []
    for i in range(4):
        t = 100.0 + i * 0.033
        _png(root / "rgb" / f"{t:.6f}.png", _images(rng)[i % 3])
        dep = rng.integers(0, 40000, (24, 32), dtype=np.uint16)
        dep[0, 0] = 5000 * 2
        _png(root / "depth" / f"{t:.6f}.png", dep)
        rgb_lines.append(f"{t:.6f} rgb/{t:.6f}.png")
        d_lines.append(f"{t + 0.003:.6f} depth/{t:.6f}.png")
    (root / "rgb.txt").write_text("# header\n" + "\n".join(rgb_lines))
    (root / "depth.txt").write_text("# header\n" + "\n".join(d_lines))
    (root / "groundtruth.txt").write_text(
        "# t tx ty tz qx qy qz qw\n100.0 1 2 3 0 0 0 1\n")
    ft = list(tds.TumRGBD(str(root)).frames())
    _assert_frames_equal(list(jds.TumRGBD(str(root)).frames()), ft)
    ts, gray, depth = ft[0]
    assert gray.shape == (24, 32) and depth[0, 0] == 2.0
    np.testing.assert_array_equal(tds.TumRGBD(str(root)).groundtruth(),
                                  jds.TumRGBD(str(root)).groundtruth())
    assert tds.associate(np.array([0.0, 0.1, 0.2]),
                         np.array([0.001, 0.102, 0.5])) == [(0, 0), (1, 1)]


def test_euroc_loader_matches_jax(tmp_path):
    from plvs_tpu.io import datasets as jds

    assert native.available(), native.build_error()
    rng = np.random.default_rng(1)
    mav = tmp_path / "MH" / "mav0"
    for cam, dt in (("cam0", 0), ("cam1", 1000)):
        (mav / cam / "data").mkdir(parents=True)
        rows = ["#timestamp [ns],filename"]
        for i in range(3):
            ns = 1403636579763555584 + i * 50_000_000 + dt
            _png(mav / cam / "data" / f"{ns}.png", _images(rng)[(i + dt) % 3])
            rows.append(f"{ns},{ns}.png")
        (mav / cam / "data.csv").write_text("\n".join(rows) + "\n")
    (mav / "imu0").mkdir()
    imu = ["#timestamp,wx,wy,wz,ax,ay,az"] + [
        f"{1403636579758555392 + k * 5_000_000}," + ",".join(
            f"{v:.9f}" for v in rng.normal(size=6)) for k in range(30)]
    (mav / "imu0" / "data.csv").write_text("\n".join(imu) + "\n")
    root = str(tmp_path / "MH")
    _assert_frames_equal(list(jds.EurocStereo(root).frames()),
                         list(tds.EurocStereo(root).frames()))
    np.testing.assert_array_equal(tds.EurocStereo(root).imu(),
                                  jds.EurocStereo(root).imu())


def test_kitti_loader_matches_jax(tmp_path):
    from plvs_tpu.io import datasets as jds

    assert native.available(), native.build_error()
    rng = np.random.default_rng(2)
    for d in ("image_0", "image_1"):
        (tmp_path / d).mkdir()
        for i in range(3):
            _png(tmp_path / d / f"{i:06d}.png",
                 _images(rng, 30, 40)[(i + len(d)) % 3])
    (tmp_path / "times.txt").write_text("0.0\n0.103\n0.207\n")
    _assert_frames_equal(list(jds.KittiStereo(str(tmp_path)).frames()),
                         list(tds.KittiStereo(str(tmp_path)).frames()))


# -- profiling and the benchmark harness ----------------------------------------

def test_stopwatch_report():
    import time as _t

    sw = Stopwatch()
    for _ in range(3):
        with sw.scope("stage_a"):
            _t.sleep(0.002)
    st = sw.stats()
    assert st["stage_a"]["count"] == 3 and st["stage_a"]["mean_ms"] >= 1.5
    assert "stage_a" in sw.report()

    # reset() like the JAX package's: samples and open ticks both go
    from plvs_tpu.utils.profiling import Stopwatch as JStopwatch

    for w in (sw, JStopwatch()):
        w.tick("open_stage")
        w.reset()
        assert w.stats() == {} and not w.samples
        w.tock("open_stage")     # its tick went with the reset
        assert w.stats() == {}
        with w.scope("stage_b"):
            pass
        assert list(w.stats()) == ["stage_b"]
        assert w.stats()["stage_b"]["count"] == 1


def test_benchmark_gate_and_aggregation_match_jax():
    from plvs_tpu.io import benchmark as jbm

    def seq(mod):
        return [mod.RunResult(0.02, 0.0, [10.0, 12.0]),
                mod.RunResult(0.03, 0.01, [11.0]),
                mod.RunResult(9.99, 0.50, [40.0]),  # gated out
                mod.RunResult(0.025, 0.0, [9.0])]

    reps = []
    for mod in (jbm, tbm):
        it = iter(seq(mod))
        reps.append(mod.run_sequence_benchmark(lambda i: next(it), n_runs=4))
    assert reps[1] == reps[0]
    assert not reps[1]["failed"] and reps[1]["discarded"] == 1
    assert abs(reps[1]["median_rmse"] - 0.025) < 1e-9
    assert reps[1]["track_ms_mean"] < 13.0
    lost = [tbm.RunResult(0.02, 0.5, [10.0])] * 3 + \
        [tbm.RunResult(0.02, 0.0, [10.0])]
    it = iter(lost)
    assert tbm.run_sequence_benchmark(lambda i: next(it), n_runs=4)["failed"]


def test_resource_sampler():
    import time as _t

    with tbm.ResourceSampler(interval=0.05) as rs:
        x = 0
        t0 = _t.perf_counter()
        while _t.perf_counter() - t0 < 0.3:
            x += sum(range(1000))
    assert rs.stats()["ram_mb_mean"] > 10.0


CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)


@pytest.fixture(scope="module")
def jax_synthetic_run():
    """The JAX package's benchmark run over the synthetic sequence."""
    from plvs_tpu.io import benchmark as jbm
    from plvs_tpu.io import synthetic as jsyn
    from plvs_tpu.slam import System, SystemConfig

    cam = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    frames = list(jsyn.SyntheticRGBD(cam, wall_z=3.0, seed=0).sequence(
        n_frames=10))
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    return jbm.run_system_once(
        lambda: System(cam, SystemConfig(num_features=512, n_levels=4,
                                         loop_closing=False)),
        lambda: [(ts, g, d) for ts, g, d, _, _ in frames],
        gt_xyz=gt, sample_resources=False)


def test_synthetic_run_once_matches_jax(jax_synthetic_run):
    from plvs_tpu_torch.io import synthetic as tsyn
    from plvs_tpu_torch.slam import System, SystemConfig

    cam = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    frames = list(tsyn.SyntheticRGBD(cam, wall_z=3.0, seed=0).sequence(
        n_frames=10))
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    r = tbm.run_system_once(
        lambda: System(cam, SystemConfig(num_features=512, n_levels=4,
                                         loop_closing=False), device="cpu"),
        lambda: [(ts, g, d) for ts, g, d, _, _ in frames],
        gt_xyz=gt, sample_resources=False)
    assert len(r.track_ms) == 10
    assert r.lost_frac == jax_synthetic_run.lost_frac < 0.05
    assert r.ate_rmse < 0.05
    assert abs(r.ate_rmse - jax_synthetic_run.ate_rmse) < 0.01


# -- the command-line runner ----------------------------------------------------

def _cli(mod, tmp_path, tag, *extra):
    out = str(tmp_path / f"traj_{tag}.txt")
    mp = str(tmp_path / f"map_{tag}.npz")
    mod.main(["--synthetic", "--frames", "8", "--out", out, "--save-map", mp,
              *extra])
    return out, mp


def test_cli_synthetic_run_matches_jax(tmp_path, capsys):
    from plvs_tpu import run_slam as jrun
    from plvs_tpu_torch import run_slam as trun

    out_j, map_j = _cli(jrun, tmp_path, "j", "--cpu")
    res_j = json.loads(capsys.readouterr().out.splitlines()[0])
    out_t, map_t = _cli(trun, tmp_path, "t", "--device", "cpu")
    cap = capsys.readouterr().out
    assert "ate_rmse" in cap
    res_t = json.loads(cap.splitlines()[0])
    assert os.path.exists(out_t) and os.path.exists(map_t)
    st, voc = tser.load_atlas(map_t)
    assert st.num_keyframes >= 1 and voc is not None
    # the port's atlas loads in the JAX package, its vocabulary's digest
    # checked against the JAX package's default vocabulary
    from plvs_tpu.slam import keyframe_database as jkdb

    jst, _ = jser.load_atlas(
        map_t, expected_vocab=jbow.load_vocabulary(jkdb._DEFAULT_VOCAB))
    assert jst.num_keyframes == st.num_keyframes
    for k in ("frames", "keyframes", "maps"):
        assert res_t[k] == res_j[k], k
    assert abs(res_t["ate_rmse"] - res_j["ate_rmse"]) < 0.01
    tj, tt = jtraj.read_tum(out_j), ttraj.read_tum(out_t)
    assert tt.shape == tj.shape
    np.testing.assert_array_equal(tt[:, 0], tj[:, 0])
    np.testing.assert_allclose(tt[:, 1:4], tj[:, 1:4], atol=0.01)


def test_cli_refuses_the_viewers_and_defaults_to_cuda(tmp_path, capsys,
                                                      monkeypatch):
    """The viewers are in: ``--viz`` renders the final map to a PNG (as the
    JAX runner, nothing without matplotlib), and ``--live-viewer 0``
    serves the map while the run goes on (a probe reads /state.json
    through the socket at each frame's pause gate). Without CUDA the
    default device raises."""
    import urllib.request

    from plvs_tpu_torch import run_slam as trun
    from plvs_tpu_torch.viz import live_server

    png = tmp_path / "m.png"
    trun.main(["--synthetic", "--frames", "3", "--viz", str(png),
               "--device", "cpu", "--out", str(tmp_path / "a.txt")])
    out = capsys.readouterr().out
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        assert not png.exists() and "map rendered" not in out
    else:
        assert f"map rendered to {png}" in out
        assert png.stat().st_size > 1000

    seen = []

    class Probe(live_server.LiveViewer):
        def wait_if_paused(self, timeout=None):
            super().wait_if_paused(timeout)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{self.port}/state.json",
                    timeout=30) as r:
                seen.append(json.loads(r.read()))

    monkeypatch.setattr(live_server, "LiveViewer", Probe)
    trun.main(["--synthetic", "--frames", "3", "--live-viewer", "0",
               "--device", "cpu", "--out", str(tmp_path / "b.txt")])
    out = capsys.readouterr().out
    assert "live viewer: http://127.0.0.1:" in out
    assert [len(s["trajectory"]) for s in seen] == [0, 1, 2]
    assert seen[-1]["stats"]["keyframes"] >= 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            trun.main(["--synthetic", "--frames", "1"])
        with pytest.raises(RuntimeError, match="cuda"):
            tbm.main(["--synthetic", "--runs", "1", "--frames", "1"])
