"""The port's monocular path against the JAX package's: the two-view
reconstruction and the PnP RANSAC from JAX's own samples, the map rescale,
the local mapper's triangulation of new points on one converted store, and
a monocular System run through both packages.

The RANSACs draw with ``jax.random`` in JAX and from a ``torch.Generator``
in the port, streams no port can replay; each test recomputes JAX's
samples with ``jax.random`` from the key the JAX function received and
hands them to the port's ``*_from_samples``. Inlier masks must then agree
exactly; R and t carry the tolerances stated at each check (the SVDs of
two LAPACK builds agree to float32 rounding, up to sign).

The System run: tests/test_slam_e2e.py TestMonocular's configuration
(320x240, 512 features, 4 levels, a keyframe at least every 5 frames,
local BA on, loop closing off) over the first 20 frames of its scene and
trajectory. The JAX run records every two-view key; the port's run is
handed the samples JAX drew from them (``two_view.draw_samples`` patched,
a test-side hook). The init frame, the keyframe count and the states agree
exactly; poses and map sizes within the tolerances stated there.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.io import evaluation
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu.slam import local_mapping as jlm
from plvs_tpu.slam.map_store import MapStore as JStore
from plvs_tpu.solvers import pnp as jpnp
from plvs_tpu.solvers import two_view as jtv
from plvs_tpu_torch import convert
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam import local_mapping as tlm
from plvs_tpu_torch.slam.tracking import NOT_INITIALIZED, OK
from plvs_tpu_torch.solvers import pnp as tpnp
from plvs_tpu_torch.solvers import two_view as ttv

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
MONO_FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384,
                  loop_closing=False, sensor="mono", max_kf_interval=5,
                  min_kf_inliers=25, pipelined=False)
N_MONO = 20


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snapshot(store) -> dict:
    """A deep copy of a store's attributes (its lock left out)."""
    return copy.deepcopy({k: v for k, v in vars(store).items()
                          if k != "lock"})


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _rot_y(a):
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                     [-np.sin(a), 0, np.cos(a)]], np.float32)


# ---------------------------------------------------------------------------
# two-view reconstruction and PnP from JAX's samples
# ---------------------------------------------------------------------------

def _two_view_samples(key, valid, n_hyp=256):
    """What jtv.reconstruct draws from ``key`` (two_view.py:233-240)."""
    n = valid.shape[0]
    probs = jnp.asarray(valid).astype(jnp.float32) + 1e-6
    probs = probs / probs.sum()
    kF, kH, _ = jax.random.split(key, 3)
    sF = jax.random.choice(kF, n, shape=(n_hyp, 8), p=probs)
    sH = jax.random.choice(kH, n, shape=(n_hyp, 4), p=probs)
    return np.asarray(sF), np.asarray(sH)


def _two_view_scene(planar, rng, n=300):
    """Normalized correspondences of two views 0.3 m apart with 1 px
    (f = 500) noise: a plane at 3 m or points 3-6 m deep; 10% invalid."""
    z = np.full(n, 3.0) if planar else rng.uniform(3.0, 6.0, n)
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n), z], -1)
    R21 = _rot_y(0.05)
    X2 = X @ R21.T + np.array([-0.3, 0.02, 0.05])
    p1 = (X[:, :2] / X[:, 2:] + rng.normal(0, 2e-3, (n, 2))).astype(
        np.float32)
    p2 = (X2[:, :2] / X2[:, 2:] + rng.normal(0, 2e-3, (n, 2))).astype(
        np.float32)
    return p1, p2, rng.random(n) >= 0.1


@pytest.mark.parametrize("planar", [False, True])
def test_two_view_from_jax_samples(planar):
    """Same inliers and model choice exactly (F on the general scene, H on
    the plane); R21 within 1e-5 and the unit t21 within 2e-5 (measured
    1.1e-6 and 4e-6: the refit and decomposition SVDs in float32); the
    triangulated inliers within 5e-3 relative to their depth (low-parallax
    points amplify the pose's float32 differences: 2.4e-3 m at 6 m
    measured)."""
    rng = np.random.default_rng(3 + planar)
    p1, p2, valid = _two_view_scene(planar, rng)
    key = jax.random.PRNGKey(5)
    jr = jtv.reconstruct(jnp.asarray(p1), jnp.asarray(p2),
                         jnp.asarray(valid), key, sigma=1 / 500, min_good=80)
    sF, sH = _two_view_samples(key, valid)
    tr = ttv.reconstruct_from_samples(_t(p1), _t(p2), _t(valid), _t(sF),
                                      _t(sH), sigma=1 / 500, min_good=80)
    assert bool(jr.success) and bool(tr.success)
    assert bool(tr.used_homography) == bool(jr.used_homography) == planar
    inl = np.asarray(jr.inliers)
    np.testing.assert_array_equal(tr.inliers.numpy(), inl)
    assert int(tr.n_good) == int(jr.n_good) > 150
    np.testing.assert_allclose(tr.R21.numpy(), np.asarray(jr.R21), atol=1e-5)
    np.testing.assert_allclose(tr.t21.numpy(), np.asarray(jr.t21), atol=2e-5)
    jX = np.asarray(jr.points3d)[inl]
    dX = np.linalg.norm(tr.points3d.numpy()[inl] - jX, axis=1)
    assert (dX < 5e-3 * jX[:, 2]).all(), dX.max()


def test_two_view_degenerate_motion_fails_in_both():
    """No translation: no pose wins clearly, in both packages."""
    rng = np.random.default_rng(9)
    X = np.stack([rng.uniform(-1, 1, 200), rng.uniform(-1, 1, 200),
                  rng.uniform(3, 6, 200)], -1)
    X2 = X @ _rot_y(0.02).T
    p1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    p2 = (X2[:, :2] / X2[:, 2:]).astype(np.float32)
    valid = np.ones(200, bool)
    key = jax.random.PRNGKey(1)
    jr = jtv.reconstruct(jnp.asarray(p1), jnp.asarray(p2),
                         jnp.asarray(valid), key, sigma=1 / 500, min_good=80)
    sF, sH = _two_view_samples(key, valid)
    tr = ttv.reconstruct_from_samples(_t(p1), _t(p2), _t(valid), _t(sF),
                                      _t(sH), sigma=1 / 500, min_good=80)
    assert not bool(jr.success) and not bool(tr.success)
    g = torch.Generator().manual_seed(0)
    assert not bool(ttv.reconstruct(_t(p1), _t(p2), _t(valid), g,
                                    sigma=1 / 500, min_good=80).success)


def _pnp_samples(key, valid, n_hyp=256):
    """What jpnp.pnp_ransac draws from ``key`` (pnp.py:84-88)."""
    n = valid.shape[0]
    probs = jnp.asarray(valid).astype(jnp.float32) + 1e-9
    probs = probs / probs.sum()
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, n, (6,), replace=False, p=probs))(jax.random.split(key, n_hyp)))


def test_pnp_from_jax_samples():
    """60% inliers at 1 px (f = 500), 40% outliers: the same inlier mask
    exactly, R and t within 1e-5 (measured 4e-7: the polish's 8
    Gauss-Newton steps in float32); the port's own draw finds the pose
    too."""
    rng = np.random.default_rng(3)
    n = 200
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                  rng.uniform(2, 6, n)], -1).astype(np.float32)
    R, t = _rot_y(0.1), np.array([0.2, -0.1, 0.3], np.float32)
    Xc = X @ R.T + t
    uv = (Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 2e-3, (n, 2))).astype(
        np.float32)
    out = rng.random(n) < 0.4
    uv[out] += rng.uniform(-0.2, 0.2, (out.sum(), 2)).astype(np.float32)
    valid = rng.random(n) >= 0.05
    key = jax.random.PRNGKey(11)
    jr = jpnp.pnp_ransac(jnp.asarray(X), jnp.asarray(uv), jnp.asarray(valid),
                         key, inlier_thresh=4 / 500)
    tr = tpnp.pnp_ransac_from_samples(_t(X), _t(uv), _t(valid),
                                      _t(_pnp_samples(key, valid)),
                                      inlier_thresh=4 / 500)
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    assert int(tr.n_inliers) == int(jr.n_inliers) >= 12
    np.testing.assert_allclose(tr.R.numpy(), np.asarray(jr.R), atol=1e-5)
    np.testing.assert_allclose(tr.t.numpy(), np.asarray(jr.t), atol=1e-5)
    own = tpnp.pnp_ransac(_t(X), _t(uv), _t(valid),
                          torch.Generator().manual_seed(7),
                          inlier_thresh=4 / 500)
    truth = ~out & valid
    assert int(own.n_inliers) >= 0.9 * truth.sum()
    np.testing.assert_allclose(own.R.numpy(), R, atol=1e-2)


# ---------------------------------------------------------------------------
# the map rescale
# ---------------------------------------------------------------------------

def test_rescale_map_exact():
    """One map of two rescaled by 1.7 in both packages from one converted
    store: keyframe translations, points, their scale ranges and line
    endpoints of that map change, the other map's stay — bit for bit."""
    rng = np.random.default_rng(2)
    js = JStore(max_kf=16, max_pts=64, n_kp=8, max_lines=16)
    for k in range(6):
        assert js.alloc_kf() == k
        if k == 3:
            js.create_map()
        js.kf_mask[k] = True
        js.kf_map[k] = js.active_map
        js.kf_R[k] = _rot_y(0.1 * k)
        js.kf_t[k] = rng.normal(0, 1, 3).astype(np.float32)
    ids = js.alloc_pts(40)
    js.pt_xyz[ids] = rng.normal(0, 2, (40, 3)).astype(np.float32)
    js.pt_mask[ids] = True
    js.pt_ref_kf[ids] = rng.integers(0, 6, 40)
    js.pt_min_dist[ids] = rng.uniform(0.5, 1, 40).astype(np.float32)
    js.pt_max_dist[ids] = rng.uniform(2, 5, 40).astype(np.float32)
    lids = js.alloc_lines(10)
    js.ln_Xs[lids] = rng.normal(0, 2, (10, 3)).astype(np.float32)
    js.ln_Xe[lids] = rng.normal(0, 2, (10, 3)).astype(np.float32)
    js.ln_mask[lids] = True
    js.ln_ref_kf[lids] = rng.integers(0, 6, 10)
    ts = convert.map_store_from_numpy(vars(js))
    before = _snapshot(js)
    js.rescale_map(1.7, map_id=0)
    ts.rescale_map(1.7, map_id=0)
    for name in ("kf_t", "kf_R", "pt_xyz", "pt_min_dist", "pt_max_dist",
                 "ln_Xs", "ln_Xe"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=name)
    assert ts.version == js.version
    other = js.kf_map[:6] == 1
    np.testing.assert_array_equal(ts.kf_t[:6][other],
                                  before["kf_t"][:6][other])
    assert not np.array_equal(ts.kf_t[:6][~other], before["kf_t"][:6][~other])


# ---------------------------------------------------------------------------
# the monocular System, and create_new_points on a converted store
# ---------------------------------------------------------------------------

def _mono_frames(n=N_MONO):
    """TestMonocular's scene and translation-dominant trajectory."""
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                               seed=9)
    poses = []
    for i in range(40):
        s = i / 39
        C = np.array([1.6 * s, 0.1 * np.sin(2 * np.pi * s), 0.3 * s],
                     np.float32)
        poses.append((np.eye(3, dtype=np.float32), -C))
    return list(scene.sequence(poses=poses[:n]))


@pytest.fixture(scope="module")
def jax_mono():
    """The JAX run, recording each two-view call's samples and the store
    before and after each create_new_points call."""
    frames = _mono_frames()
    samples, cnp = [], []
    orig_rec = jtv.reconstruct
    orig_cnp = jlm.LocalMapper.create_new_points

    def rec(p1, p2, valid, key, **kw):
        samples.append(_two_view_samples(key, np.asarray(valid)))
        return orig_rec(p1, p2, valid, key, **kw)

    def cnp_rec(self, kf_id, *a, **kw):
        pre = _snapshot(self.store)
        orig_cnp(self, kf_id, *a, **kw)
        cnp.append((kf_id, pre, _snapshot(self.store)))

    jtv.reconstruct = rec
    jlm.LocalMapper.create_new_points = cnp_rec
    try:
        system = JSystem(jcam.pinhole(*CAM_ARGS, **CAM_KW),
                         JConfig(**MONO_FLAGS))
        states = [int(system.track_monocular(g, ts)[0])
                  for ts, g, _, _, _ in frames]
    finally:
        jtv.reconstruct = orig_rec
        jlm.LocalMapper.create_new_points = orig_cnp
    return dict(frames=frames, samples=samples, cnp=cnp, states=states,
                traj=system.trajectory_tum(), map=system.map_statistics(),
                made=system.store._next_kf_uid)


@pytest.fixture(scope="module")
def port_mono(jax_mono):
    """The port's run, handed JAX's two-view samples in call order."""
    queue = list(jax_mono["samples"])
    orig = ttv.draw_samples

    def replay(valid, generator, n_hyp=256):
        sF, sH = queue.pop(0)
        assert sF.shape == (n_hyp, 8) and sF.max() < valid.shape[0]
        return torch.from_numpy(sF).long(), torch.from_numpy(sH).long()

    ttv.draw_samples = replay
    try:
        system = TSystem(tcam.pinhole(*CAM_ARGS, **CAM_KW),
                         TConfig(**MONO_FLAGS), device="cpu")
        states = [int(system.track_monocular(g, ts)[0])
                  for ts, g, _, _, _ in jax_mono["frames"]]
    finally:
        ttv.draw_samples = orig
    return dict(states=states, traj=system.trajectory_tum(),
                map=system.map_statistics(), made=system.store._next_kf_uid,
                added=list(system.local_mapper.new_points_log),
                left=len(queue), system=system)


def test_mono_system_states_and_init_match_jax(jax_mono, port_mono):
    """NOT_INITIALIZED on frame 0, the two-view map at frame 1 in both, the
    same state every frame, the same number of two-view calls and
    keyframes made."""
    js, ts_ = jax_mono["states"], port_mono["states"]
    assert js[0] == NOT_INITIALIZED and js[1] == OK
    assert ts_ == js
    assert port_mono["left"] == 0 and len(jax_mono["samples"]) >= 1
    assert port_mono["made"] == jax_mono["made"] >= 4
    assert sum(port_mono["added"]) > 0


def test_mono_system_poses_and_map_match_jax(jax_mono, port_mono):
    """Poses within 5 mm / 0.2 deg of JAX's at every frame (measured 1.1 mm
    / 0.05 deg in a map at median depth 1: each package's float32 local BA
    and the triangulations it feeds drift apart slowly), live points within
    10% (445 and 446 measured), and both Sim3-aligned ATEs under
    TestMonocular's 5 cm and within 20% + 2 mm of each other (2.65 and
    2.63 cm measured)."""
    jt, tt = jax_mono["traj"], port_mono["traj"]
    dpos = np.linalg.norm(tt[:, 1:4] - jt[:, 1:4], axis=1)
    dot = np.abs((tt[:, 4:8] * jt[:, 4:8]).sum(1)).clip(0.0, 1.0)
    dang = np.degrees(2.0 * np.arccos(dot))
    assert dpos.max() < 5e-3 and dang.max() < 0.2, (dpos, dang)
    jp, tp = jax_mono["map"]["points"], port_mono["map"]["points"]
    assert abs(tp - jp) <= 0.1 * jp, (jp, tp)
    gt = np.stack([-R.T @ t for _, _, _, R, t in jax_mono["frames"]])
    ok = [i for i, s in enumerate(jax_mono["states"]) if s == OK]
    ate = [evaluation.ate_rmse(tr[ok, 1:4], gt[ok], align=True,
                               with_scale=True) for tr in (jt, tt)]
    assert max(ate) < 0.05, ate
    assert abs(ate[1] - ate[0]) <= 0.2 * max(ate) + 2e-3, ate


def test_create_new_points_on_a_converted_store(jax_mono):
    """The JAX store as it stood before its create_new_points call that
    added the most points, converted:
    the port's call adds the same points in the same slots with the same
    observations (ids, keyframes, keypoints exact) and positions within
    3e-4 relative to their depth (two-ray midpoints in float32, the
    low-parallax ones sensitive: 7e-5 measured on 156 points)."""
    kf_id, pre, post = max(
        jax_mono["cnp"],
        key=lambda c: int(c[2]["pt_mask"].sum() - c[1]["pt_mask"].sum()))
    st = convert.map_store_from_numpy(pre)
    mapper = tlm.LocalMapper(tcam.pinhole(*CAM_ARGS, **CAM_KW), st,
                             scale=1.2, n_levels=4, device="cpu")
    n_added = mapper.create_new_points(kf_id)
    new = np.nonzero(post["pt_mask"] & ~pre["pt_mask"])[0]
    assert n_added == len(new) > 10
    np.testing.assert_array_equal(st.pt_mask, post["pt_mask"])
    for name in ("pt_ref_kf", "pt_first_kf", "pt_desc", "kf_kp_pt",
                 "pt_visible", "pt_found"):
        np.testing.assert_array_equal(getattr(st, name), post[name],
                                      err_msg=name)
    top = post["_obs_top"]
    assert st._obs_top == top
    for name in ("obs_kf", "obs_pt", "obs_kp", "obs_mask"):
        np.testing.assert_array_equal(getattr(st, name)[:top],
                                      post[name][:top], err_msg=name)
    X = post["pt_xyz"][new]
    d = np.linalg.norm(st.pt_xyz[new] - X, axis=1)
    assert (d <= 3e-4 * np.abs(X[:, 2])).all(), d.max()
