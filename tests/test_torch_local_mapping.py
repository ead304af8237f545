"""The port's keyframe backend against the JAX package's.

* ``_distinctive_rows`` and the point maintenance on a carried map: indices
  and descriptors exact, normals and distance ranges within 1e-5 (float32
  sums in another order).
* ``LocalMapper.process_keyframe`` replayed on every backend pass of a
  short JAX run, each from the map the JAX backend saw (carried across with
  ``convert.map_store_from_numpy``): the removed points, lines and
  keyframes, the fused observations and the voted descriptors exact. The
  geometry is checked twice. With the JAX solver put in the port's place
  (the port's problem padded to the JAX mapper's buckets) every pose,
  landmark, normal and range is equal exactly: the port builds the same BA
  problem, row for row, and writes the result back the same way. With the
  port's own solver: poses within 1e-2, points within 0.1 m. A real window
  is far worse conditioned than tests/test_torch_ba.py's problems: 5 LM x
  14 CG leaves directions unconverged (a line endpoint sliding along its
  line, held by a few pixels of disparity), and the JAX package itself,
  given the same problem without its padding, moves by 3.9e-2 m on points
  and 3.8 m on line endpoints in this run's third pass
  (scripts/ba_conditioning.py). So line endpoints
  are compared only in the first check. Then one ``global_ba`` on the
  final map, checked both ways.
* Keyframe tombstones: a culled keyframe's frames resolve through the same
  chain of anchors in both packages.
* The whole System with ``local_ba=True`` and dense mapping, set up as
  tests/test_torch_system.py sets its run, within that file's bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.io import evaluation
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu.slam import local_mapping as jlocal_mapping
from plvs_tpu.slam import map_store as jmap_store
from plvs_tpu.solvers import ba as jba
from plvs_tpu_torch import convert
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import LocalMapper
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam import local_mapping as tlocal_mapping
from plvs_tpu_torch.slam import map_store as tmap_store
from plvs_tpu_torch.slam.tracking import OK

from test_torch_system import CAM_ARGS, CAM_KW, FLAGS, N_FRAMES, _frames, _run

POSE_TOL = 1e-2
POINT_TOL = 0.1
LBA = dict(FLAGS, local_ba=True, backend_fixed_shapes=True)
JCAM = jcam.pinhole(*CAM_ARGS, **CAM_KW)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps this
    file from oversubscribing the cores the parallel test workers share
    (with the default thread count it ran about 10x slower under the
    Tier-1 run's six workers than alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _snapshot(store) -> dict:
    """The JAX store's state as plain copies (its lock left out)."""
    out = {}
    for k, v in vars(store).items():
        if isinstance(v, np.ndarray):
            out[k] = v.copy()
        elif isinstance(v, dict):
            out[k] = dict(v)
        elif isinstance(v, (int, np.integer)) and not isinstance(v, bool):
            out[k] = int(v)
    return out


# ---------------------------------------------------------------------------
# distinctive descriptors and point maintenance
# ---------------------------------------------------------------------------

def test_distinctive_rows_match_jax(rng):
    """Random words with shared bits (so medians tie), all-masked and
    single-valid rows, and rows with one duplicate descriptor."""
    P, M = 300, 12
    base = rng.integers(0, 2 ** 32, (P, 1, 8), dtype=np.uint64)
    flips = rng.integers(0, 2 ** 32, (P, M, 8), dtype=np.uint64) & \
        rng.integers(0, 2 ** 32, (P, M, 8), dtype=np.uint64) & \
        rng.integers(0, 2 ** 32, (P, M, 8), dtype=np.uint64)
    desc = (base ^ flips).astype(np.uint32)
    desc[::7, 3] = desc[::7, 5]
    mask = rng.random((P, M)) < 0.7
    mask[0] = False
    mask[1] = False
    mask[1, 4] = True
    got = tmap_store._distinctive_rows(torch.from_numpy(desc.view(np.int32)),
                                       torch.from_numpy(mask))
    want = np.asarray(jmap_store._distinctive_rows(desc, mask))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# a short JAX run with the backend on, recording each backend pass
# ---------------------------------------------------------------------------

STEP_FLAGS = dict(LBA, dense_mapping=False, max_kf_interval=3)
N_STEP_FRAMES = 16


@pytest.fixture(scope="module")
def jax_backend_run():
    """The JAX System over 16 frames with a keyframe every 3 frames; the
    store's state before and after every backend pass."""
    jsys = JSystem(jcam.pinhole(*CAM_ARGS, **CAM_KW), JConfig(**STEP_FLAGS))
    jlm = jsys.local_mapper
    orig = jlm.process_keyframe_stages
    passes = []

    def recording(kf_id, extra_fetch=None, submit=None):
        before = _snapshot(jsys.store)
        out = yield from orig(kf_id, extra_fetch=extra_fetch, submit=submit)
        passes.append((kf_id, before, _snapshot(jsys.store)))
        return out

    jlm.process_keyframe_stages = recording
    frames = _frames()
    extra = list(tsyn.SyntheticRGBD(
        tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
        texture=tsyn.make_structured_texture(
            1024, rng=np.random.default_rng(7)),
        tex_scale=220.0).sequence(
            tsyn.default_trajectory(36)[N_FRAMES:N_STEP_FRAMES]))
    states = [int(jsys.track_rgbd(g, d, ts)[0])
              for ts, g, d, _, _ in frames + extra]
    assert all(s == OK for s in states[1:]), states
    return jsys, passes


def _jax_store_from(snap: dict):
    """A JAX MapStore holding copies of a snapshot's state."""
    st = jmap_store.MapStore(
        max_kf=snap["kf_R"].shape[0], max_pts=snap["pt_xyz"].shape[0],
        max_obs=snap["obs_kf"].shape[0], n_kp=snap["kf_kp_xy"].shape[1],
        max_lines=snap["ln_Xs"].shape[0], max_lobs=snap["lobs_kf"].shape[0],
        n_kl=snap["kf_kl_sp"].shape[1])
    for k, v in snap.items():
        setattr(st, k, v.copy() if isinstance(v, np.ndarray) else
                dict(v) if isinstance(v, dict) else v)
    return st


def _port_mapper(store):
    return LocalMapper(convert.camera_from_numpy(
        JCAM.kind, np.asarray(JCAM.params), JCAM.width, JCAM.height, JCAM.bf),
        store, scale=1.2, n_levels=STEP_FLAGS["n_levels"], use_lines=True,
        fixed_shapes=True, device="cpu")


def _bucket(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


# the JAX mapper's fixed-shape buckets (floor) and padding value per field
_PAD = {"R": (32, None), "t": (32, 0.0), "fixed_cam": (32, True),
        "cam_mask": (32, False), "points": (4096, 0.0),
        "point_mask": (4096, False), "obs_cam": (16384, 0),
        "obs_pt": (16384, 0), "obs_uvr": (16384, -1.0),
        "obs_inv_sigma2": (16384, 1.0), "obs_mask": (16384, False),
        "lines_Xs": (512, 0.0), "lines_Xe": (512, 0.0),
        "line_mask": (512, False), "lobs_cam": (2048, 0),
        "lobs_line": (2048, 0), "lobs_nld": (2048, 0.0),
        "lobs_inv_sigma2": (2048, 1.0), "lobs_mask": (2048, False),
        "lobs_depth": (2048, 0.0)}


def _jax_solver(cam, prob, num_iters, cg_iters):
    """The JAX package's solver on the port's problem, padded as the JAX
    mapper pads it (fixed shapes), with the port's return convention."""
    f = {}
    for name in prob._fields:
        a = getattr(prob, name).numpy()
        if name in ("obs_cam", "obs_pt", "lobs_cam", "lobs_line"):
            a = a.astype(np.int32)
        lo, fill = _PAD[name]
        n = _bucket(a.shape[0], lo)
        out = np.zeros((n,) + a.shape[1:], a.dtype) if fill is None else \
            np.full((n,) + a.shape[1:], fill, a.dtype)
        if name == "R":
            out[:] = np.eye(3, dtype=a.dtype)
        out[: a.shape[0]] = a
        f[name] = jnp.asarray(out)
    res = jba.bundle_adjust_jit(JCAM, jba.make_problem(**f),
                                num_iters=num_iters, cg_iters=cg_iters,
                                scatter_free=True)
    K, P, L = prob.R.shape[0], prob.points.shape[0], prob.lines_Xs.shape[0]
    outs = [torch.from_numpy(np.asarray(a)[:n])
            for a, n in zip(res[:5], (K, K, P, L, L))]
    return (*outs, {k: torch.from_numpy(np.asarray(v))
                    for k, v in res[5].items()})


@pytest.fixture(params=["jax_solver", "port_solver"])
def solver(request, monkeypatch):
    if request.param == "jax_solver":
        monkeypatch.setattr(tlocal_mapping.ba, "bundle_adjust", _jax_solver)
    return request.param


def _assert_same_store(t, want: dict, what: str, solver: str):
    """Bookkeeping exact; geometry exact with the JAX solver, within
    POSE_TOL / POINT_TOL with the port's."""
    names = ["kf_mask", "pt_mask", "ln_mask", "kf_kp_pt", "kf_kl_line",
             "pt_n_obs", "ln_n_obs", "pt_visible", "pt_found", "ln_visible",
             "ln_found", "pt_desc", "ln_desc", "pt_angle", "kf_uid"]
    if solver == "jax_solver":
        names += ["kf_R", "kf_t", "pt_xyz", "ln_Xs", "ln_Xe", "pt_normal",
                  "pt_min_dist", "pt_max_dist"]
    for name in names:
        np.testing.assert_array_equal(getattr(t, name), want[name],
                                      err_msg=f"{what}: {name}")
    assert set(t.kf_tombstone) == set(want["kf_tombstone"]), what
    if solver == "jax_solver":
        return
    live, pts = want["kf_mask"], want["pt_mask"]
    for name, sel, tol in (("kf_R", live, POSE_TOL), ("kf_t", live, POSE_TOL),
                           ("pt_xyz", pts, POINT_TOL)):
        np.testing.assert_allclose(getattr(t, name)[sel], want[name][sel],
                                   atol=tol, err_msg=f"{what}: {name}")


def test_process_keyframe_matches_jax(jax_backend_run, solver):
    """Every recorded backend pass of the JAX run, replayed by the port
    from the same store; the run as a whole culled points and fused
    observations, and every port solve was finite and did not raise the
    cost."""
    _, passes = jax_backend_run
    assert len(passes) >= 4
    removed = fused = n_ba = 0
    for kf_id, before, after in passes:
        st = convert.map_store_from_numpy(before)
        mapper = _port_mapper(st)
        mapper.process_keyframe(kf_id)
        _assert_same_store(st, after, f"keyframe {kf_id}", solver)
        for b in mapper.ba_log:
            assert np.isfinite(b["cost"]) and b["cost"] <= b["cost0"], b
        n_ba += len(mapper.ba_log)
        removed += int((before["pt_mask"] & ~after["pt_mask"]).sum())
        # keypoints of other keyframes bound to a new or merged landmark
        moved = after["kf_kp_pt"] != before["kf_kp_pt"]
        moved[kf_id] = False
        fused += int((moved & (after["kf_kp_pt"] >= 0)).sum())
    assert n_ba == len(passes) - 1
    assert removed > 0 and fused > 0, (removed, fused)


def test_create_new_lines_matches_jax(jax_backend_run):
    """Line triangulation of each keyframe in turn against its covisible
    neighbours, from the final map with every line landmark removed (so
    every keyline is free): the same matches and the same accepted lines,
    endpoints within 1e-4 m."""
    jsys, _ = jax_backend_run
    snap = _snapshot(jsys.store)
    jst, st = _jax_store_from(snap), convert.map_store_from_numpy(snap)
    for s_ in (jst, st):
        s_.remove_lines(np.nonzero(s_.ln_mask)[0])
    jlm = jlocal_mapping.LocalMapper(JCAM, jst, scale=1.2, n_levels=4,
                                     use_lines=True)
    tlm = _port_mapper(st)
    for kf in np.nonzero(jst.kf_mask)[0]:
        jlm.create_new_lines(int(kf))
        tlm.create_new_lines(int(kf))
    want = _snapshot(jst)
    assert want["ln_mask"].sum() >= 5
    for name in ("ln_mask", "kf_kl_line", "ln_n_obs", "ln_desc", "lobs_kf",
                 "lobs_line", "lobs_kl", "lobs_mask"):
        np.testing.assert_array_equal(getattr(st, name), want[name],
                                      err_msg=name)
    live = want["ln_mask"]
    for name in ("ln_Xs", "ln_Xe"):
        np.testing.assert_allclose(getattr(st, name)[live], want[name][live],
                                   atol=1e-4, err_msg=name)


def test_point_maintenance_matches_jax(jax_backend_run):
    jsys, _ = jax_backend_run
    before = _snapshot(jsys.store)
    pts = np.nonzero(before["pt_mask"])[0]
    before["pt_desc"][pts] = 0    # the vote must bring them back
    jst, st = _jax_store_from(before), convert.map_store_from_numpy(before)
    jst.update_point_maintenance(pts, scale=1.2, n_levels=4)
    st.update_point_maintenance(pts, scale=1.2, n_levels=4, device="cpu")
    want = _snapshot(jst)
    np.testing.assert_array_equal(st.pt_desc, want["pt_desc"])
    np.testing.assert_array_equal(st.pt_angle, want["pt_angle"])
    np.testing.assert_allclose(st.pt_normal, want["pt_normal"], atol=1e-5)
    np.testing.assert_allclose(st.pt_max_dist, want["pt_max_dist"],
                               rtol=1e-5)
    np.testing.assert_allclose(st.pt_min_dist, want["pt_min_dist"],
                               rtol=1e-5)
    assert (want["pt_desc"][pts] != 0).any(-1).all()


def test_global_ba_matches_jax(jax_backend_run, solver):
    jsys, _ = jax_backend_run
    snap = _snapshot(jsys.store)
    jst, st = _jax_store_from(snap), convert.map_store_from_numpy(snap)
    jlocal_mapping.LocalMapper(JCAM, jst, scale=1.2, n_levels=4,
                               use_lines=True, fixed_shapes=True).global_ba()
    info = _port_mapper(st).global_ba()
    _assert_same_store(st, _snapshot(jst), "global BA", solver)
    assert np.isfinite(info["cost"]) and info["cost"] <= info["cost0"]
    assert len(info["window"]) == int(st.kf_mask.sum())


def test_replace_point_and_line_match_jax(jax_backend_run):
    """Landmark merges in both stores: pairs that share a keyframe (an
    observation dropped) and pairs that do not (observations moved)."""
    jsys, _ = jax_backend_run
    snap = _snapshot(jsys.store)
    jst, st = _jax_store_from(snap), convert.map_store_from_numpy(snap)
    pts = np.nonzero(jst.pt_mask & (jst.pt_n_obs >= 2))[0]
    lns = np.nonzero(jst.ln_mask & (jst.ln_n_obs >= 2))[0]
    assert len(pts) >= 40 and len(lns) >= 4
    for s_ in (jst, st):
        for a, b in zip(pts[:20], pts[-20:]):
            s_.replace_point(int(a), int(b))
        for a, b in zip(lns[:2], lns[-2:]):
            s_.replace_line(int(a), int(b))
    want = _snapshot(jst)
    for name in ("pt_mask", "pt_n_obs", "pt_visible", "pt_found", "obs_pt",
                 "obs_mask", "kf_kp_pt", "ln_mask", "ln_n_obs", "ln_visible",
                 "ln_found", "lobs_line", "lobs_mask", "kf_kl_line"):
        np.testing.assert_array_equal(getattr(st, name), want[name],
                                      err_msg=name)


def test_tombstones_resolve_as_in_jax(jax_backend_run):
    """Cull two keyframes in turn (the second may anchor on a survivor that
    the first anchored on) in both stores: every uid resolves to the same
    pose, and the tombstones survive a second carry."""
    jsys, _ = jax_backend_run
    snap = _snapshot(jsys.store)
    jst, st = _jax_store_from(snap), convert.map_store_from_numpy(snap)
    live = np.nonzero(jst.kf_mask)[0]
    assert len(live) >= 3
    for kf in (int(live[1]), int(live[-2])):
        jst.remove_keyframe(kf)
        st.remove_keyframe(kf)
    assert set(st.kf_tombstone) == set(jst.kf_tombstone)
    for uid in range(jst._next_kf_uid):
        a, b = st.resolve_kf_pose(uid), jst.resolve_kf_pose(uid)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a[0], b[0], atol=1e-6)
            np.testing.assert_allclose(a[1], b[1], atol=1e-6)
    st2 = convert.map_store_from_numpy(_snapshot(jst))
    assert set(st2.kf_tombstone) == set(jst.kf_tombstone)
    for uid in jst.kf_tombstone:
        np.testing.assert_array_equal(st2.resolve_kf_pose(uid)[1],
                                      st.resolve_kf_pose(uid)[1])


# ---------------------------------------------------------------------------
# the System end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def system_runs():
    frames = _frames()
    jres = _run(JSystem(jcam.pinhole(*CAM_ARGS, **CAM_KW), JConfig(**LBA)),
                frames)
    tsys = TSystem(tcam.pinhole(*CAM_ARGS, **CAM_KW), TConfig(**LBA),
                   device="cpu")
    tres = _run(tsys, frames)
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    return jres, tres, gt, tsys


def test_system_with_local_ba_tracks_like_jax(system_runs):
    """Both track every frame with the same live keyframes; the ATEs
    within tests/test_torch_system.py's bound (20% of each other plus
    0.5 mm); the port ran one finite, non-increasing local BA per keyframe
    after the first."""
    (js, jt, jmap, _), (ts_, tt, tmap, _), gt, tsys = system_runs
    assert all(s == OK for s in js[1:]), js
    assert all(s == OK for s in ts_[1:]), ts_
    assert tmap["keyframes"] == jmap["keyframes"] >= 2
    ate_j = evaluation.ate_rmse(jt[:, 1:4], gt, align=True)
    ate_t = evaluation.ate_rmse(tt[:, 1:4], gt, align=True)
    assert ate_t < 0.03, ate_t
    assert abs(ate_t - ate_j) <= 0.2 * max(ate_j, ate_t) + 5e-4, (ate_j, ate_t)
    # every keyframe made after the first (culled ones too) had its solve
    log = tsys.local_mapper.ba_log
    assert len(log) == tsys.store._next_kf_uid - 1 >= 1
    assert all(np.isfinite(b["cost"]) and b["cost"] <= b["cost0"]
               for b in log), log
    # the backend ran once per keyframe, the first one included (its
    # culling stage runs once a pass; the local_mapping scope times each
    # stage of the staged pass)
    assert tsys.time_stats()["lm.cull"]["count"] == tsys.store._next_kf_uid


def test_system_with_local_ba_dense_map_agrees(system_runs):
    """The dense maps of both runs within tests/test_torch_system.py's
    bounds: the same remeshed-block counts and allocated blocks, occupied
    voxels and cached mesh triangles within 1%."""
    (_, _, jmap, jd), (_, _, tmap, td), _, _ = system_runs
    assert td["remeshed"] == jd["remeshed"]
    assert td["blocks"] == jd["blocks"]
    for key in ("occupied", "cached_tris"):
        assert jd[key] > 1000 and abs(td[key] - jd[key]) <= 0.01 * jd[key], (
            key, jd[key], td[key])


# ---------------------------------------------------------------------------
# the sharded backend on the product path (__graft_entry__.dryrun_multichip)
# ---------------------------------------------------------------------------

DRY_CAM = (300.0, 300.0, 160.0, 120.0)
DRY_KW = dict(width=320, height=240, bf=24.0)
# dryrun_multichip's System: the global BA runs sharded over the mesh
DRY_FLAGS = dict(num_features=128, n_levels=3, max_kf=32, max_pts=4096,
                 local_ba=True, loop_closing=False, sharded_backend=True)


def _dryrun_map(stores):
    """dryrun_multichip's product-path map, written identically into each
    store: 512 landmarks 2.5-6 m ahead (1 cm of noise on their positions)
    seen by 6 keyframes 5 cm apart, each keyframe's keypoints the exact
    projections of the landmarks it sees."""
    rng = np.random.default_rng(1)
    pts_w = np.stack([rng.uniform(-2, 2, 512), rng.uniform(-1.5, 1.5, 512),
                      rng.uniform(2.5, 6, 512)], -1).astype(np.float32)
    noise = rng.normal(0, 0.01, (512, 3)).astype(np.float32)
    fx, fy, cx, cy = DRY_CAM
    pids = None
    for st in stores:
        pids = st.alloc_pts(512)
        st.pt_mask[pids] = True
        st.pt_xyz[pids] = pts_w + noise
        for i in range(6):
            kf = st.alloc_kf()
            st.kf_mask[kf] = True
            st.kf_R[kf] = np.eye(3, dtype=np.float32)
            st.kf_t[kf] = np.asarray([-0.05 * i, 0, 0], np.float32)
            Xc = pts_w @ st.kf_R[kf].T + st.kf_t[kf]
            uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                           fy * Xc[:, 1] / Xc[:, 2] + cy], -1).astype(
                np.float32)
            ok = (Xc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < 320) \
                & (uv[:, 1] >= 0) & (uv[:, 1] < 240)
            sel = np.nonzero(ok)[0][: st.n_kp]
            st.kf_kp_uvr[kf, : len(sel), :2] = uv[sel]
            st.kf_kp_uvr[kf, : len(sel), 2] = -1.0
            st.kf_kp_mask[kf, : len(sel)] = True
            st.pt_ref_kf[pids[sel]] = np.where(
                st.pt_ref_kf[pids[sel]] < 0, kf, st.pt_ref_kf[pids[sel]])
            st.add_observations(kf, pids[sel], np.arange(len(sel)))
    return pids


def test_sharded_system_global_ba_like_jax():
    """A System with ``sharded_backend``: the JAX one builds its mesh over
    the 8 virtual CPU devices; the port's, on the CPU, has none (as on one
    card), and gets an 8-shard CPU mesh set on its local mapper. Both run
    dryrun_multichip's global BA (10 LM x 30 CG, sharded, segment sums).
    Keyframe poses within 1e-5 and landmarks within 1e-3 m of JAX's and of
    the port's unsharded solve (measured 1.2e-7 and 1.5e-5 m: the same
    solve, its float32 partial sums in another order; the mono depths,
    held by 25 cm of baseline, take the most of it)."""
    jsys = JSystem(jcam.pinhole(*DRY_CAM, **DRY_KW), JConfig(**DRY_FLAGS))
    tsys = TSystem(tcam.pinhole(*DRY_CAM, **DRY_KW), TConfig(**DRY_FLAGS),
                   device="cpu")
    assert jsys.mesh is not None and jsys.local_mapper.mesh is not None
    assert tsys.mesh is None and tsys.local_mapper.mesh is None
    from plvs_tpu_torch.parallel import sharded_ba as tsb

    tsys.local_mapper.mesh = tsb.make_mesh(8, device="cpu")
    pids = _dryrun_map([jsys.store, tsys.store])
    x0 = tsys.store.pt_xyz[pids].copy()
    jsys.local_mapper.global_ba()
    tinfo = tsys.local_mapper.global_ba()
    js, ts = jsys.store, tsys.store
    assert np.isfinite(ts.pt_xyz[pids]).all()
    assert tinfo["cost"] < tinfo["cost0"]
    assert not np.array_equal(ts.pt_xyz[pids], x0)
    live = np.nonzero(ts.kf_mask)[0]
    np.testing.assert_array_equal(live, np.nonzero(js.kf_mask)[0])
    np.testing.assert_allclose(ts.kf_R[live], js.kf_R[live], atol=1e-5)
    np.testing.assert_allclose(ts.kf_t[live], js.kf_t[live], atol=1e-5)
    np.testing.assert_allclose(ts.pt_xyz[pids], js.pt_xyz[pids], atol=1e-3)
    # the unsharded solve of the same map reaches the same optimum (the
    # keypoints are exact projections, so the cost falls to float32 noise)
    one = TSystem(tcam.pinhole(*DRY_CAM, **DRY_KW), TConfig(**DRY_FLAGS),
                  device="cpu")
    _dryrun_map([one.store])
    oinfo = one.local_mapper.global_ba()
    assert abs(tinfo["cost"] - oinfo["cost"]) <= 1e-6 * tinfo["cost0"]
    np.testing.assert_allclose(ts.pt_xyz[pids], one.store.pt_xyz[pids],
                               atol=1e-3)
