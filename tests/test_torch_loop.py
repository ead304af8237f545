"""Loop closing: the port's Sim3 group, RANSAC, pose graph, atlas and
covisibility operations, loop closer and dense rebuild against the JAX
package's on the same inputs.

Tolerances, and why:

* Sim3 exp / log / compose / inverse / apply: within 4e-6 — the same
  formulas, with 3x3 products summed in another order by another library
  (measured <= 3.6e-7 on tangents up to |0.5|; the log of a
  near-identity rotation amplifies that near its Taylor switch).
* ``sim3_ransac_from_samples`` given JAX's samples: inlier masks and
  counts exact, pose within 1e-5 (float32 SVDs of two libraries).
* The pose graph (12 LM x 50 CG on tests/test_loop.py's drifted chain with
  a loop edge): poses within 1e-3 of ``pose_graph.optimize_jit`` (measured
  1.1e-5 on rotations, 5.8e-5 m on translations: the Jacobians come from
  two autodiff systems and CG amplifies their last bits), bit-equal to a
  literal host-loop version of the same solve, and its Jacobians bit-equal
  to ``torch.func.jacfwd`` under ``vmap``.
* ``covis_graph`` / ``spanning_tree`` and ``merge_map_into``: exact.
* The loop closer on tests/test_slam_e2e.py's drifted revisit, both fed
  one converted store: the same outcome and candidate; inlier counts within
  10% (each RANSAC draws its own samples); corrected keyframe translations
  within 2 cm (the pose graph is seeded from RANSAC poses that differ by
  the sampling).
* ``DenseMapper.rebuild``: the same blocks, tsdf and weight within 1e-5
  (tests/test_torch_dense.py's integration tolerance), color (0..255)
  within 5e-3 (measured 2.4e-3 on 3 of 307,200 values: running averages
  over three re-integrations, relative 1.7e-5).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from plvs_tpu import native
from plvs_tpu.dense.mapping import DenseMapper as JDenseMapper
from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.geometry import lie as jlie
from plvs_tpu.slam import System as JSystem, SystemConfig as JConfig
from plvs_tpu.slam import keyframe_database as jkfdb
from plvs_tpu.slam import loop_closing as jloop
from plvs_tpu.slam import map_store as jmap_store
from plvs_tpu.slam.local_mapping import _SyncFetch
from plvs_tpu.solvers import pose_graph as jpg
from plvs_tpu.solvers import sim3_solver as jsim3
from plvs_tpu_torch import convert
from plvs_tpu_torch.dense.mapping import DenseMapper as TDenseMapper
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.geometry import lie as tlie
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import System as TSystem, SystemConfig as TConfig
from plvs_tpu_torch.slam import keyframe_database as tkfdb
from plvs_tpu_torch.slam import loop_closing as tloop
from plvs_tpu_torch.slam import map_store as tmap_store
from plvs_tpu_torch.solvers import ba as tba
from plvs_tpu_torch.solvers import pose_graph as tpg
from plvs_tpu_torch.solvers import sim3_solver as tsim3

import test_loop
from test_torch_local_mapping import _jax_store_from, _snapshot
from test_torch_place_recognition import _need_native

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread keeps this file from
    oversubscribing the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)




def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# ---------------------------------------------------------------------------
# Sim3
# ---------------------------------------------------------------------------

def _tangents(rng):
    z = (rng.normal(size=(64, 7)) * 0.5).astype(np.float32)
    z[:8, :6] *= 1e-5          # near-identity rotations and translations
    z[8:16, 6] = 0.0           # unit scale
    z[16:24, 6] *= 1e-5        # scale within the Taylor branch
    z[24:28] = 0.0
    return z


def test_sim3_group_matches_jax(rng):
    z = _tangents(rng)
    z2 = _tangents(rng)[::-1].copy()
    jg = jlie.sim3_exp(jnp.asarray(z))
    tg = tlie.sim3_exp(_t(z))
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=4e-6)
    jlog = np.asarray(jlie.sim3_log(*jg))
    tlog = tlie.sim3_log(*tg).numpy()
    np.testing.assert_allclose(tlog, jlog, atol=4e-6)
    np.testing.assert_allclose(tlog, z, atol=5e-5)
    jg2 = jlie.sim3_exp(jnp.asarray(z2))
    tg2 = tlie.sim3_exp(_t(z2))
    for a, b in zip(tlie.sim3_compose(*tg, *tg2), jlie.sim3_compose(*jg, *jg2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=4e-6)
    for a, b in zip(tlie.sim3_inverse(*tg), jlie.sim3_inverse(*jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=4e-6)
    p = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tlie.sim3_apply(*tg, _t(p)).numpy(),
        np.asarray(jlie.sim3_apply(*jg, jnp.asarray(p))), atol=4e-6)


def test_sim3_log_has_forward_jacobians_under_vmap():
    """The pose graph differentiates sim3_log with jacfwd under vmap: the
    batched Jacobian equals the per-sample one."""
    z = torch.tensor([[0.1, -0.2, 0.3, 0.2, -0.1, 0.4, 0.05]] * 3)
    z[1, 3:6] = 1e-6
    R, t, s = tlie.sim3_exp(z)

    def f(R, t, s):
        return tlie.sim3_log(R[None], t[None], s[None])[0]

    J = torch.func.vmap(torch.func.jacfwd(f, argnums=1))(R, t, s)
    for i in range(3):
        Ji = torch.func.jacfwd(f, argnums=1)(R[i], t[i], s[i])
        np.testing.assert_allclose(J[i].numpy(), Ji.numpy(), atol=1e-6)
    assert float(J.abs().max()) < 10.0


# ---------------------------------------------------------------------------
# RANSAC
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_scale,n_invalid", [(True, 0), (False, 0),
                                                  (True, 40)])
def test_ransac_from_jax_samples(rng, with_scale, n_invalid):
    n = 240
    P = (rng.normal(size=(n, 3)) * 2).astype(np.float32)
    R_gt = np.asarray(jlie.so3_exp(jnp.asarray([0.3, -0.5, 0.2],
                                               jnp.float32)))
    s_gt = 1.6 if with_scale else 1.0
    Q = (s_gt * P @ R_gt.T + np.array([1.0, -0.5, 2.0], np.float32)
         + rng.normal(size=(n, 3)).astype(np.float32) * 0.005)
    out = rng.choice(n, n * 3 // 10, replace=False)
    Q[out] += rng.uniform(1, 3, (len(out), 3)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[rng.choice(n, n_invalid, replace=False)] = False
    key = jax.random.PRNGKey(3)
    jr = jsim3.sim3_ransac(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(valid),
                           key, with_scale=with_scale)
    # the samples sim3_ransac drew inside its program
    probs = valid.astype(np.float32) + 1e-6
    samples = np.asarray(jax.random.choice(
        key, n, shape=(256, 3), p=jnp.asarray(probs / probs.sum())))
    tr = tsim3.sim3_ransac_from_samples(_t(P), _t(Q), _t(valid), _t(samples),
                                        with_scale=with_scale)
    np.testing.assert_array_equal(tr.inliers.numpy(), np.asarray(jr.inliers))
    assert int(tr.n_inliers) == int(jr.n_inliers) > n // 2
    for a, b in ((tr.R, jr.R), (tr.t, jr.t), (tr.s, jr.s)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # the port's own sampling finds the same model
    g = torch.Generator().manual_seed(0)
    own = tsim3.sim3_ransac(_t(P), _t(Q), _t(valid), g, with_scale=with_scale)
    np.testing.assert_allclose(own.R.numpy(), R_gt, atol=0.01)
    assert abs(int(own.n_inliers) - int(jr.n_inliers)) <= 3


# ---------------------------------------------------------------------------
# pose graph
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain():
    prob, gt_R, gt_t = test_loop.TestPoseGraph()._chain_problem(
        np.random.default_rng(0))
    tprob = convert.pose_graph_problem_from_numpy(
        {f: np.asarray(getattr(prob, f)) for f in prob._fields},
        device="cpu")
    return prob, tprob


def test_pose_graph_matches_jax(chain):
    prob, tprob = chain
    jR, jt, js, jinfo = jpg.optimize_jit(prob, num_iters=12, fix_scale=True)
    tR, tt, ts, tinfo = tpg.optimize(tprob, num_iters=12, cg_iters=50,
                                     fix_scale=True)
    np.testing.assert_allclose(float(tinfo["cost0"]), float(jinfo["cost0"]),
                               rtol=1e-5)
    assert float(tinfo["cost"]) < 0.05 * float(tinfo["cost0"])
    np.testing.assert_allclose(float(tinfo["cost"]), float(jinfo["cost"]),
                               rtol=1e-2)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
    np.testing.assert_allclose(ts.numpy(), 1.0, atol=1e-6)
    # the fixed vertex stays put
    np.testing.assert_array_equal(tR[0].numpy(), tprob.R[0].numpy())


def _optimize_host_loop(prob, num_iters, cg_iters, fix_scale, lam0=1e-4):
    """The JAX package's early-exit loops written out literally, reading
    the loop conditions back to the host."""
    K = prob.R.shape[0]
    free = (~prob.fixed).float()[:, None]
    w = prob.edge_weight * prob.edge_mask
    seg_i = tba._onehot_seg_reduce(prob.edge_i, K)
    seg_j = tba._onehot_seg_reduce(prob.edge_j, K)
    eye = torch.eye(7)
    tiny = torch.full((), 1e-20)

    def cost_of(R, t, s):
        return tpg.edge_costs(prob, R, t, s).sum()

    R, t, s = prob.R, prob.t, prob.s
    lam = torch.full((), lam0)
    cost = cost0 = cost_of(R, t, s)
    i, done = 0, False
    while i < num_iters and not done:
        r, Ji, Jj = tpg.linearize(prob, R, t, s, fix_scale)
        b = -(seg_i(((Ji * r[..., None]).sum(-2)) * w[:, None])
              + seg_j(((Jj * r[..., None]).sum(-2)) * w[:, None])) * free
        Hd = (seg_i((Ji.transpose(-1, -2) @ Ji) * w[:, None, None])
              + seg_j((Jj.transpose(-1, -2) @ Jj) * w[:, None, None]))
        lam_diag = lam * torch.diagonal(Hd, dim1=-2, dim2=-1) + 1e-8
        M = torch.linalg.inv_ex(Hd + lam_diag[..., None] * eye
                                + 1e-8 * eye)[0]

        def matvec(x):
            x = x * free
            u = ((Ji @ x[prob.edge_i][..., None])[..., 0]
                 + (Jj @ x[prob.edge_j][..., None])[..., 0]) * w[:, None]
            y = (seg_i((Ji * u[..., None]).sum(-2))
                 + seg_j((Jj * u[..., None]).sum(-2)))
            return (y + lam_diag * x) * free

        def precond(rr):
            return (M @ rr[..., None])[..., 0] * free

        x = torch.zeros_like(b)
        rr = b
        p = z = precond(rr)
        rz = rz0 = (rr * z).sum()
        k = 0
        while k < cg_iters and bool(rz > 1e-12 * rz0):
            Ap = matvec(p)
            alpha = rz / torch.maximum((p * Ap).sum(), tiny)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = (rr * z).sum()
            beta = rz_new / torch.maximum(rz, tiny)
            p = z + beta * p
            rz = rz_new
            k += 1
        Rn, tn, sn = tpg._apply_delta(R, t, s, x, fix_scale)
        cost_new = cost_of(Rn, tn, sn)
        if bool(cost_new < cost):
            done = bool(cost - cost_new < 1e-8 * cost)
            R, t, s, cost = Rn, tn, sn, cost_new
            lam = torch.clamp(lam * 0.5, min=1e-8)
        else:
            lam = torch.clamp(lam * 4.0, max=1e3)
        i += 1
    return R, t, s, cost0, cost


@pytest.mark.parametrize("fix_scale", [True, False])
def test_pose_graph_jacobians_equal_jacfwd(chain, fix_scale):
    """``linearize``'s one dual-number pass over the stacked edges gives
    ``torch.func.jacfwd`` under ``vmap`` bit for bit, away from the start
    (after two LM steps). Each edge is evaluated as a batch of one inside
    vmap: there a per-edge scale is a 0-dim tensor, and torch.where of a
    0-dim float32 tensor and a Python-number expression promotes to float64
    under forward-mode AD."""
    _, tprob = chain
    R, t, s, _ = tpg.optimize(tprob, num_iters=2, cg_iters=5,
                              fix_scale=True)
    r, Ji, Jj = tpg.linearize(tprob, R, t, s, fix_scale)
    f = tpg._edge_fn(fix_scale)
    ei, ej = tprob.edge_i, tprob.edge_j
    args = (R[ei], t[ei], s[ei], R[ej], t[ej], s[ej], tprob.edge_R,
            tprob.edge_t, tprob.edge_s)
    z = torch.zeros((ei.shape[0], 7))
    Ai, Aj = torch.func.vmap(torch.func.jacfwd(
        lambda *a: f(*(x[None] for x in a))[0], argnums=(0, 1)))(z, z, *args)
    assert torch.equal(Ji, Ai) and torch.equal(Jj, Aj)
    assert torch.equal(r, f(z, z, *args))
    assert float(Ji.abs().max()) > 0.5
    if fix_scale:
        assert not Ji[..., 6].any() and not Jj[..., 6].any()


@pytest.mark.parametrize("num_iters,cg_iters", [(12, 50), (4, 3)])
def test_pose_graph_fixed_trip_counts_equal_host_loop(chain, num_iters,
                                                      cg_iters):
    """Bit-equal on the CPU: the fixed-trip-count solve freezes its state
    exactly where the early-exit loops stop."""
    _, tprob = chain
    R, t, s, info = tpg.optimize(tprob, num_iters=num_iters,
                                 cg_iters=cg_iters, fix_scale=True)
    hR, ht, hs, hc0, hc = _optimize_host_loop(tprob, num_iters, cg_iters,
                                              True)
    for a, b in ((R, hR), (t, ht), (s, hs), (info["cost0"], hc0),
                 (info["cost"], hc)):
        assert torch.equal(a, b)


def test_pose_graph_unported_options_raise(chain):
    """The sharded pose graph (item 8) raises; map objects are ported
    since slice 10 (tests/test_torch_map_objects.py holds their loop move)
    and the 4-DoF correction of inertial maps (``gravity_w``,
    ``dof4_axis``) since slice 8 (tests/test_torch_vi_ba.py holds it to
    JAX)."""
    st = tmap_store.MapStore(max_kf=4, max_pts=16, n_kp=8)
    with pytest.raises(NotImplementedError, match="item 8"):
        tloop.LoopCloser(st, device="cpu", mesh=object())
    objs = object()
    assert tloop.LoopCloser(st, device="cpu",
                            object_store=objs).object_store is objs
    g = np.array([0.3, 9.7, -0.4], np.float32)
    assert tloop.LoopCloser(st, device="cpu", gravity_w=g).gravity_w is g


# ---------------------------------------------------------------------------
# covisibility graph, spanning tree, atlas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_kf,n_pts,n_obs", [
    (64, 500, 4000),       # one key per bucket
    (512, 3000, 40000),    # keys share buckets; the table rehashes once
    (1024, 5000, 60000),   # rehashes twice
])
def test_covis_graph_and_spanning_tree_match_native(rng, max_kf, n_pts,
                                                    n_obs):
    _need_native()
    okf = rng.integers(0, max_kf, n_obs)
    opt = rng.integers(0, n_pts, n_obs)
    m = rng.random(n_obs) < 0.9
    for min_w in (1, 3):
        want = native.covis_graph(okf, opt, m, max_kf, n_pts,
                                  min_weight=min_w)
        got = tmap_store.covis_graph(okf, opt, m, max_kf, n_pts,
                                     min_weight=min_w)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        ei, ej, w = want
        sym = (np.concatenate([ei, ej]), np.concatenate([ej, ei]),
               np.concatenate([w, w]))
        np.testing.assert_array_equal(tmap_store.spanning_tree(*sym, max_kf),
                                      native.spanning_tree(*sym, max_kf))


def _two_map_store(rng):
    """A JAX store with two maps: keyframes, points and lines in each."""
    st = jmap_store.MapStore(max_kf=16, max_pts=512, n_kp=32, max_lines=64)
    for map_id in (0, 1):
        if map_id:
            st.create_map()
        kfs = []
        for _ in range(3):
            k = st.alloc_kf()
            kfs.append(k)
            st.kf_mask[k] = True
            st.kf_R[k] = np.asarray(jlie.so3_exp(jnp.asarray(
                rng.normal(size=3) * 0.3, jnp.float32)))
            st.kf_t[k] = rng.normal(size=3).astype(np.float32)
        pts = st.alloc_pts(40)
        st.pt_mask[pts] = True
        st.pt_xyz[pts] = rng.normal(size=(40, 3)).astype(np.float32)
        st.pt_ref_kf[pts] = rng.choice(kfs, 40)
        lns = st.alloc_lines(6)
        st.ln_mask[lns] = True
        st.ln_Xs[lns] = rng.normal(size=(6, 3)).astype(np.float32)
        st.ln_Xe[lns] = rng.normal(size=(6, 3)).astype(np.float32)
        st.ln_ref_kf[lns] = rng.choice(kfs, 6)
    # a keyframe saved without a uid
    del st.uid_slot[int(st.kf_uid[1])]
    st.kf_uid[1] = -1
    return st


def test_atlas_operations_match_jax(rng):
    js = _two_map_store(rng)
    ts = convert.map_store_from_numpy(_snapshot(js))
    assert ts.n_maps == js.n_maps == 2 and ts.active_map == 1
    for m in (0, 1):
        np.testing.assert_array_equal(ts.points_of_map(m),
                                      js.points_of_map(m))
        np.testing.assert_array_equal(ts.kfs_of_map(m), js.kfs_of_map(m))
    G_R = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.05],
                                              jnp.float32)))
    G_t = np.array([0.3, -0.1, 0.2], np.float32)
    for st in (js, ts):
        st.merge_map_into(1, 0, G_R, G_t, G_s=1.25)
        st.ensure_uids()
        assert st.create_map() == 2
    for name in ("kf_R", "kf_t", "kf_map", "kf_uid", "pt_xyz", "ln_Xs",
                 "ln_Xe"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name),
                                      err_msg=name)
    assert (ts.active_map, ts.n_maps, ts._next_kf_uid) == (
        js.active_map, js.n_maps, js._next_kf_uid)
    assert ts.uid_slot == js.uid_slot


# ---------------------------------------------------------------------------
# the loop closer on a drifted revisit
# ---------------------------------------------------------------------------

N_REVISIT_FRAMES = 16


@pytest.fixture(scope="module")
def revisit():
    """tests/test_slam_e2e.py's drifted revisit, shortened: the JAX System
    (loop closing on) over a lateral sweep, then a manufactured revisit of
    keyframe 0 with a drifted pose and its own duplicate landmarks. Returns
    the JAX store's snapshot, the database's word lists and the revisit's
    slot."""
    cam = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    scene = tsyn.SyntheticRGBD(tcam.pinhole(*CAM_ARGS, **CAM_KW), wall_z=3.0,
                               seed=4, tex_size=2048, tex_scale=220.0)
    poses = []
    for i in range(N_REVISIT_FRAMES):
        C = np.array([1.2 * i / (N_REVISIT_FRAMES - 1), 0.0, 0.0],
                     np.float32)
        poses.append((np.eye(3, dtype=np.float32), -C))
    system = JSystem(cam, JConfig(num_features=512, n_levels=4, max_kf=32,
                                  max_pts=16384, max_kf_interval=5,
                                  loop_closing=True))
    for ts, gray, depth, _, _ in scene.sequence(poses=poses):
        system.track_rgbd(gray, depth, ts)
    assert not system.loops_closed
    st = system.store
    kf0, kf_new = 0, st.alloc_kf()
    st.kf_mask[kf_new] = True
    st.kf_frame_id[kf_new] = system.tracker.frame_id + 100
    st.kf_R[kf_new] = st.kf_R[kf0]
    st.kf_t[kf_new] = st.kf_t[kf0] + np.array([0.25, 0.1, -0.15], np.float32)
    for a in ("kf_kp_xy", "kf_kp_uvr", "kf_kp_desc", "kf_kp_octave",
              "kf_kp_angle", "kf_kp_mask"):
        getattr(st, a)[kf_new] = getattr(st, a)[kf0]
    sel = np.nonzero(st.kf_kp_mask[kf0] & (st.kf_kp_pt[kf0] >= 0))[0]
    old = st.kf_kp_pt[kf0][sel]
    new = st.alloc_pts(len(sel))
    Rwc = st.kf_R[kf_new].T
    twc = -Rwc @ st.kf_t[kf_new]
    st.pt_xyz[new] = (st.pt_xyz[old] @ st.kf_R[kf0].T + st.kf_t[kf0]) \
        @ Rwc.T + twc
    st.pt_desc[new] = st.pt_desc[old]
    st.pt_mask[new] = True
    st.pt_ref_kf[new] = kf_new
    st.pt_first_kf[new] = kf_new
    st.add_observations(kf_new, new, sel)
    words = {k: (w.copy(), v.copy())
             for k, (w, v) in system.kfdb._kf_words.items()}
    return _snapshot(st), words, kf_new


def _closers(revisit, required):
    _need_native()
    snap, words, kf_new = revisit
    js = _jax_store_from(snap)
    ts = convert.map_store_from_numpy(snap)
    jdb = jkfdb.KeyFrameDatabase(js)
    tdb = convert.keyframe_database_from_numpy(
        ts, tkfdb._shared_vocab(tkfdb._DEFAULT_VOCAB), words, device="cpu")
    for k, (w, v) in words.items():
        jdb.ensure_vocab()
        jdb._kf_words[k] = (w, v)
        jdb._ensure_index()
        jdb._inv.add(k, w, v)
    tcam_ = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    jc = jloop.LoopCloser(js, kfdb=jdb, cam=jcam.pinhole(*CAM_ARGS, **CAM_KW),
                          required_coincidences=required)
    tc = tloop.LoopCloser(ts, kfdb=tdb, cam=tcam_, device="cpu",
                          required_coincidences=required)
    jc.trace, tc.trace = [], []
    return js, ts, jc, tc, kf_new


def test_revisit_pending_after_one_coincidence(revisit):
    """With the default two coincidences both closers hold the revisit as
    a pending detection of keyframe 0 and close nothing."""
    js, ts, jc, tc, kf_new = _closers(revisit, required=2)
    assert jc.process_keyframe(kf_new) is None
    assert tc.process_keyframe(kf_new) is None
    assert (tc._pending["cand"], tc._pending["count"]) == (
        jc._pending["cand"], jc._pending["count"]) == (0, 1)
    jinl, tinl = jc.trace[-1]["inl"], tc.trace[-1]["inl"]
    assert abs(tinl - jinl) <= 0.1 * jinl, (jc.trace, tc.trace)


def test_revisit_closed_and_corrected_like_jax(revisit):
    """One coincidence required: both close against keyframe 0, fuse the
    duplicate landmarks, and pull the drifted keyframe back onto keyframe
    0's pose; every corrected keyframe within 2 cm of JAX's."""
    js, ts, jc, tc, kf_new = _closers(revisit, required=1)
    err0 = np.linalg.norm(ts.kf_t[kf_new] - ts.kf_t[0])
    jinfo = jc.process_keyframe(kf_new)
    tinfo = tc.process_keyframe(kf_new)
    assert jinfo is not None and tinfo is not None, (jc.trace, tc.trace)
    assert tinfo["candidate"] == jinfo["candidate"] == 0
    assert abs(tinfo["inliers"] - jinfo["inliers"]) <= 0.1 * jinfo["inliers"]
    assert abs(tinfo["n_fused"] - jinfo["n_fused"]) <= 0.1 * jinfo["n_fused"]
    assert tinfo["cost"] < tinfo["cost0"]
    assert np.linalg.norm(ts.kf_t[kf_new] - ts.kf_t[0]) < 0.25 * err0
    live = np.nonzero(js.kf_mask)[0]
    np.testing.assert_array_equal(np.nonzero(ts.kf_mask)[0], live)
    np.testing.assert_allclose(ts.kf_t[live], js.kf_t[live], atol=0.02)
    np.testing.assert_allclose(ts.kf_R[live], js.kf_R[live], atol=0.02)
    assert ts.num_points == js.num_points


# tests/test_loop.py's consecutive-coincidence cases on a shared store
_GATE_CASES = ("two_coincidences", "gap_resets", "strong_shortcut",
               "single_closes")


@pytest.mark.parametrize("case", _GATE_CASES)
def test_coincidence_gate_matches_jax(case):
    required = {"two_coincidences": 2, "gap_resets": 2, "strong_shortcut": 3,
                "single_closes": 1}[case]
    rng = np.random.default_rng(0)
    js, jc, kf2, kf3 = test_loop.TestCoincidenceGate()._build(rng, required)
    ts = convert.map_store_from_numpy(_snapshot(js))
    tdb = convert.keyframe_database_from_numpy(
        ts, tkfdb._shared_vocab(tkfdb._DEFAULT_VOCAB), jc.kfdb._kf_words,
        device="cpu")
    tc = tloop.LoopCloser(ts, kfdb=tdb, required_coincidences=required,
                          strong_inliers=10 ** 9, device="cpu")
    if case == "strong_shortcut":
        jc.strong_inliers = tc.strong_inliers = 60
    blanks = rng.integers(0, 2 ** 32, (2, 64, 8), dtype=np.uint32)

    def blank_kf(st, i):
        k = st.alloc_kf()
        st.kf_mask[k] = True
        st.kf_R[k] = np.eye(3, dtype=np.float32)
        st.kf_t[k] = np.array([50.0, 0, 0], np.float32)
        st.kf_frame_id[k] = 202 + i
        st.kf_kp_desc[k, :64] = blanks[i]
        st.kf_kp_mask[k, :64] = True
        return k

    seq = {"two_coincidences": [kf2, kf3], "gap_resets": [kf2, "b0", "b1"],
           "strong_shortcut": [kf2, kf3], "single_closes": [kf2]}[case]
    for step in seq:
        out = []
        for st, c in ((js, jc), (ts, tc)):
            k = blank_kf(st, int(step[1])) if isinstance(step, str) else step
            info = c.process_keyframe(k)
            pend = c._pending
            out.append((info is not None,
                        None if pend is None else (pend["cand"],
                                                   pend["count"]),
                        None if info is None else info["candidate"]))
            if info is not None:
                out[-1] += (info["inliers"], info.get("n_fused", 0))
        (jclosed, jpend, *jrest), (tclosed, tpend, *trest) = out
        assert (tclosed, tpend) == (jclosed, jpend), (case, step, out)
        if jclosed:
            assert trest[0] == jrest[0]
            for a, b in zip(trest[1:], jrest[1:]):
                assert abs(a - b) <= 0.1 * b, out
    np.testing.assert_allclose(ts.kf_t[: js._n_kf], js.kf_t[: js._n_kf],
                               atol=0.02)


def test_merge_across_maps_matches_jax():
    """The revisit of tests/test_loop.py's coincidence store made in a
    second map of the atlas: one coincidence closes it as a merge, which
    welds the second map into the first (keyframe poses, landmarks, map
    ids) and fuses the verified duplicate points, as in JAX."""
    rng = np.random.default_rng(0)
    js, jc, kf2, kf3 = test_loop.TestCoincidenceGate()._build(rng, 1)
    # the revisit keyframes start a second map
    js.n_maps = 2
    js.kf_map[[kf2, kf3]] = 1
    js.active_map = 1
    ts = convert.map_store_from_numpy(_snapshot(js))
    tdb = convert.keyframe_database_from_numpy(
        ts, tkfdb._shared_vocab(tkfdb._DEFAULT_VOCAB), jc.kfdb._kf_words,
        device="cpu")
    tc = tloop.LoopCloser(ts, kfdb=tdb, required_coincidences=1,
                          strong_inliers=10 ** 9, device="cpu")
    jinfo = jc.process_keyframe(kf2)
    tinfo = tc.process_keyframe(kf2)
    assert jinfo is not None and tinfo is not None
    assert jinfo.get("merge") and tinfo.get("merge")
    for key in ("merged_map", "into_map", "n_kf", "candidate"):
        assert tinfo[key] == jinfo[key], key
    assert abs(tinfo["n_fused"] - jinfo["n_fused"]) <= 0.1 * jinfo["n_fused"]
    assert ts.active_map == js.active_map == 0
    np.testing.assert_array_equal(ts.kf_map, js.kf_map)
    np.testing.assert_allclose(ts.kf_t[: js._n_kf], js.kf_t[: js._n_kf],
                               atol=0.02)
    live = js.pt_mask
    np.testing.assert_allclose(ts.pt_xyz[live], js.pt_xyz[live], atol=0.05)


# ---------------------------------------------------------------------------
# dense rebuild
# ---------------------------------------------------------------------------

def test_dense_rebuild_matches_jax():
    """Three keyframes integrated, then re-integrated at moved poses (one
    keyframe gone): the same blocks and field as the JAX rebuild, and the
    mesher starts over in both."""
    cam_j = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    cam_t = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    tex = tsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    scene = tsyn.SyntheticRGBD(cam_t, wall_z=3.0, texture=tex,
                               tex_scale=220.0)
    frames = list(scene.sequence(tsyn.default_trajectory(36)[:9:4]))
    jdm = JDenseMapper(cam_j, voxel_size=0.04, mesh_every=1)
    tdm = TDenseMapper(cam_t, voxel_size=0.04, mesh_every=1, device="cpu")
    for k, (_, g, d, R, t) in enumerate(frames):
        for _ in jdm.insert_stages("rgbd", k, g, d, R, t, _SyncFetch()):
            pass
        tdm.insert_keyframe("rgbd", k, g, d, R, t)
    assert tdm.mesher.n_triangles > 0
    dR = np.asarray(jlie.so3_exp(jnp.asarray([0.0, 0.03, 0.01], jnp.float32)))
    moved = {k: ((R @ dR).astype(np.float32),
                 (t + np.array([0.05, -0.02, 0.03], np.float32)))
             for k, (_, _, _, R, t) in enumerate(frames)}

    def pose(k):
        return moved[k] if k != 1 else (None, None)

    jdm.rebuild(pose)
    tdm.rebuild(pose)
    assert tdm.mesher.n_triangles == 0 and not tdm.mesher.pending
    jv, tv = jdm.volume, tdm.volume
    assert tv.n_blocks == jv.n_blocks > 100
    np.testing.assert_array_equal(tv.block_coords, jv.block_coords)
    n = jv.n_blocks
    for name in ("weight", "tsdf"):
        np.testing.assert_allclose(getattr(tv, name)[:n],
                                   getattr(jv, name)[:n], atol=1e-5,
                                   err_msg=name)
    # color (0..255): float32 running averages, relative 2e-5
    np.testing.assert_allclose(tv.color[:n], jv.color[:n], atol=5e-3)
    jV, _ = jdm.mesh_incremental()
    tV, _ = tdm.mesh_incremental()
    assert tV.shape == jV.shape


# ---------------------------------------------------------------------------
# the System: loop closing, global BA, dense rebuild, trajectory export
# ---------------------------------------------------------------------------

def test_system_closes_a_revisit_and_reanchors_the_trajectory():
    """The port's System with loop closing, local BA and dense mapping on a
    short sweep, then a manufactured revisit of keyframe 0 handed to its
    backend: the loop closes, the global BA runs (finite, non-increasing),
    the dense map is rebuilt from every stored keyframe, and a frame
    recorded against the revisit keyframe is exported through its
    corrected pose."""
    cam = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    scene = tsyn.SyntheticRGBD(cam, wall_z=3.0, seed=4, tex_size=2048,
                               tex_scale=220.0)
    poses = [(np.eye(3, dtype=np.float32),
              -np.array([0.08 * i, 0.0, 0.0], np.float32)) for i in range(10)]
    system = TSystem(cam, TConfig(num_features=512, n_levels=4, max_kf=32,
                                  max_pts=16384, max_kf_interval=4,
                                  loop_closing=True, local_ba=True,
                                  dense_mapping=True, dense_voxel_size=0.04),
                     device="cpu")
    system.loop_closer.required_coincidences = 1
    for ts, gray, depth, _, _ in scene.sequence(poses=poses):
        assert system.track_rgbd(gray, depth, ts)[0] == 2
    st = system.store
    kf0, kf_new = 0, st.alloc_kf()
    st.kf_mask[kf_new] = True
    st.kf_frame_id[kf_new] = system.tracker.frame_id + 100
    st.kf_R[kf_new] = st.kf_R[kf0]
    st.kf_t[kf_new] = st.kf_t[kf0] + np.array([0.2, 0.05, -0.1], np.float32)
    for a in ("kf_kp_xy", "kf_kp_uvr", "kf_kp_desc", "kf_kp_octave",
              "kf_kp_angle", "kf_kp_mask"):
        getattr(st, a)[kf_new] = getattr(st, a)[kf0]
    sel = np.nonzero(st.kf_kp_mask[kf0] & (st.kf_kp_pt[kf0] >= 0))[0]
    old = st.kf_kp_pt[kf0][sel]
    new = st.alloc_pts(len(sel))
    Rwc = st.kf_R[kf_new].T
    st.pt_xyz[new] = (st.pt_xyz[old] @ st.kf_R[kf0].T + st.kf_t[kf0]) \
        @ Rwc.T - Rwc @ st.kf_t[kf_new]
    st.pt_desc[new] = st.pt_desc[old]
    st.pt_mask[new] = True
    st.pt_ref_kf[new] = st.pt_first_kf[new] = kf_new
    st.add_observations(kf_new, new, sel)
    # a frame tracked against the revisit keyframe, 1 cm in front of it
    t_frame = st.kf_t[kf_new] + np.array([0, 0, -0.01], np.float32)
    system.trajectory.append((99.0, st.kf_R[kf_new].copy(), t_frame))
    system._traj_rel.append((99.0, int(st.kf_uid[kf_new]),
                             np.eye(3, dtype=np.float32),
                             np.array([0, 0, -0.01], np.float32)))
    n_dense = len(system.dense_mapper.keyframes)

    info = system._backend_keyframe(kf_new)
    assert info is not None and info["candidate"] == 0
    assert system.loops_closed and system.loops_closed[0][0] == kf_new
    gba = info["global_ba"]
    assert gba is not None and np.isfinite(gba["cost"])
    assert gba["cost"] <= gba["cost0"]
    assert len(system.dense_mapper.keyframes) == n_dense
    assert system.dense_mapper.volume.n_blocks > 0
    assert np.linalg.norm(st.kf_t[kf_new] - st.kf_t[kf0]) < 0.05
    _, R_exp, t_exp = system.retro_trajectory()[-1]
    np.testing.assert_allclose(
        t_exp, st.kf_t[kf_new] + np.array([0, 0, -0.01], np.float32),
        atol=1e-5)
    assert np.linalg.norm(t_exp - t_frame) > 0.1
