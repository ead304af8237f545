"""The port's VI local bundle adjustment and 4-DoF pose graph against the
JAX package's, on the same numpy inputs.

VI BA: ``vi_bundle_adjust`` against ``vi_bundle_adjust_jit`` at the
runtime's 6 LM x 30 CG, on windows of 6 and 8 keyframes (body states from
the chip run's inertial motion, a camera-body extrinsic off the identity,
2-5 m points seen by every keyframe that sees them in the image, a third
of them stereo, pixel noise; the initial states perturbed by ~1 cm /
5 mrad and the points by 2 cm), with and without line edges. Tolerances,
each a few times the worst case measured over the three problems (in
brackets): rotations 1e-5 (7e-7), positions 2e-5 m (2.3e-6), velocities
1e-4 m/s (1.1e-5), gyro bias 5e-5 (8.8e-6), acc bias 2e-4 (2.9e-5),
points 5e-4 m (1.1e-4 at 5 m), final cost 1e-4 relative (5e-6). The
two frameworks round in another order (segment sums, forward-mode
Jacobians), and on these windows the CG runs all 30 steps of every LM
iteration without converging, so last-bit differences carry into the
step; a mono point's depth at 5 m is the least constrained coordinate.
The port's fixed-trip loops are held bit-equal to a while-loop
replay of themselves.

4-DoF pose graph: ``optimize(dof4_axis=...)`` against ``optimize_jit`` on a
chain with a loop edge, poses within 1e-4; the roll and pitch of every
vertex (its camera-frame gravity axis) stay where they were.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.imu import preintegration as jpre
from plvs_tpu.solvers import pose_graph as jpg
from plvs_tpu.solvers import vi_ba as jvi
from plvs_tpu_torch import convert
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.solvers import ba as tba
from plvs_tpu_torch.solvers import pose_graph as tpg
from plvs_tpu_torch.solvers import vi_ba as tvi

CAM_ARGS = (520.0, 520.0, 320.0, 240.0)
CAM_KW = dict(width=640, height=480, bf=40.0)
JCAM = jcam.pinhole(*CAM_ARGS, **CAM_KW)
TCAM = tcam.pinhole(*CAM_ARGS, **CAM_KW)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3)
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * K @ K)


def _vi_problem(K: int, lines: bool, seed: int = 5):
    """numpy fields of a VIProblem (JAX field names) over K keyframes, four
    frames apart, of the inertial sequence."""
    rng = np.random.default_rng(seed)
    frames = tsyn.inertial_sequence(n_frames=4 * K, seed=seed)
    kf = frames[3::4]
    R_cb = _rot([0.01, -0.02, 0.015]).astype(np.float32)
    t_cb = np.array([0.02, -0.01, 0.03], np.float32)
    # body = the sequence's frame; camera = T_cb T_bw
    R_wb = np.stack([R.T for _, R, _, _ in kf]).astype(np.float32)
    p_wb = np.stack([-R.T @ t for _, R, t, _ in kf]).astype(np.float32)
    ts = np.asarray([f[0] for f in kf])
    v_w = np.gradient(p_wb, ts, axis=0).astype(np.float32)
    g = np.array([0.3, 9.7, -0.4], np.float32)
    g = g / np.linalg.norm(g) * 9.81
    preints = []
    for i in range(1, K):
        sel = [s for f in frames[4 * i:4 * i + 4] for s in f[3]]
        st = np.asarray([s[0] for s in sel])
        preints.append(jpre.preintegrate_padded(
            np.stack([s[1] for s in sel]), np.stack([s[2] for s in sel]),
            np.diff(st, prepend=kf[i - 1][0]).astype(np.float32),
            np.zeros(3, np.float32), np.zeros(3, np.float32)))
    pre_np = {f: np.stack([np.asarray(getattr(p, f)) for p in preints])
              for f in jpre.Preintegrated._fields}

    R_cw = np.einsum("ij,kjl->kil", R_cb, R_wb.transpose(0, 2, 1))
    t_cw = (np.einsum("ij,kj->ki", R_cb, -np.einsum(
        "kji,kj->ki", R_wb, p_wb)) + t_cb).astype(np.float32)
    # points 2-6 m ahead of the middle camera
    P = 120
    mid = K // 2
    uv0 = rng.uniform([40, 40], [600, 440], (P, 2))
    z0 = rng.uniform(2.0, 5.0, P)
    Xc0 = np.stack([(uv0[:, 0] - 320) / 520 * z0,
                    (uv0[:, 1] - 240) / 520 * z0, z0], -1)
    pts = ((Xc0 - t_cw[mid]) @ R_cw[mid]).astype(np.float32)
    o_kf, o_pt, o_uvr = [], [], []
    for k in range(K):
        Xc = pts @ R_cw[k].T + t_cw[k]
        u = 520 * Xc[:, 0] / Xc[:, 2] + 320
        v = 520 * Xc[:, 1] / Xc[:, 2] + 240
        vis = (Xc[:, 2] > 0.5) & (u > 5) & (u < 635) & (v > 5) & (v < 475)
        for p in np.nonzero(vis)[0]:
            uR = u[p] - 40.0 / Xc[p, 2] if p % 3 == 0 else -1.0
            o_kf.append(k)
            o_pt.append(p)
            o_uvr.append([u[p], v[p], uR])
    o_uvr = np.asarray(o_uvr, np.float32)
    noise = rng.normal(0, 0.5, o_uvr.shape).astype(np.float32)
    noise[o_uvr[:, 2] < 0, 2] = 0.0
    o_uvr = o_uvr + noise
    M = len(o_kf)

    # perturbed initial state (keyframe 0 fixed)
    dR = np.stack([_rot(rng.normal(0, 0.005, 3)) for _ in range(K)])
    dR[0] = np.eye(3)
    dp = rng.normal(0, 0.01, (K, 3))
    dp[0] = 0
    out = dict(
        R_wb=np.einsum("kij,kjl->kil", dR, R_wb).astype(np.float32),
        p_wb=(p_wb + dp).astype(np.float32),
        v_w=(v_w + rng.normal(0, 0.02, (K, 3))).astype(np.float32),
        bg=np.zeros((K, 3), np.float32), ba=np.zeros((K, 3), np.float32),
        fixed=np.arange(K) == 0, kf_mask=np.ones(K, bool),
        R_cb=R_cb, t_cb=t_cb,
        points=(pts + rng.normal(0, 0.02, pts.shape)).astype(np.float32),
        point_mask=np.ones(P, bool),
        obs_kf=np.asarray(o_kf, np.int32), obs_pt=np.asarray(o_pt, np.int32),
        obs_uvr=o_uvr, obs_inv_sigma2=np.ones(M, np.float32),
        obs_mask=np.ones(M, bool), pre_stack=pre_np,
        pre_mask=np.ones(K - 1, bool), gravity=g)
    if lines:
        # 3 m-wide segments at 4-5 m, observed as their projected lines
        L = 6
        Xs = ((np.stack([rng.uniform(-1.5, 0, L), rng.uniform(-1, 1, L),
                         rng.uniform(4, 5, L)], -1) - t_cw[mid]) @ R_cw[mid])
        Xe = Xs + rng.normal(0, 1.0, (L, 3))
        l_kf, l_s, l_e, l_nld = [], [], [], []
        for k in range(K):
            for j in range(L):
                a = Xs[j] @ R_cw[k].T + t_cw[k]
                b = Xe[j] @ R_cw[k].T + t_cw[k]
                ua = 520 * a[:2] / a[2] + [320, 240]
                ub = 520 * b[:2] / b[2] + [320, 240]
                d = ub - ua
                n = np.array([-d[1], d[0]]) / np.linalg.norm(d)
                l_kf.append(k)
                l_s.append(Xs[j])
                l_e.append(Xe[j])
                l_nld.append([n[0], n[1], -(n @ ua) + rng.normal(0, 0.3)])
        Ml = len(l_kf)
        out.update(lobs_kf=np.asarray(l_kf, np.int32),
                   lobs_Xs=np.asarray(l_s, np.float32),
                   lobs_Xe=np.asarray(l_e, np.float32),
                   lobs_nld=np.asarray(l_nld, np.float32),
                   lobs_inv_sigma2=np.full(Ml, 0.5, np.float32),
                   lobs_mask=np.ones(Ml, bool))
    return out


def _jax_problem(d):
    pre = jpre.Preintegrated(*(jnp.asarray(d["pre_stack"][f])
                               for f in jpre.Preintegrated._fields))
    kw = {k: jnp.asarray(v) for k, v in d.items() if k != "pre_stack"}
    return jvi.VIProblem(**kw, pre_stack=pre)


def _port_problem(d):
    kw = {}
    for k, v in d.items():
        if k == "pre_stack":
            kw[k] = convert.preintegrated_from_numpy(v, device="cpu")
        else:
            a = np.asarray(v)
            if k in ("obs_kf", "obs_pt", "lobs_kf"):
                a = a.astype(np.int64)
            kw[k] = torch.from_numpy(np.ascontiguousarray(a))
    return tvi.VIProblem(**kw)


def _solve_both(d, **kw):
    jout = jvi.vi_bundle_adjust_jit(JCAM, _jax_problem(d), **kw)
    tout = tvi.vi_bundle_adjust(TCAM, _port_problem(d), **kw)
    return jout, tout


@pytest.mark.parametrize("K,lines", [(6, False), (8, False), (8, True)])
def test_vi_bundle_adjust_matches_jax(K, lines):
    d = _vi_problem(K, lines)
    (jR, jp, jv, jbg, jba, jpts, jinfo), (tR, tp, tv, tbg, tba_, tpts,
                                         tinfo) = _solve_both(
        d, num_iters=6, cg_iters=30)
    c0, c1 = float(jinfo["cost0"]), float(jinfo["cost"])
    assert c1 < 0.5 * c0                 # the problem really moved
    np.testing.assert_allclose(float(tinfo["cost0"]), c0, rtol=1e-5)
    np.testing.assert_allclose(float(tinfo["cost"]), c1, rtol=1e-4)
    for a, b, tol in ((tR, jR, 1e-5), (tp, jp, 2e-5), (tv, jv, 1e-4),
                      (tbg, jbg, 5e-5), (tba_, jba, 2e-4),
                      (tpts, jpts, 5e-4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=tol,
                                   rtol=0)


def _while_pcg(matvec, precond, b, cg_iters):
    """The JAX solver's CG as a Python while loop reading rz every step."""
    r = b
    x = tuple(torch.zeros_like(v) for v in b)
    p = z = precond(*r)
    rz = rz0 = tba._dot(r, z)
    tiny = torch.full((), 1e-20, dtype=rz.dtype)
    i = 0
    while i < cg_iters and bool(rz > 1e-12 * rz0):
        Ap = matvec(*p)
        alpha = rz / tba._guard_abs(tba._dot(p, Ap), tiny)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * Ai for ri, Ai in zip(r, Ap))
        z = precond(*r)
        rz_new = tba._dot(r, z)
        beta = rz_new / tba._guard_abs(rz, tiny)
        p = tuple(zi + beta * pi for zi, pi in zip(z, p))
        rz = rz_new
        i += 1
    return x, torch.tensor(i, dtype=torch.int32)


def _while_lm(step, state, num_iters):
    i, lm_n, cg_n = 0, 0, 0
    while i < num_iters:
        state, done, n_cg = step(*state)
        lm_n += 1
        cg_n += int(n_cg)
        i += 1
        if bool(done):
            break
    return state, torch.tensor(lm_n), torch.tensor(cg_n)


@pytest.mark.parametrize("lines", [False, True])
def test_fixed_trip_vi_ba_is_its_while_loop_replay(monkeypatch, lines):
    """The fixed-trip solve against the same solve with both loops as
    Python while loops that read their stop tests back: bit-equal, with the
    same LM and CG counts."""
    prob = _port_problem(_vi_problem(8, lines))
    fixed = tvi.vi_bundle_adjust(TCAM, prob, num_iters=6, cg_iters=30)
    monkeypatch.setattr(tvi, "_pcg", _while_pcg)
    monkeypatch.setattr(tvi, "_lm_loop", _while_lm)
    replay = tvi.vi_bundle_adjust(TCAM, prob, num_iters=6, cg_iters=30)
    for a, b in zip(fixed[:6], replay[:6]):
        assert torch.equal(a, b)
    assert torch.equal(fixed[6]["cost"], replay[6]["cost"])
    for key in ("lm_iters", "cg_iters"):
        assert int(fixed[6][key]) == int(replay[6][key])


def test_padded_window_solves_like_the_runtime(rng):
    """The runtime's padding (masked keyframes with zero preintegrations,
    masked points and observations) leaves the real part of the solve
    finite and close to the unpadded one."""
    d = _vi_problem(6, False)
    pk = 2
    dp = dict(d)
    for k, fill in (("R_wb", np.eye(3, dtype=np.float32)[None]),):
        dp[k] = np.concatenate([d[k], np.repeat(fill, pk, 0)])
    for k in ("p_wb", "v_w", "bg", "ba"):
        dp[k] = np.concatenate([d[k], np.zeros((pk, 3), np.float32)])
    dp["fixed"] = np.concatenate([d["fixed"], np.ones(pk, bool)])
    dp["kf_mask"] = np.concatenate([d["kf_mask"], np.zeros(pk, bool)])
    dp["pre_stack"] = {f: np.concatenate(
        [v, np.zeros((pk,) + v.shape[1:], np.float32)])
        for f, v in d["pre_stack"].items()}
    dp["pre_mask"] = np.concatenate([d["pre_mask"], np.zeros(pk, bool)])
    a = tvi.vi_bundle_adjust(TCAM, _port_problem(d), num_iters=6,
                             cg_iters=30)
    b = tvi.vi_bundle_adjust(TCAM, _port_problem(dp), num_iters=6,
                             cg_iters=30)
    assert all(torch.isfinite(x).all() for x in b[:6])
    for x, y in zip(a[:6], b[:6]):
        np.testing.assert_allclose(y[:x.shape[0]].numpy(), x.numpy(),
                                   atol=1e-4, rtol=0)


def _pose_graph_np(rng, K=12):
    """A drifted chain of K poses on a circle with a loop edge 0 -> K-1."""
    R, t = [], []
    for i in range(K):
        ang = 2 * np.pi * i / K
        Ri = _rot([0.02 * np.sin(i), -ang + 0.01 * i, 0.01 * np.cos(i)])
        C = np.array([np.sin(ang), 0.05 * np.sin(2 * ang), np.cos(ang)])
        R.append(Ri.astype(np.float32))
        t.append((-Ri @ C).astype(np.float32))
    R, t = np.stack(R), np.stack(t)
    s = np.ones(K, np.float32)
    pairs = np.asarray([(i, i - 1) for i in range(1, K)] + [(K - 1, 0)])
    eR, et, es = (np.array(x) for x in jpg.make_edges_from_poses(
        jnp.asarray(R), jnp.asarray(t), jnp.asarray(s), jnp.asarray(pairs)))
    # the loop edge says the chain drifted: 5 cm and 0.03 rad of yaw
    dR = _rot([0.0, 0.03, 0.0]).astype(np.float32)
    eR[-1] = dR @ eR[-1]
    et[-1] = et[-1] + np.array([0.05, 0.0, -0.03], np.float32)
    fixed = np.zeros(K, bool)
    fixed[0] = True
    w = np.ones(len(pairs), np.float32)
    w[-1] = float(len(pairs))
    return dict(R=R, t=t, s=s, fixed=fixed,
                edge_i=pairs[:, 0].astype(np.int32),
                edge_j=pairs[:, 1].astype(np.int32), edge_R=eR, edge_t=et,
                edge_s=es, edge_weight=w, edge_mask=np.ones(len(pairs), bool))


def test_dof4_pose_graph_matches_jax(rng):
    d = _pose_graph_np(rng)
    g = np.array([0.3, 9.7, -0.4], np.float32)
    g = g / np.linalg.norm(g)
    axis = np.einsum("kij,j->ki", d["R"], g).astype(np.float32)
    jR, jt, js, jinfo = jpg.optimize_jit(
        jpg.PoseGraphProblem(**{k: jnp.asarray(v) for k, v in d.items()}),
        num_iters=12, fix_scale=True, dof4_axis=jnp.asarray(axis))
    tprob = convert.pose_graph_problem_from_numpy(d, device="cpu")
    tR, tt, ts, tinfo = tpg.optimize(tprob, num_iters=12, cg_iters=50,
                                     fix_scale=True,
                                     dof4_axis=torch.from_numpy(axis))
    assert float(jinfo["cost"]) < 0.5 * float(jinfo["cost0"])
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(tinfo["cost"]), float(jinfo["cost"]),
                               rtol=1e-3)
    # roll and pitch untouched: each vertex's gravity axis is where it was
    np.testing.assert_allclose(np.einsum("kij,j->ki", tR.numpy(), g), axis,
                               atol=1e-5, rtol=0)
    # and without the axis the 6-DoF solve bends them
    R6 = tpg.optimize(tprob, num_iters=12, cg_iters=50, fix_scale=True)[0]
    assert np.abs(np.einsum("kij,j->ki", R6.numpy(), g) - axis).max() > 1e-4
