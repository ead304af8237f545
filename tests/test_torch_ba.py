"""The port's triangulation and bundle adjustment against the JAX package's,
on the same numpy inputs.

Triangulation: float32, atol 1e-4 m at the 3 m scene scale (the two
frameworks round float32 products and sums in another order); the inputs
stay away from the validity gates, so the masks are equal exactly.

Bundle adjustment: ``bundle_adjust`` against
``bundle_adjust_jit(..., scatter_free=True)`` at the local BA's 5 LM x 14
CG, and in the same way its segment-sum formulation (``scatter_free=
False``) and its direct Schur preconditioner (``schur_direct=True``). Poses and points within 1e-4 (line endpoints: ``LINE_TOL``), the cost
within 1e-3 relative: the segment sums' cumulative sums carry about eps x
the global sum, and CG amplifies last-bit differences a little. ``lam`` is
equal exactly, which shows that every accept / reject decision matched.
The problems are RGB-D-like in conditioning: points 2-5 m ahead of a
1.5 m camera track, each seen at least twice, outliers only on points seen
4+ times. At tests/test_solvers.py's 4-10 m ahead of the same track float32
itself cannot resolve the mono depths to 1e-4 (the port in float32 against
the port in float64: 1.3 cm after one CG step, scripts/ba_conditioning.py),
and near convergence the LM
loop's stop test compares cost changes of float32 noise size, so its
decisions there are coin flips in either framework.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.geometry import lie as jlie
from plvs_tpu.geometry import triangulation as jtri
from plvs_tpu.solvers import ba as jba
from plvs_tpu_torch import convert
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.geometry import triangulation as ttri
from plvs_tpu_torch.solvers import ba as tba

CAM_ARGS = (520.0, 520.0, 320.0, 240.0)
CAM_KW = dict(width=640, height=480, bf=40.0)
JCAM = jcam.pinhole(*CAM_ARGS, **CAM_KW)
# a line endpoint slides along its line held only by the endpoint-depth
# rows (about 4 px of disparity per metre at 3 m): the port in float32
# against itself in float64 differs by 2.4e-4 m there on these problems
LINE_TOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The port's CPU ops here are small; one intra-op thread keeps this
    file from oversubscribing the cores the parallel test workers share,
    as in tests/test_torch_local_mapping.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
TCAM = tcam.pinhole(*CAM_ARGS, **CAM_KW)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(a, b, tol=1e-4):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol,
                               rtol=0.0)


def _so3(rng, n, s):
    return np.asarray(jlie.so3_exp(jnp.asarray(
        rng.normal(size=(n, 3)).astype(np.float32) * s)))


# ---------------------------------------------------------------------------
# triangulation
# ---------------------------------------------------------------------------

@pytest.fixture
def two_views(rng):
    """64 world points 2.5-4 m ahead of two cameras 1 m apart, their
    unit-depth rays in each camera, and the relative pose."""
    n = 64
    X = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                  rng.uniform(2.5, 4, n)], -1).astype(np.float32)
    R1, R2 = _so3(rng, 2, 0.05)
    t1 = np.zeros(3, np.float32)
    t2 = np.array([-1.0, 0.1, 0.05], np.float32)
    X1 = X @ R1.T + t1
    X2 = X @ R2.T + t2
    ray1 = (X1 / X1[:, 2:]).astype(np.float32)
    ray2 = (X2 / X2[:, 2:]).astype(np.float32)
    R12 = R1 @ R2.T
    t12 = t1 - R12 @ t2
    tile = lambda a: np.broadcast_to(a, (n,) + a.shape).astype(np.float32)  # noqa: E731
    return dict(X=X, R1=tile(R1), t1=tile(t1), R2=tile(R2), t2=tile(t2),
                ray1=ray1, ray2=ray2, R12=tile(R12.astype(np.float32)),
                t12=tile(t12.astype(np.float32)))


def test_triangulate_dlt_and_world(two_views):
    v = two_views
    Xj, okj = jtri.triangulate_dlt(*(jnp.asarray(v[k]) for k in
                                     ("ray1", "ray2", "R12", "t12")))
    Xt, okt = ttri.triangulate_dlt(*(_t(v[k]) for k in
                                     ("ray1", "ray2", "R12", "t12")))
    _close(Xt, Xj)
    assert bool(okt.all()) and np.array_equal(okt.numpy(), np.asarray(okj))
    keys = ("R1", "t1", "R2", "t2", "ray1", "ray2")
    Wj, wj = jtri.triangulate_points_world(*(jnp.asarray(v[k]) for k in keys))
    Wt, wt = ttri.triangulate_points_world(*(_t(v[k]) for k in keys))
    _close(Wt, Wj)
    _close(Wt, v["X"], tol=1e-3)   # noise-free rays meet at the point
    assert np.array_equal(wt.numpy(), np.asarray(wj))


def test_parallax_essential_epipolar(two_views):
    v = two_views
    _close(ttri.parallax_cos(_t(v["ray1"]), _t(v["ray2"]), _t(v["R12"])),
           jtri.parallax_cos(jnp.asarray(v["ray1"]), jnp.asarray(v["ray2"]),
                             jnp.asarray(v["R12"])), tol=1e-6)
    _close(ttri.essential_from_pose(_t(v["R12"]), _t(v["t12"])),
           jtri.essential_from_pose(jnp.asarray(v["R12"]),
                                    jnp.asarray(v["t12"])), tol=1e-6)
    et = ttri.epipolar_error(*(_t(v[k]) for k in ("ray1", "ray2", "R12",
                                                  "t12")))
    ej = jtri.epipolar_error(*(jnp.asarray(v[k]) for k in ("ray1", "ray2",
                                                           "R12", "t12")))
    _close(et, ej, tol=1e-6)
    assert float(et.max()) < 1e-5


def test_triangulate_line_planes(two_views, rng):
    """Segments with both endpoints about 3 m ahead, not parallel to the
    baseline (the degeneracy gate) and long enough in both images."""
    v = two_views
    n = v["X"].shape[0]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 1] += 2.0 * np.sign(d[:, 1] + 1e-3)   # mostly vertical segments
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    Xs = v["X"]
    Xe = (Xs + 0.8 * d).astype(np.float32)

    def rays(R, t, X):
        Xc = np.einsum("nij,nj->ni", R, X) + t
        return (Xc / Xc[:, 2:]).astype(np.float32)

    args = (v["R1"], v["t1"], v["R2"], v["t2"], rays(v["R1"], v["t1"], Xs),
            rays(v["R1"], v["t1"], Xe), rays(v["R2"], v["t2"], Xs),
            rays(v["R2"], v["t2"], Xe))
    _, _, okj, degj = jtri.triangulate_line_planes(
        *(jnp.asarray(a) for a in args))
    # away from the gates: keep the valid segments whose planes meet at a
    # degeneracy cosine well under the 0.998 gate
    keep = np.asarray(okj) & (np.asarray(degj) < 0.99)
    assert keep.sum() >= n // 2
    args = tuple(np.ascontiguousarray(a[keep]) for a in args)
    Xs = Xs[keep]
    Xsj, Xej, okj, degj = jtri.triangulate_line_planes(
        *(jnp.asarray(a) for a in args))
    Xst, Xet, okt, degt = ttri.triangulate_line_planes(*(_t(a) for a in args))
    assert bool(okt.all()) and np.asarray(okj).all()
    _close(degt, degj, tol=1e-5)
    _close(Xst, Xsj)
    _close(Xet, Xej)
    _close(Xst, Xs, tol=1e-3)


# ---------------------------------------------------------------------------
# bundle adjustment
# ---------------------------------------------------------------------------

def _ba_problem(rng, kind: str):
    """A windowed BA problem like tests/test_solvers.py's, as numpy fields
    of the JAX ``make_problem``. ``kind``: "mono"; "stereo_outliers" (uR
    rows, 10% gross outliers); "lines" (stereo points plus line
    observations with endpoint depths); "padded_fixed" (stereo, with
    camera / point / observation / line padding as the local mapper's fixed
    shapes leave it: two more fixed cameras, masked). Every problem fixes
    its first two cameras: with a third fixed the window converges inside
    the 5 LM iterations and the last accept / reject decisions compare
    cost changes of float32 noise size."""
    K, P = 6, 300
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                  rng.uniform(2.0, 5.0, P)], -1).astype(np.float32)
    R_gt = _so3(rng, K, 0.05)
    t_gt = (np.stack([[-0.3 * k, 0, 0] for k in range(K)])
            + rng.normal(size=(K, 3)) * 0.02).astype(np.float32)
    cams, pts, uvr = [], [], []
    for k in range(K):
        Xc = X @ R_gt[k].T + t_gt[k]
        uv = Xc[:, :2] / Xc[:, 2:] * 520.0 + np.array([320.0, 240.0])
        vis = ((uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0)
               & (uv[:, 1] < 480) & (Xc[:, 2] > 0.5))
        idx = np.nonzero(vis & (rng.uniform(size=P) > 0.3))[0]
        u = uv[idx] + rng.normal(size=(len(idx), 2)) * 0.3
        if kind != "mono":
            uR = u[:, 0] - 40.0 / Xc[idx, 2] + rng.normal(size=len(idx)) * 0.3
        else:
            uR = -np.ones(len(idx))
        cams.append(np.full(len(idx), k))
        pts.append(idx)
        uvr.append(np.concatenate([u, uR[:, None]], -1))
    obs_cam = np.concatenate(cams).astype(np.int32)
    obs_pt = np.concatenate(pts).astype(np.int32)
    obs_uvr = np.concatenate(uvr).astype(np.float32)
    # a point seen once has no depth in a mono problem (and an outlier
    # seen once none in any): observe every point at least twice
    seen = np.bincount(obs_pt, minlength=P) >= 2
    keep = seen[obs_pt]
    obs_cam, obs_pt, obs_uvr = obs_cam[keep], obs_pt[keep], obs_uvr[keep]
    M = len(obs_cam)
    if kind == "stereo_outliers":
        # gross outliers among the observations of points seen 4+ times
        # (a point with one good view of two has no depth to recover)
        many = np.nonzero(np.bincount(obs_pt, minlength=P)[obs_pt] >= 4)[0]
        bad = rng.choice(many, M // 20, replace=False)
        obs_uvr[bad] += (rng.uniform(15, 40, (len(bad), 3))
                         * rng.choice([-1, 1], (len(bad), 3)))
    fixed = np.arange(K) < 2
    R0, t0 = R_gt.copy(), t_gt.copy()
    for k in range(2, K):
        R0[k] = _so3(rng, 1, 0.01)[0] @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(size=3) * 0.03
    f = dict(R=R0, t=t0, fixed_cam=fixed, cam_mask=np.ones(K, bool),
             points=(X + rng.normal(size=(P, 3)) * 0.05).astype(np.float32),
             point_mask=seen, obs_cam=obs_cam, obs_pt=obs_pt,
             obs_uvr=obs_uvr,
             obs_inv_sigma2=(1.2 ** (-2.0 * rng.integers(0, 3, M))).astype(
                 np.float32),
             obs_mask=np.ones(M, bool))
    if kind == "lines":
        L = 40
        Xs = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                       rng.uniform(2.0, 4.5, L)], -1).astype(np.float32)
        # directions with a depth component: an endpoint sliding along a
        # segment square to the rays would be fixed by the damping alone
        d = rng.normal(size=(L, 3))
        d[:, 2] = np.sign(d[:, 2]) * (1.0 + np.abs(d[:, 2]))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        Xe = (Xs + 0.8 * d).astype(np.float32)
        lc, ll, nld, dep = [], [], [], []
        for k in range(K):
            for j in range(L):
                ends = []
                for Xw in (Xs[j], Xe[j]):
                    Xc = R_gt[k] @ Xw + t_gt[k]
                    ends.append((Xc[:2] / Xc[2] * 520.0 + [320.0, 240.0],
                                 Xc[2]))
                (sp, zs), (ep, ze) = ends
                dv = ep - sp
                nrm = np.array([-dv[1], dv[0]]) / np.linalg.norm(dv)
                lc.append(k)
                ll.append(j)
                nld.append([nrm[0], nrm[1], -nrm @ sp
                            + rng.normal() * 0.3])
                dep.append([zs, ze] if (k + j) % 5 else [0.0, 0.0])
        Ml = len(lc)
        f.update(
            lines_Xs=(Xs + rng.normal(size=(L, 3)) * 0.03).astype(np.float32),
            lines_Xe=(Xe + rng.normal(size=(L, 3)) * 0.03).astype(np.float32),
            line_mask=np.ones(L, bool), lobs_cam=np.asarray(lc, np.int32),
            lobs_line=np.asarray(ll, np.int32),
            lobs_nld=np.asarray(nld, np.float32),
            lobs_inv_sigma2=np.ones(Ml, np.float32),
            lobs_mask=np.ones(Ml, bool),
            lobs_depth=np.asarray(dep, np.float32))
    if kind == "padded_fixed":
        # the local mapper's padding: identity cameras fixed and masked,
        # zero points masked, observations (0, 0, uvr -1, is2 1) masked,
        # and an all-masked line block
        Kb, Pb, Mb = 8, 384, M + 200

        def pad(a, n, fill):
            out = np.full((n,) + a.shape[1:], fill, a.dtype)
            out[: len(a)] = a
            return out

        f["R"] = pad(f["R"], Kb, 0.0)
        f["R"][K:] = np.eye(3, dtype=np.float32)
        f["t"] = pad(f["t"], Kb, 0.0)
        f["fixed_cam"] = pad(f["fixed_cam"], Kb, True)
        f["cam_mask"] = pad(f["cam_mask"], Kb, False)
        f["points"] = pad(f["points"], Pb, 0.0)
        f["point_mask"] = pad(f["point_mask"], Pb, False)
        for name, fill in (("obs_cam", 0), ("obs_pt", 0), ("obs_uvr", -1.0),
                           ("obs_inv_sigma2", 1.0), ("obs_mask", False)):
            f[name] = pad(f[name], Mb, fill)
        f.update(lines_Xs=np.zeros((64, 3), np.float32),
                 lines_Xe=np.zeros((64, 3), np.float32),
                 line_mask=np.zeros(64, bool),
                 lobs_cam=np.zeros(256, np.int32),
                 lobs_line=np.zeros(256, np.int32),
                 lobs_nld=np.zeros((256, 3), np.float32),
                 lobs_inv_sigma2=np.ones(256, np.float32),
                 lobs_mask=np.zeros(256, bool),
                 lobs_depth=np.zeros((256, 2), np.float32))
    return f


def _both(fields):
    jprob = jba.make_problem(**{k: jnp.asarray(v) for k, v in fields.items()})
    tprob = convert.ba_problem_from_numpy(
        {f: np.asarray(getattr(jprob, f)) for f in jprob._fields},
        device="cpu")
    return jprob, tprob


def _compare(jout, tout):
    (Rj, tj, pj, lsj, lej, ij), (Rt, tt, pt, lst, let, it) = jout, tout
    for a, b in ((Rt, Rj), (tt, tj), (pt, pj)):
        _close(a, b)
    for a, b in ((lst, lsj), (let, lej)):
        _close(a, b, tol=LINE_TOL)
    cj, ct = float(ij["cost"]), float(it["cost"])
    assert abs(ct - cj) <= 1e-3 * abs(cj), (cj, ct)
    np.testing.assert_allclose(float(it["cost0"]), float(ij["cost0"]),
                               rtol=1e-5)
    assert float(it["lam"]) == float(ij["lam"]), (ij["lam"], it["lam"])


@pytest.mark.parametrize("kind", ["mono", "stereo_outliers", "lines",
                                  "padded_fixed"])
def test_bundle_adjust_matches_jax(rng, kind):
    fields = _ba_problem(rng, kind)
    jprob, tprob = _both(fields)
    jout = jba.bundle_adjust_jit(JCAM, jprob, num_iters=5, cg_iters=14,
                                 scatter_free=True)
    tout = tba.bundle_adjust(TCAM, tprob, num_iters=5, cg_iters=14)
    _compare(jout, tout)
    info = tout[-1]
    assert float(info["cost"]) < float(info["cost0"])
    assert 1 <= int(info["lm_iters"]) <= 5
    assert int(info["lm_iters"]) <= int(info["cg_iters"]) <= 14 * 5
    # fixed cameras stay where they were (a zero step still re-normalizes
    # the rotation, as in the JAX package)
    fixed = torch.from_numpy(fields["fixed_cam"])
    torch.testing.assert_close(tout[0][fixed], tprob.R[fixed], atol=1e-6,
                               rtol=0)
    torch.testing.assert_close(tout[1][fixed], tprob.t[fixed], atol=1e-6,
                               rtol=0)


def _while_pcg(matvec, precond, b, cg_iters):
    """The JAX package's CG while-loop, literally: a host read of the
    residual before every iteration."""
    dot = tba._dot
    r = b
    x = tuple(torch.zeros_like(v) for v in b)
    p = z = precond(*r)
    rz = rz0 = dot(r, z)
    tiny = torch.full((), 1e-20, dtype=rz.dtype)
    i = 0
    while i < cg_iters and bool(rz > 1e-12 * rz0):
        Ap = matvec(*p)
        pAp = dot(p, Ap)
        alpha = rz / torch.where(pAp.abs() < 1e-20, tiny, pAp)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * Ai for ri, Ai in zip(r, Ap))
        z = precond(*r)
        rz_new = dot(r, z)
        beta = rz_new / torch.where(rz.abs() < 1e-20, tiny, rz)
        p = tuple(zi + beta * pi for zi, pi in zip(z, p))
        rz = rz_new
        i += 1
    return x, i


@pytest.mark.parametrize("cg_iters", [3, 60])
def test_fixed_trip_pcg_matches_while_loop(rng, cg_iters):
    """The port's CG runs its full trip count with an active flag; on a
    small SPD system that converges past the 1e-12 residual test in float64
    it returns the while-loop's iterate bit for bit, and counts the
    while-loop's iterations."""
    n, cuts = 20, (6, 15)
    G = rng.normal(size=(n, n))
    A = torch.from_numpy(G @ G.T + n * np.eye(n))
    dinv = 1.0 / torch.diagonal(A)

    def split(v):
        return (v[:cuts[0]], v[cuts[0]:cuts[1]], v[cuts[1]:])

    def matvec(*parts):
        return split(A @ torch.cat(parts))

    def precond(*parts):
        return split(dinv * torch.cat(parts))

    b = split(torch.from_numpy(rng.normal(size=n)))
    x_ref, n_ref = _while_pcg(matvec, precond, b, cg_iters)
    x, n_act = tba._pcg(matvec, precond, b, cg_iters)
    assert int(n_act) == n_ref and (n_ref < cg_iters) == (cg_iters == 60)
    assert all(torch.equal(a, c) for a, c in zip(x, x_ref))


@pytest.mark.parametrize("num_iters,want", [(2, 2), (10, 3)])
def test_fixed_trip_lm_loop_stops_where_the_while_loop_stops(num_iters, want):
    """A scripted LM step that reports done on its third call: the state
    freezes there, and the active LM and CG iterations are counted."""
    def step(v, k):
        k1 = k + 1
        return (v * 0.5, k1), k1 >= 3, (k1 + 1).to(torch.int32)

    state = (torch.tensor([8.0, -4.0]), torch.zeros((), dtype=torch.int64))
    (v, k), lm_n, cg_n = tba._lm_loop(step, state, num_iters)
    assert int(k) == want and int(lm_n) == want
    assert torch.equal(v, torch.tensor([8.0, -4.0]) * 0.5 ** want)
    assert int(cg_n) == sum(range(2, 2 + want))


@pytest.mark.parametrize("kind", ["mono", "stereo_outliers", "lines",
                                  "padded_fixed"])
def test_segment_sum_formulation_matches_jax(rng, kind):
    """``scatter_free=False`` (``index_add_``, the sharded backend's
    formulation) against the JAX package's ``jax.ops.segment_sum`` solve,
    to the tolerances of ``_compare`` (module docstring)."""
    jprob, tprob = _both(_ba_problem(rng, kind))
    _compare(jba.bundle_adjust_jit(JCAM, jprob, num_iters=5, cg_iters=14,
                                   scatter_free=False),
             tba.bundle_adjust(TCAM, tprob, num_iters=5, cg_iters=14,
                               scatter_free=False))


@pytest.mark.parametrize("kind", ["mono", "stereo_outliers", "lines",
                                  "padded_fixed"])
def test_schur_direct_matches_jax(rng, kind):
    """``schur_direct=True`` against the JAX package's, both in the
    product path's ``scatter_free=True`` formulation, to ``_compare``'s
    tolerances: the reduced system carries ~1e-2 relative float32 error
    through its inverses in either package, but it only preconditions CG
    on the exact operator, so the solved blocks agree as the PCG solve's
    do (measured: poses 2e-7, points 8e-6 m, line endpoints 5e-6 m, every
    lam equal). In the segment-sum formulation the mono window's last LM
    decision compares cost changes of float32 noise size (one more
    rejection in the port), so that pairing is not compared here."""
    jprob, tprob = _both(_ba_problem(rng, kind))
    jout = jba.bundle_adjust_jit(JCAM, jprob, num_iters=5, cg_iters=14,
                                 scatter_free=True, schur_direct=True)
    tout = tba.bundle_adjust(TCAM, tprob, num_iters=5, cg_iters=14,
                             schur_direct=True)
    _compare(jout, tout)
    info = tout[-1]
    # at most 10 CG iterations an LM step, each preconditioned by the
    # factored reduced system
    assert int(info["lm_iters"]) <= int(info["cg_iters"]) <= 10 * 5
    assert float(info["cost"]) < float(info["cost0"])


def test_unported_modes_raise(rng):
    """Both formulations and the direct Schur preconditioner run on one
    window and reach the same optimum: costs within 1e-4 relative of the
    default solve's (the window converges inside its 10 LM iterations)."""
    _, tprob = _both(_ba_problem(rng, "stereo_outliers"))
    base = float(tba.bundle_adjust(TCAM, tprob)[-1]["cost"])
    for kw in (dict(scatter_free=False), dict(schur_direct=True),
               dict(scatter_free=False, schur_direct=True)):
        out = tba.bundle_adjust(TCAM, tprob, **kw)
        assert all(bool(torch.isfinite(o).all()) for o in out[:5]), kw
        assert abs(float(out[-1]["cost"]) - base) <= 1e-4 * base, kw


def test_degenerate_window_neither_package_raises():
    """One landmark seen once by the one free camera: its point block is
    rank 2 and the problem has a null space. A Cholesky or inverse that
    raised on it (``torch.linalg.cholesky`` / ``inv`` do) would stop the
    solve; the port takes ``cholesky_ex`` / ``inv_ex`` as the JAX package's
    NaN-returning factorizations behave. Both reach zero cost with equal
    lam in every mode; the blocks agree to 2e-4 (they slide along the null
    space by float32 noise). With every observation masked, the cost is
    infinite and every step is rejected in both."""
    f = dict(R=np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
             t=np.array([[0, 0, 0], [-0.3, 0, 0]], np.float32),
             fixed_cam=np.array([True, False]), cam_mask=np.ones(2, bool),
             points=np.array([[0.1, 0.2, 3.0]], np.float32),
             point_mask=np.ones(1, bool), obs_cam=np.array([1], np.int32),
             obs_pt=np.array([0], np.int32),
             obs_uvr=np.array([[300.0, 280.0, -1.0]], np.float32),
             obs_inv_sigma2=np.ones(1, np.float32), obs_mask=np.ones(1, bool))
    for mask in (True, False):
        f["obs_mask"] = np.array([mask])
        jprob, tprob = _both(f)
        for sf, sd in ((True, False), (False, False), (True, True),
                       (False, True)):
            jo = jba.bundle_adjust_jit(JCAM, jprob, num_iters=5, cg_iters=14,
                                       scatter_free=sf, schur_direct=sd)
            to = tba.bundle_adjust(TCAM, tprob, num_iters=5, cg_iters=14,
                                   scatter_free=sf, schur_direct=sd)
            ji, ti = jo[-1], to[-1]
            assert float(ti["lam"]) == float(ji["lam"]), (mask, sf, sd)
            if mask:
                assert float(ti["cost"]) == float(ji["cost"]) == 0.0
                for a, b in zip(to[:3], jo[:3]):
                    _close(a, b, tol=2e-4)
            else:
                assert np.isinf(float(ti["cost"])) and np.isinf(
                    float(ji["cost"]))
                for a, b in zip(to[1:3], (tprob.t, tprob.points)):
                    assert torch.equal(a, b)


def test_exact_segment_sum_resets_per_segment(rng):
    """``_sorted_seg_reduce_exact`` against ``index_add_`` and float64, with
    empty segments reading 0: a segment of small values beside huge ones
    keeps its own precision (the cumulative-sum trick loses it)."""
    idx = torch.from_numpy(rng.integers(0, 50, 700))
    idx[idx == 7] = 8                         # segment 7 empty
    v = torch.from_numpy(rng.normal(size=(700, 3, 2)).astype(np.float32))
    v[idx == 3] *= 1e6                        # one segment of huge values
    got = tba._sorted_seg_reduce_exact(idx, 60)(v)
    ref = torch.zeros((60, 3, 2)).index_add_(0, idx, v)
    ref64 = torch.zeros((60, 3, 2), dtype=torch.float64).index_add_(
        0, idx, v.double())
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=1e-5)
    assert float(got[7].abs().max()) == float(got[55:].abs().max()) == 0.0
    small = torch.ones(60, dtype=torch.bool)
    small[3] = False
    err = (got.double() - ref64)[small].abs().max()
    assert float(err) < 1e-5, err
    assert float((tba._sorted_seg_reduce(idx, 60)(v).double()
                  - ref64)[small].abs().max()) > 1e-3


def test_segment_sums_match_index_add(rng):
    """The sorted-cumsum and one-hot reductions compute the segment sum
    (index_add_ as the plain check), with empty segments reading 0."""
    idx = torch.from_numpy(rng.integers(0, 50, 700))
    idx[idx == 7] = 8                         # segment 7 empty
    v = torch.from_numpy(rng.normal(size=(700, 3, 2)).astype(np.float32))
    ref = torch.zeros((60, 3, 2)).index_add_(0, idx, v)
    torch.testing.assert_close(tba._sorted_seg_reduce(idx, 60)(v), ref,
                               atol=1e-4, rtol=0)
    torch.testing.assert_close(tba._onehot_seg_reduce(idx, 60)(v), ref,
                               atol=1e-4, rtol=0)
    assert float(tba._sorted_seg_reduce(idx, 60)(v)[7].abs().max()) == 0.0


@pytest.mark.parametrize("weight", ["huber_weight", "cauchy_weight",
                                    "tukey_weight"])
def test_robust_weights_match_jax(rng, weight):
    """The IRLS weights on chi2 values around and at the threshold, with a
    scalar and a per-row delta2: within 1 ulp (float32 division and square
    root, the same expression in both)."""
    from plvs_tpu.solvers import robust as jrob
    from plvs_tpu_torch.solvers import robust as trob

    chi2 = np.concatenate([rng.uniform(0, 20, 200), [0.0, 5.991, 7.815,
                                                     1e-14, 1e4]])
    chi2 = chi2.astype(np.float32)
    for delta2 in (5.991, rng.uniform(1, 10, chi2.shape).astype(np.float32)):
        want = np.asarray(getattr(jrob, weight)(
            jnp.asarray(chi2), delta2 if np.isscalar(delta2)
            else jnp.asarray(delta2)))
        got = getattr(trob, weight)(
            torch.from_numpy(chi2), delta2 if np.isscalar(delta2)
            else torch.from_numpy(delta2)).numpy()
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1.2e-7, atol=0)


def test_empty_lines_like_jax():
    from plvs_tpu.solvers import pose_opt as jpo
    from plvs_tpu_torch.solvers import pose_opt as tpo

    for j, t in zip(jpo.empty_lines(), tpo.empty_lines()):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype).split(".")[-1] == str(j.dtype)
    obs = tpo.make_pose_obs(torch.zeros((4, 3), dtype=torch.float64),
                            torch.zeros((4, 3)), torch.ones(4),
                            torch.ones(4, dtype=torch.bool))
    assert obs.line_Xs.shape == (0, 3) and obs.line_Xs.dtype == torch.float64
    assert obs.line_mask.dtype == torch.bool
