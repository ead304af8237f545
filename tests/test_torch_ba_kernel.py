"""The bundle adjustment's CUDA kernel (``csrc/ba_lm.cu``) and its dispatch.

The CPU tests run everywhere: CPU tensors take the plain eager solve, the
formulations that are not the local BA's keep their eager paths on CUDA,
the counters add up, the wrapper's argument checks raise without a launch,
and the wrapper's row order, summed over its runs, gives the segment sums
of ``index_add_``. The ``cuda``-marked tests hold the kernel against the
plain solve on the card and skip without one. This file imports nothing of
jax or plvs_tpu:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_ba_kernel.py -q

The reference on the card is ``bundle_adjust_plain`` in float64 on the CPU.
In float32 the plain solve's cumulative-sum segment sums carry about eps x
the global sum (ba._sorted_seg_reduce), while the kernel's fixed-order sums
carry eps x each block's own: on a 6-camera stereo window the plain solve
in float32 read points 9.7e-4 m off the float64 one, the kernel 2.5e-5
(the kernel's source compiled for the CPU). So poses and points within
1e-4, line endpoints within 1e-3 and the cost within 1e-3 relative of the
float64 solve (tests/test_torch_cuda.py's tolerances), and ``lam`` equal,
which shows that every accept / reject decision matched. The windows start
five times the generator's default offsets off (``jitter=5``): every LM
step's gain then reads >= 1.5e-5 relative in float64, so no accept or stop
decision compares cost changes of float32 noise size (at ``jitter=1`` a
window's fifth step gains 2.4e-7, and the float32 plain solve rejected it
where the float64 one accepted it). The 64-camera window runs the global
BA's 10 LM x 30 CG and keeps only points seen 3+ times (``min_obs=3``):
with points seen twice by neighbouring cameras those points are float32
noise after 300 CG iterations (the kernel read one 7.3e-4 off float64,
the float32 plain solve 3.4e-2; with ``min_obs=3`` 9.7e-6 and 4.1e-4).
The cameras stand 0.3 m apart in rows of 8: along one 3 m track (0.1 m
apart at 32 cameras) the kernel's points passed 1e-4 on the card.
"""

import numpy as np
import pytest
import torch

from plvs_tpu_torch.geometry import cameras
from plvs_tpu_torch.io import synthetic
from plvs_tpu_torch.solvers import ba


def _f64(prob: ba.BAProblem) -> ba.BAProblem:
    return ba.BAProblem(*(x.cpu().double() if x.is_floating_point()
                          else x.cpu() for x in prob))


# -- on the CPU --------------------------------------------------------------

def test_cpu_tensors_take_the_plain_solve():
    cam, prob = synthetic.ba_problem(1, lines=8)
    k0, s0 = ba.kernel_solves, ba.solves
    got = ba.bundle_adjust(cam, prob, num_iters=3, cg_iters=6)
    ref = ba.bundle_adjust_plain(cam, prob, num_iters=3, cg_iters=6)
    assert ba.kernel_solves == k0
    assert ba.solves == s0 + 2
    for a, b in zip(got[:5], ref[:5]):
        assert torch.equal(a, b)
    for k in ref[5]:
        assert torch.equal(got[5][k], ref[5][k]), k


class _OnCuda:
    """Stands in for a CUDA tensor where only its device is read."""
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("kw", [dict(schur_direct=True),
                                dict(scatter_free=False),
                                dict(scatter_free=False, schur_direct=True)])
def test_other_formulations_stay_eager_on_cuda(monkeypatch, kw):
    """The choice reads the call's arguments alone: on a CUDA problem the
    formulations that are not the local BA's take the plain solve."""
    cam, prob = synthetic.ba_problem(2)
    prob = prob._replace(R=_OnCuda())
    calls = []
    monkeypatch.setattr(ba, "bundle_adjust_plain",
                        lambda *a, **k: calls.append("plain"))
    monkeypatch.setattr(ba, "_bundle_adjust_kernel",
                        lambda *a, **k: calls.append("kernel"))
    ba.bundle_adjust(cam, prob, **kw)
    ba.bundle_adjust(cam, prob)
    assert calls == ["plain", "kernel"]


def test_sharded_hook_stays_eager():
    """``_bundle_adjust(obs=...)`` (parallel/sharded_ba.py's entry) is the
    plain solve whatever the device: it counts as a solve, launches nothing,
    and with the unsharded reductions gives the plain result."""
    cam, prob = synthetic.ba_problem(3)
    red = ba._reductions(prob, True)
    k0, s0 = ba.kernel_solves, ba.solves
    got = ba._bundle_adjust(cam, prob, 2, 5, 1e-3, 1.0, True, False,
                            obs=(red.seg_c, red.seg_p, red.gather_p,
                                 red.total))
    ref = ba.bundle_adjust_plain(cam, prob, 2, 5)
    assert ba.kernel_solves == k0 and ba.solves == s0 + 2
    for a, b in zip(got[:5], ref[:5]):
        assert torch.equal(a, b)


def test_iteration_count_adds_the_plain_solves_iterations():
    cam, prob = synthetic.ba_problem(4)
    lm0, cg0 = ba.iteration_count()
    info = ba.bundle_adjust(cam, prob, num_iters=3, cg_iters=7)[5]
    lm1, cg1 = ba.iteration_count()
    assert (lm1 - lm0, cg1 - cg0) == (int(info["lm_iters"]),
                                      int(info["cg_iters"]))
    assert lm1 - lm0 == 3 and 0 < cg1 - cg0 <= 21


def _bad_problem(case):
    """A problem with one field made wrong in the way ``case`` names."""
    cam, prob = synthetic.ba_problem(5, lines=6)
    meta = torch.device("meta")
    bad = {"float64_points": dict(points=prob.points.double()),
           "float_mask": dict(obs_mask=prob.obs_mask.float()),
           "int32_index": dict(obs_pt=prob.obs_pt.int()),
           "points_shape": dict(points=prob.points[:, :2]),
           "rows_differ": dict(obs_inv_sigma2=prob.obs_inv_sigma2[:-1]),
           "line_rows_differ": dict(lobs_depth=prob.lobs_depth[:-1]),
           "cams_differ": dict(fixed_cam=prob.fixed_cam[:-1]),
           "device_mix": dict(t=prob.t.to(meta))}
    if case == "camera_kind":
        return cameras.Camera(7, cam.params, bf=cam.bf), prob
    return cam, prob._replace(**bad[case])


@pytest.mark.parametrize("case", [
    "float64_points", "float_mask", "int32_index", "points_shape",
    "rows_differ", "line_rows_differ", "cams_differ", "device_mix",
    "camera_kind"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    cam, prob = _bad_problem(case)
    k0 = ba.kernel_solves
    with pytest.raises(ValueError):
        ba._check(cam, prob)
    assert ba.kernel_solves == k0


@pytest.mark.parametrize("kw", [dict(), dict(lines=10), dict(padded=True),
                                dict(kb8=True)])
def test_kernel_wrapper_takes_a_well_formed_problem(kw):
    ba._check(*synthetic.ba_problem(6, **kw))


def test_a_device_that_is_neither_cpu_nor_cuda_raises():
    cam, prob = synthetic.ba_problem(7)
    meta = ba.BAProblem(*(x.to("meta") for x in prob))
    with pytest.raises(ValueError):
        ba.bundle_adjust(cam, meta)


@pytest.mark.parametrize("seed, kw", [
    (8, dict()), (9, dict(lines=12)), (10, dict(padded=True)),
    (11, dict(cams=17, points=500, lines=20, fixed=8))])
def test_row_order_sums_like_index_add(seed, kw):
    """Each key's run of the wrapper's order, summed in order in Python,
    equals ``index_add_`` (which adds the rows in order on the CPU): the
    point rows by point and by camera, the line rows by line and by
    camera; empty runs read 0 and the runs cover every row once."""
    _, prob = synthetic.ba_problem(seed, **kw)
    K, P, L = prob.R.shape[0], prob.points.shape[0], prob.lines_Xs.shape[0]
    M, Ml = prob.obs_cam.shape[0], prob.lobs_cam.shape[0]
    order, off = ba._row_order(prob)
    assert order.dtype == off.dtype == torch.int64
    assert off.shape == (P + 2 * K + L + 1,)
    assert int(off[0]) == 0 and int(off[-1]) == 2 * M + 2 * Ml
    assert torch.equal(torch.sort(order).values, torch.arange(2 * M + 2 * Ml))
    rng = np.random.default_rng(seed)
    v = torch.from_numpy(rng.normal(size=(M, 6)).astype(np.float32))
    lv = torch.from_numpy(rng.normal(size=(Ml, 6)).astype(np.float32))
    segments = ((0, P, prob.obs_pt, v, 0), (P, K, prob.obs_cam, v, M),
                (P + K, L, prob.lobs_line, lv, 2 * M),
                (P + K + L, K, prob.lobs_cam, lv, 2 * M + Ml))
    for base, n, idx, vals, row0 in segments:
        got = torch.zeros((n, 6))
        for k in range(n):
            for j in order[int(off[base + k]):int(off[base + k + 1])]:
                got[k] += vals[int(j) - row0]
        assert torch.equal(got, ba._index_add_reduce(idx, n)(vals)), base


# -- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# name: (seed, synthetic.ba_problem keywords, (LM, CG iterations), line
# weight); every window at jitter 5 (module docstring)
CARD_CASES = {
    "stereo": (21, dict(), (5, 14), 1.0),
    "mono": (22, dict(stereo=0.0), (5, 14), 1.0),
    "mixed_outliers": (23, dict(stereo=0.5, outliers=0.05), (5, 14), 1.0),
    "lines": (24, dict(lines=40), (5, 14), 1.0),
    "lines_mono_weighted": (25, dict(lines=30, stereo=0.3), (5, 14), 0.5),
    "padded": (26, dict(padded=True), (5, 14), 1.0),
    "padded_lines": (27, dict(padded=True, lines=20), (5, 14), 1.0),
    "three_cameras": (28, dict(cams=3, points=200, fixed=1), (5, 14), 1.0),
    "local_window": (29, dict(cams=17, points=1500, lines=30, fixed=8),
                     (5, 14), 1.0),
    "kb8": (30, dict(kb8=True, stereo=0.5), (5, 14), 1.0),
    "thirty_two_cameras": (31, dict(cams=32, points=2000, stereo=0.5),
                           (5, 14), 1.0),
    "global_64_cameras": (32, dict(cams=64, points=3000, stereo=0.7,
                                   fixed=1, min_obs=3), (10, 30), 1.0),
}


def _card_case(name, dev):
    seed, kw, (it, cg), lw = CARD_CASES[name]
    cam, prob = synthetic.ba_problem(seed, jitter=5.0, **kw)
    return cam, ba.BAProblem(*(x.to(dev) for x in prob)), dict(
        num_iters=it, cg_iters=cg, line_weight=lw)


def _hold(got, ref, name):
    for a, b, tol, what in zip(got[:5], ref[:5],
                               (1e-4, 1e-4, 1e-4, 1e-3, 1e-3),
                               ("R", "t", "points", "lines_Xs", "lines_Xe")):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        if a.numel():
            err = float((a.cpu().double() - b).abs().max())
            assert err <= tol, (name, what, err)
    gi, ri = got[5], ref[5]
    assert float(gi["lam"]) == pytest.approx(float(ri["lam"]), rel=1e-6), (
        name, float(gi["lam"]), float(ri["lam"]))
    assert abs(float(gi["cost"]) - float(ri["cost"])) <= 1e-3 * float(
        ri["cost"]), (name, float(gi["cost"]), float(ri["cost"]))
    assert gi["lm_iters"].dtype == gi["cg_iters"].dtype == torch.int32


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_matches_the_plain_solve_on_the_card(dev, name):
    cam, prob, kw = _card_case(name, dev)
    k0, it0 = ba.kernel_solves, ba.iteration_count()
    got = ba.bundle_adjust(cam, prob, **kw)
    torch.cuda.synchronize()
    assert ba.kernel_solves == k0 + 1
    it1 = ba.iteration_count()
    assert (it1[0] - it0[0], it1[1] - it0[1]) == (
        int(got[5]["lm_iters"]), int(got[5]["cg_iters"]))
    ref = ba.bundle_adjust_plain(cam, _f64(prob), **kw)
    _hold(got, ref, name)
    assert float(got[5]["cost"]) < float(got[5]["cost0"]), name


@pytest.mark.cuda
def test_kernel_on_a_window_with_every_row_invalid(dev):
    """Every row masked: the cost is infinite, every step is rejected and
    the blocks come back as they went in, as in the plain solve."""
    cam, prob, kw = _card_case("padded_lines", dev)
    prob = prob._replace(obs_mask=torch.zeros_like(prob.obs_mask),
                         lobs_mask=torch.zeros_like(prob.lobs_mask))
    got = ba.bundle_adjust(cam, prob, **kw)
    ref = ba.bundle_adjust_plain(cam, prob, **kw)
    assert np.isinf(float(got[5]["cost0"])) and np.isinf(
        float(got[5]["cost"]))
    assert float(got[5]["lam"]) == float(ref[5]["lam"])
    assert int(got[5]["lm_iters"]) == kw["num_iters"]
    for a, b in zip(got[:5], (prob.R, prob.t, prob.points, prob.lines_Xs,
                              prob.lines_Xe)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_on_a_degenerate_window(dev):
    """tests/test_torch_ba.py's degenerate window: one landmark seen once
    by the one free camera (its point block is rank 2). The inverses give
    no error, and the blocks agree with the float64 plain solve to 2e-4
    (they slide along the null space by float32 noise). In float32 the cost
    reaches exactly zero at the third step and every later step is
    rejected (float64 never reaches zero and accepts all five), so lam is
    held to the float32 plain solve's: the kernel's equalled it at every
    step on the CPU rehearsal."""
    f = dict(R=torch.eye(3).repeat(2, 1, 1),
             t=torch.tensor([[0.0, 0.0, 0.0], [-0.3, 0.0, 0.0]]),
             fixed_cam=torch.tensor([True, False]),
             points=torch.tensor([[0.1, 0.2, 3.0]]),
             obs_cam=torch.tensor([1]), obs_pt=torch.tensor([0]),
             obs_uvr=torch.tensor([[300.0, 280.0, -1.0]]),
             obs_inv_sigma2=torch.ones(1),
             obs_mask=torch.ones(1, dtype=torch.bool))
    cam = cameras.pinhole(520.0, 520.0, 320.0, 240.0, width=640, height=480,
                          bf=40.0)
    prob = ba.make_problem(**{k: v.to(dev) for k, v in f.items()})
    got = ba.bundle_adjust(cam, prob, num_iters=5, cg_iters=14)
    ref = ba.bundle_adjust_plain(cam, _f64(prob), num_iters=5, cg_iters=14)
    ref32 = ba.bundle_adjust_plain(cam, ba.BAProblem(*(x.cpu() for x in prob)),
                                   num_iters=5, cg_iters=14)
    assert float(got[5]["cost"]) == float(ref32[5]["cost"]) == 0.0
    assert float(got[5]["lam"]) == float(ref32[5]["lam"])
    for a, b in zip(got[:3], ref[:3]):
        assert float((a.cpu().double() - b).abs().max()) <= 2e-4


@pytest.mark.cuda
def test_kernel_is_deterministic(dev):
    cam, prob, kw = _card_case("local_window", dev)
    a = ba.bundle_adjust(cam, prob, **kw)
    b = ba.bundle_adjust(cam, prob, **kw)
    for x, y in zip(a[:5], b[:5]):
        assert torch.equal(x, y)
    for k in a[5]:
        assert torch.equal(a[5][k], b[5][k]), k


@pytest.mark.cuda
def test_kernel_solve_reads_nothing_back(dev):
    cam, prob, kw = _card_case("lines", dev)
    ba.bundle_adjust(cam, prob, **kw)  # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = ba.bundle_adjust(cam, prob, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out[0]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64", "device_mix"])
def test_cuda_tensors_of_another_kind_raise(dev, case):
    cam, prob, _ = _card_case("stereo", dev)
    if case == "float64":
        prob = prob._replace(points=prob.points.double())
    else:
        prob = prob._replace(t=prob.t.cpu())
    k0 = ba.kernel_solves
    with pytest.raises(ValueError):
        ba.bundle_adjust(cam, prob)
    assert ba.kernel_solves == k0
