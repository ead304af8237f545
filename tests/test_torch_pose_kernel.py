"""The pose solve's CUDA kernel (``csrc/pose_opt.cu``) and its dispatch.

The CPU tests run everywhere: CPU tensors take the plain eager loop and
leave the kernel's counter alone, the iteration count adds up, the
benchmark's ``pose_unchanged`` fault still wraps the dispatching
``pose_optimize``, and the wrapper's argument checks raise without a
launch. The ``cuda``-marked tests hold the kernel against
``pose_optimize_plain`` on the card and skip without one. This file
imports nothing of jax or plvs_tpu:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_pose_kernel.py -q

The kernel and the plain loop compute the same float32 sums in another
order (a block reduction against PyTorch's einsum and LAPACK's or
cuSOLVER's LU), so they agree to float32 rounding, amplified by the
iterations, and not bit for bit: R and t within ``POSE_TOL``. A row whose
chi2 lies within ``CHI2_BAND`` of its threshold at the final pose may land
on either side of it.
"""

import pytest
import torch

from plvs_tpu_torch.geometry import cameras
from plvs_tpu_torch.io import synthetic
from plvs_tpu_torch.solvers import pose_opt, robust

# largest |R - R_plain| entry, and |t - t_plain| over max(1, |t_plain|):
# float32 rounding in another order, carried through 40 iterations (the
# kernel's source compiled for the CPU read at most 6e-8 and 4.8e-7 m at
# |t| = 11 m on CARD_CASES)
POSE_TOL = 1e-5
# share of a row's chi2 threshold within which its in/outlier call may
# differ between the two (the same sums in another order move chi2 by far
# less; a flipped row moves the pose by ~1e-6 m)
CHI2_BAND = 1e-3


def chi2_at(cam, R, t, obs):
    """Each point and line row's chi2 and threshold at (R, t), as the
    rounds re-classify them."""
    res, _, _, is_stereo = pose_opt._point_residual_jac(cam, R, t, obs)
    chi2 = (res * res).sum(-1) * obs.inv_sigma2
    thr = torch.where(is_stereo, robust.CHI2_3D, robust.CHI2_2D)
    lres, _, _ = pose_opt._line_residual_jac(cam, R, t, obs)
    lchi2 = (lres * lres).sum(-1) * obs.line_inv_sigma2
    return chi2, thr, lchi2, torch.full_like(lchi2, robust.CHI2_2D)


# -- on the CPU --------------------------------------------------------------

def test_cpu_tensors_take_the_plain_loop():
    cam, R0, t0, obs, _ = synthetic.pose_problem(1, 200, 20)
    k0, s0 = pose_opt.kernel_solves, pose_opt.solves
    got = pose_opt.pose_optimize(cam, R0, t0, obs)
    ref = pose_opt.pose_optimize_plain(cam, R0, t0, obs)
    assert pose_opt.kernel_solves == k0
    assert pose_opt.solves == s0 + 2
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_iteration_count_on_the_cpu_is_the_plain_count():
    cam, R0, t0, obs, pri = synthetic.pose_problem(2, 100, prior=True)
    it0, n0 = pose_opt.iterations, pose_opt.iteration_count()
    pose_opt.pose_optimize(cam, R0, t0, obs, **pri)
    assert pose_opt.iteration_count() == pose_opt.iterations
    assert pose_opt.iteration_count() - n0 == pose_opt.iterations - it0 > 0


def test_pose_unchanged_fault_wraps_the_dispatching_solve():
    from slam_bench import faults

    cam, R0, t0, obs, _ = synthetic.pose_problem(3, 100)
    orig = pose_opt.pose_optimize
    fault = faults.PoseUnchanged()
    fault.install()
    try:
        assert pose_opt.pose_optimize is not orig
        R, t, in_pts, _, n = pose_opt.pose_optimize(cam, R0, t0, obs)
        assert R is R0 and t is t0
        ref = orig(cam, R0, t0, obs)
        assert torch.equal(in_pts, ref[2]) and int(n) == int(ref[4])
    finally:
        fault.remove()
    assert pose_opt.pose_optimize is orig


def _bad_args(case):
    """The problem with one argument made wrong in the way ``case`` names."""
    cam, R0, t0, obs, pri = synthetic.pose_problem(4, 16, 4, prior=True)
    meta = torch.device("meta")
    if case == "float64_pose":
        R0 = R0.double()
    elif case == "float64_points":
        obs = obs._replace(Xw=obs.Xw.double())
    elif case == "float_mask":
        obs = obs._replace(mask=obs.mask.float())
    elif case == "points_shape":
        obs = obs._replace(uvr=obs.uvr[:, :2])
    elif case == "rows_differ":
        obs = obs._replace(inv_sigma2=obs.inv_sigma2[:-1])
    elif case == "lines_shape":
        obs = obs._replace(line_nld=obs.line_nld[:, :2])
    elif case == "prior_shape":
        pri["prior_info"] = pri["prior_info"][:3, :3]
    elif case == "prior_partial":
        pri.pop("prior_t")
    elif case == "device_mix":
        t0 = t0.to(meta)
    elif case == "camera_kind":
        cam = cameras.Camera(7, cam.params, bf=cam.bf)
    return cam, R0, t0, obs, pri


@pytest.mark.parametrize("case", [
    "float64_pose", "float64_points", "float_mask", "points_shape",
    "rows_differ", "lines_shape", "prior_shape", "prior_partial",
    "device_mix", "camera_kind"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    cam, R0, t0, obs, pri = _bad_args(case)
    k0 = pose_opt.kernel_solves
    with pytest.raises(ValueError):
        pose_opt._check(cam, R0, t0, obs, pri.get("prior_R"),
                        pri.get("prior_t"), pri.get("prior_info"))
    assert pose_opt.kernel_solves == k0


@pytest.mark.parametrize("lines, prior", [(0, "none"), (8, "full"),
                                          (8, "pose_without_info")])
def test_kernel_wrapper_takes_a_well_formed_problem(lines, prior):
    # the tracker's local-map solve passes the prior's pose without its
    # information: both versions ignore it
    cam, R0, t0, obs, pri = synthetic.pose_problem(5, 32, lines,
                                                   prior=prior != "none")
    if prior == "pose_without_info":
        pri.pop("prior_info")
    pose_opt._check(cam, R0, t0, obs, pri.get("prior_R"),
                    pri.get("prior_t"), pri.get("prior_info"))


def test_a_device_that_is_neither_cpu_nor_cuda_raises():
    cam, R0, t0, obs, _ = synthetic.pose_problem(6, 8)
    meta = pose_opt.PoseObs(*(x.to("meta") for x in obs))
    with pytest.raises(ValueError):
        pose_opt.pose_optimize(cam, R0.to("meta"), t0.to("meta"), meta)


# -- on the card -------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (seed, points, lines, KB8 camera, prior, outlier share, masked share)
CARD_CASES = {
    "points_1000": (11, 1000, 0, False, False, 0.2, 0.1),
    "points_lines_1000_100": (12, 1000, 100, False, False, 0.2, 0.1),
    "points_lines_4096_unstaged": (13, 4096, 160, False, False, 0.2, 0.1),
    "prior_points_lines": (14, 1000, 100, False, True, 0.2, 0.1),
    "mono_only": (15, 1000, 0, False, False, 0.2, 0.1),
    "kb8_points_lines": (16, 1000, 100, True, False, 0.2, 0.1),
    "kb8_prior": (17, 600, 40, True, True, 0.2, 0.1),
    "one_point_prior": (18, 1, 0, False, True, 0.0, 0.0),
    "no_rows": (19, 0, 0, False, False, 0.0, 0.0),
    "no_rows_prior": (20, 0, 0, False, True, 0.0, 0.0),
    "all_masked": (21, 500, 50, False, False, 0.2, 1.0),
    "clean": (22, 1000, 100, False, False, 0.0, 0.0),
}
# The exit (|dx|^2 < 1e-16) compares a converged step, which is float32
# rounding, with a fixed number, so the two versions take the same
# iterations only where that rounding stays clear of it: the problems'
# converged steps read |dx|^2 >= 1e-15 on the CPU (synthetic.pose_problem
# keeps the camera ~5 m from the origin). With the camera near the origin
# they read 2e-16 and the card's two versions stopped KB8 solves at 35 and
# 40 iterations. A prior alone is reached in one step, and each round's
# next step is rounding of log(T T_prior^-1), ~2e-17 to 1.1e-16: a round
# may stop one iteration later on either side.
EXIT_AT_ROUNDING = {"no_rows_prior"}


def _card_problem(name, dev):
    seed, n, nl, kb8, prior, out, masked = CARD_CASES[name]
    return synthetic.pose_problem(seed, n, nl, kb8=kb8, prior=prior,
                                  outliers=out, masked=masked,
                                  stereo=0.0 if name == "mono_only" else 0.5,
                                  device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_kernel_matches_the_plain_loop_on_the_card(dev, name):
    cam, R0, t0, obs, pri = _card_problem(name, dev)
    it0, k0 = pose_opt.iteration_count(), pose_opt.kernel_solves
    R, t, in_pts, in_lines, num = pose_opt.pose_optimize(cam, R0, t0, obs,
                                                         **pri)
    torch.cuda.synchronize()
    it_kernel = pose_opt.iteration_count() - it0
    assert pose_opt.kernel_solves == k0 + 1
    it1 = pose_opt.iterations
    Rp, tp, in_p, in_l, num_p = pose_opt.pose_optimize_plain(cam, R0, t0,
                                                             obs, **pri)
    it_plain = pose_opt.iterations - it1
    if name in EXIT_AT_ROUNDING:
        assert abs(it_kernel - it_plain) <= 4, (it_kernel, it_plain)
    else:
        assert it_kernel == it_plain, (it_kernel, it_plain)
    assert float((R - Rp).abs().max()) <= POSE_TOL, name
    assert float((t - tp).abs().max()) <= POSE_TOL * max(
        1.0, float(tp.norm())), name
    chi2, thr, lchi2, lthr = chi2_at(cam, Rp, tp, obs)
    near = (chi2 - thr).abs() <= CHI2_BAND * thr
    lnear = (lchi2 - lthr).abs() <= CHI2_BAND * lthr
    assert not bool(((in_pts != in_p) & ~near).any()), name
    assert not bool(((in_lines != in_l) & ~lnear).any()), name
    assert in_pts.dtype == torch.bool and num.dtype == torch.int64
    assert abs(int(num) - int(num_p)) <= int(near.sum() + lnear.sum())
    assert int(num) == int(in_pts.sum() + in_lines.sum())


@pytest.mark.cuda
def test_kernel_solve_reads_nothing_back(dev):
    cam, R0, t0, obs, pri = _card_problem("prior_points_lines", dev)
    pose_opt.pose_optimize(cam, R0, t0, obs, **pri)  # builds and loads
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = pose_opt.pose_optimize(cam, R0, t0, obs, **pri)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out[0]).all()


@pytest.mark.cuda
def test_kernel_is_deterministic(dev):
    cam, R0, t0, obs, _ = _card_problem("points_lines_1000_100", dev)
    a = pose_opt.pose_optimize(cam, R0, t0, obs)
    b = pose_opt.pose_optimize(cam, R0, t0, obs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float64", "device_mix"])
def test_cuda_tensors_of_another_kind_raise(dev, case):
    cam, R0, t0, obs, _ = _card_problem("points_1000", dev)
    if case == "float64":
        obs = obs._replace(Xw=obs.Xw.double())
    else:
        R0 = R0.cpu()
    k0 = pose_opt.kernel_solves
    with pytest.raises(ValueError):
        pose_opt.pose_optimize(cam, R0, t0, obs)
    assert pose_opt.kernel_solves == k0
