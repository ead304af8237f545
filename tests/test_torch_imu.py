"""The port's IMU preintegration and inertial initialization against the JAX
package's, on the same numpy inputs.

Preintegration: float32 windows of 2-40 samples at 300 Hz. dR, dV, dP and
the five bias Jacobians within 1e-6 absolute (the quantities are O(1e-1)
at most; the two frameworks round the 3x3 products of each step in another
order, and the difference grows with the sample count: 1.7e-7 measured at
40). The covariance, O(1e-6) here, within 1e-6 relative to its largest
entry (3.3e-7 measured at 40): it is a sum of many tiny products, in which
reordered rounding weighs relatively more.

Initialization: the same preintegrations (converted from JAX's) and the
same keyframe poses through ``inertial_only_optimize_padded`` in both
packages. Gravity within 1e-4 m/s^2, biases within 2e-5 and velocities
within 1e-5 m/s (2.4e-6, 2.4e-6 and 2.2e-7 measured): twenty Gauss-Newton
steps amplify last-bit differences of the Jacobians (``jacfwd`` against a
dual-number pass) through the weakly conditioned bias block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.imu import initialization as jinit
from plvs_tpu.imu import preintegration as jpre
from plvs_tpu_torch import convert
from plvs_tpu_torch.imu import initialization as tinit
from plvs_tpu_torch.imu import preintegration as tpre
from plvs_tpu_torch.io import synthetic as tsyn

JAC = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(rng, T):
    """A window of T samples at ~300 Hz (jittered), with gravity in the
    accelerometer and a small bias."""
    gyro = (rng.normal(size=(T, 3)) * 0.4).astype(np.float32)
    acc = (rng.normal(size=(T, 3)) * 0.5
           + np.array([0.3, 9.7, -0.4])).astype(np.float32)
    dts = (1.0 / 300.0 * (1.0 + 0.1 * rng.uniform(-1, 1, T))).astype(
        np.float32)
    bg = (rng.normal(size=3) * 0.01).astype(np.float32)
    ba = (rng.normal(size=3) * 0.05).astype(np.float32)
    return gyro, acc, dts, bg, ba


def _port(p):
    return {f: getattr(p, f).numpy() for f in tpre.Preintegrated._fields}


def _jax(p):
    return {f: np.asarray(getattr(p, f)) for f in jpre.Preintegrated._fields}


def _hold(tp, jp):
    for f in JAC + ("dT",):
        np.testing.assert_allclose(tp[f], jp[f], atol=1e-6, rtol=0, err_msg=f)
    scale = np.abs(jp["cov"]).max()
    np.testing.assert_allclose(tp["cov"], jp["cov"], atol=1e-6 * scale,
                               rtol=0)


@pytest.mark.parametrize("T", [2, 7, 13, 40])
def test_preintegrate_matches_jax(rng, T):
    gyro, acc, dts, bg, ba = _window(rng, T)
    jp = jpre.preintegrate(jnp.asarray(gyro), jnp.asarray(acc),
                           jnp.asarray(dts), jnp.asarray(bg),
                           jnp.asarray(ba))
    tp = tpre.preintegrate(torch.from_numpy(gyro), torch.from_numpy(acc),
                           torch.from_numpy(dts), bg, ba)
    _hold(_port(tp), _jax(jp))


@pytest.mark.parametrize("T", [3, 11, 33])
def test_masked_window_matches_the_padded_variant(rng, T):
    """The padded entry point of the JAX package (masked zero samples up to
    a power of two) against the port's unpadded window, and the port's
    masked window against its unpadded one exactly: a masked sample leaves
    the state untouched."""
    gyro, acc, dts, bg, ba = _window(rng, T)
    jp = jpre.preintegrate_padded(gyro, acc, dts, bg, ba)
    tp = tpre.preintegrate(torch.from_numpy(gyro), torch.from_numpy(acc),
                           torch.from_numpy(dts), bg, ba)
    _hold(_port(tp), _jax(jp))
    pad = 32 if T <= 32 else 64
    mask = torch.arange(pad) < T

    def padded(a):
        return torch.from_numpy(np.concatenate(
            [a, np.zeros((pad - T,) + a.shape[1:], np.float32)]))

    tm = tpre.preintegrate(padded(gyro), padded(acc), padded(dts), bg, ba,
                           mask=mask)
    for f in tpre.Preintegrated._fields:
        assert torch.equal(getattr(tm, f), getattr(tp, f)), f


def test_deltas_and_inertial_residual_match_jax(rng):
    gyro, acc, dts, bg, ba = _window(rng, 10)
    jp = jpre.preintegrate(*(jnp.asarray(a) for a in (gyro, acc, dts, bg,
                                                      ba)))
    tp = convert.preintegrated_from_numpy(_jax(jp), device="cpu")
    bg2 = bg + np.float32(0.003)
    ba2 = ba - np.float32(0.02)
    jd = jax.device_get(jpre.deltas_jit(jp, jnp.asarray(bg2),
                                        jnp.asarray(ba2)))
    td = tpre.deltas(tp, bg2, ba2)
    for a, b in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                   rtol=0)
    R1, R2 = (np.asarray(jax.numpy.linalg.qr(jnp.asarray(
        rng.normal(size=(3, 3)).astype(np.float32)))[0]) for _ in range(2))
    R1 = R1 * np.sign(np.linalg.det(R1))
    R2 = R2 * np.sign(np.linalg.det(R2))
    p1, v1, p2, v2 = (rng.normal(size=3).astype(np.float32)
                      for _ in range(4))
    g = np.array([0.3, 9.7, -0.4], np.float32)
    jr = np.asarray(jpre.inertial_residual(
        jp, *(jnp.asarray(a) for a in (R1, p1, v1, R2, p2, v2, bg2, ba2)),
        gravity=jnp.asarray(g)))
    tr = tpre.inertial_residual(
        tp, *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (R1, p1, v1, R2, p2, v2, bg2, ba2)),
        gravity=torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(tr, jr, atol=1e-5, rtol=0)


def _chain(n_kf, seed=2):
    """Keyframe body poses every 4 frames of the inertial sequence and the
    JAX preintegration of each keyframe gap (zero bias)."""
    frames = tsyn.inertial_sequence(n_frames=4 * n_kf, seed=seed)
    kf = frames[3::4]
    R_wb = np.stack([R.T for _, R, _, _ in kf]).astype(np.float32)
    p_wb = np.stack([-R.T @ t for _, R, t, _ in kf]).astype(np.float32)
    preints = []
    for i in range(1, n_kf):
        sel = [s for f in frames[4 * i:4 * i + 4] for s in f[3]]
        t0 = kf[i - 1][0]
        ts = np.asarray([s[0] for s in sel])
        preints.append(jpre.preintegrate_padded(
            np.stack([s[1] for s in sel]), np.stack([s[2] for s in sel]),
            np.diff(ts, prepend=t0).astype(np.float32),
            np.zeros(3, np.float32), np.zeros(3, np.float32)))
    return R_wb, p_wb, preints


@pytest.mark.parametrize("n_kf", [6, 11])
def test_inertial_only_optimize_matches_jax(n_kf):
    """A simulated keyframe chain (the chip run's motion, 6 and 11
    keyframes: bucket 8 with two composed rotation levels, bucket 16 with
    three) through both packages' padded entry points."""
    R_wb, p_wb, jpres = _chain(n_kf)
    jout = jinit.inertial_only_optimize_padded(R_wb, p_wb, jpres,
                                               fix_scale=True)
    tpres = [convert.preintegrated_from_numpy(_jax(p), device="cpu")
             for p in jpres]
    tout = tinit.inertial_only_optimize_padded(R_wb, p_wb, tpres,
                                               fix_scale=True)
    g_true = np.array([0.3, 9.7, -0.4], np.float32)
    g_true = g_true / np.linalg.norm(g_true) * 9.81
    jg = np.asarray(jout.gravity)
    # the estimate is a good one (so the comparison is of a solved problem)
    assert np.dot(jg, g_true) / (9.81 * np.linalg.norm(jg)) > 0.99
    np.testing.assert_allclose(tout.gravity.numpy(), jg, atol=1e-4, rtol=0)
    np.testing.assert_allclose(tout.bias_gyro.numpy(),
                               np.asarray(jout.bias_gyro), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tout.bias_acc.numpy(),
                               np.asarray(jout.bias_acc), atol=2e-5, rtol=0)
    np.testing.assert_allclose(tout.velocities.numpy()[:n_kf],
                               np.asarray(jout.velocities)[:n_kf],
                               atol=1e-5, rtol=0)
    assert float(tout.scale) == 1.0


def test_rotation_between_and_gravity_dirs_match_jax(rng):
    for a, b in [(rng.normal(size=3), rng.normal(size=3)),
                 (np.array([0, 0, -1.0]), np.array([0, 0, -1.0])),
                 (np.array([0, 0, -1.0]), np.array([0, 0, 1.0]))]:
        a = (a / np.linalg.norm(a)).astype(np.float32)
        b = (b / np.linalg.norm(b)).astype(np.float32)
        jR = np.asarray(jinit._rotation_between(jnp.asarray(a),
                                                jnp.asarray(b)))
        tR = tinit._rotation_between(torch.from_numpy(a),
                                     torch.from_numpy(b)).numpy()
        np.testing.assert_allclose(tR, jR, atol=1e-5, rtol=0)
    rxy = rng.normal(size=2).astype(np.float32) * 0.3
    R0 = tinit._rotation_between(torch.tensor([0.0, 0.0, -1.0]),
                                 torch.tensor([0.6, 0.0, -0.8]))
    np.testing.assert_allclose(
        tinit._gravity_from_dirs(torch.from_numpy(rxy), R0).numpy(),
        np.asarray(jinit._gravity_from_dirs(jnp.asarray(rxy),
                                            jnp.asarray(R0.numpy()))),
        atol=1e-5, rtol=0)
