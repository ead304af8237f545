"""The port's Lie-group and camera modules against the JAX package's, on
the same numpy inputs. Tolerance 1e-5 (absolute, values of order 1; pixel
outputs compared relative): float32 transcendental functions and sums
differ between the frameworks in the last few ulps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.geometry import lie as jlie
from plvs_tpu_torch import convert
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.geometry import lie as tlie

TOL = 1e-5


def _close(a, b, tol=TOL, rel=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=rel)


@pytest.fixture
def tangents(rng):
    w = rng.normal(size=(64, 3)).astype(np.float32) * 0.7
    w[:4] = [[0, 0, 0], [1e-8, 0, 0], [0, 3.0, 0], [0, 0, -3.1]]
    rho = rng.normal(size=(64, 3)).astype(np.float32)
    return w, rho


def test_so3_exp_log_hat(tangents):
    w, _ = tangents
    _close(tlie.hat(torch.from_numpy(w)), jlie.hat(jnp.asarray(w)))
    Rj = jlie.so3_exp(jnp.asarray(w))
    Rt = tlie.so3_exp(torch.from_numpy(w))
    _close(Rt, Rj)
    _close(tlie.so3_log(Rt), jlie.so3_log(Rj), tol=2e-5)


def test_se3_exp_log_compose_apply(tangents, rng):
    w, rho = tangents
    xi = np.concatenate([rho, w], -1)
    Rj, tj = jlie.se3_exp(jnp.asarray(xi))
    Rt, tt = tlie.se3_exp(torch.from_numpy(xi))
    _close(Rt, Rj)
    _close(tt, tj)
    _close(tlie.se3_log(Rt, tt), jlie.se3_log(Rj, tj), tol=5e-5)
    Ri, ti = tlie.se3_inverse(Rt, tt)
    Rij, tij = jlie.se3_inverse(Rj, tj)
    _close(Ri, Rij)
    _close(ti, tij)
    Rc, tc = tlie.se3_compose(Rt, tt, Ri, ti)
    _close(Rc, np.broadcast_to(np.eye(3), Rc.shape))
    _close(tc, np.zeros(tc.shape))
    p = rng.normal(size=(50, 3)).astype(np.float32)
    _close(tlie.se3_apply(Rt[5], tt[5], torch.from_numpy(p)),
           jlie.se3_apply(Rj[5], tj[5], jnp.asarray(p)))


def test_quaternions_and_normalize(tangents):
    w, _ = tangents
    R = jlie.so3_exp(jnp.asarray(w))
    q_j = jlie.rotmat_to_quat(R)
    q_t = tlie.rotmat_to_quat(torch.from_numpy(np.array(R)))
    _close(q_t, q_j)
    _close(tlie.quat_to_rotmat(q_t), jlie.quat_to_rotmat(q_j))
    noisy = np.asarray(R) + 1e-3
    _close(tlie.normalize_rotation(torch.from_numpy(noisy)),
           jlie.normalize_rotation(jnp.asarray(noisy)))


def _cams():
    pin = dict(fx=420.0, fy=415.0, cx=321.0, cy=239.0, width=640, height=480,
               bf=40.0)
    return [
        (jcam.pinhole(**pin), tcam.pinhole(**pin)),
        (jcam.pinhole(dist=(-0.28, 0.07, 1e-3, -5e-4, 0.01), **pin),
         tcam.pinhole(dist=(-0.28, 0.07, 1e-3, -5e-4, 0.01), **pin)),
        (jcam.kannala_brandt8(190.0, 190.0, 254.0, 256.0, -0.01, 0.02,
                              -0.015, 0.003, width=512, height=512),
         tcam.kannala_brandt8(190.0, 190.0, 254.0, 256.0, -0.01, 0.02,
                              -0.015, 0.003, width=512, height=512)),
    ]


@pytest.mark.parametrize("ci", [0, 1, 2])
def test_camera_project_jac_unproject(rng, ci):
    jc, tc = _cams()[ci]
    X = np.stack([rng.uniform(-1.5, 1.5, 200), rng.uniform(-1.0, 1.0, 200),
                  rng.uniform(0.5, 4.0, 200)], -1).astype(np.float32)
    uv_j = np.asarray(jcam.project(jc, jnp.asarray(X)))
    uv_t = tcam.project(tc, torch.from_numpy(X))
    _close(uv_t, uv_j, tol=TOL, rel=TOL)
    _close(tcam.project_jac(tc, torch.from_numpy(X)),
           jcam.project_jac(jc, jnp.asarray(X)), tol=TOL, rel=TOL)
    # unproject at the projected pixels (incl. the iterative KB8 inversion)
    uv = uv_j.astype(np.float32)
    r_j = np.asarray(jcam.unproject(jc, jnp.asarray(uv)))
    r_t = tcam.unproject(tc, torch.from_numpy(uv))
    _close(r_t, r_j, tol=TOL, rel=TOL)
    d = X[:, 2]
    _close(tcam.backproject(tc, torch.from_numpy(uv), torch.from_numpy(d)),
           jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(d)),
           tol=TOL, rel=TOL)
    np.testing.assert_array_equal(
        tcam.in_image(tc, torch.from_numpy(uv), 8.0).numpy(),
        np.asarray(jcam.in_image(jc, jnp.asarray(uv), 8.0)))


def test_camera_from_numpy():
    jc = _cams()[2][0]
    tc = convert.camera_from_numpy(jc.kind, jc.params, jc.width, jc.height,
                                   jc.bf)
    assert tc == _cams()[2][1]
    assert tc.fx == jc.fx and tc.cy == jc.cy
    _close(tc.K, jc.K)
