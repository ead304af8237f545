"""The port's planar map objects against the JAX package's: the template,
the plane-homography RANSAC from JAX's own samples, the planar pose, the
Sim3 refinement, detection and refinement on one converted object store,
and the loop correction's move of an object.

The RANSAC draws with ``jax.random`` in JAX and from a ``torch.Generator``
in the port; each comparison recomputes JAX's samples from the key the
JAX function received (``ObjectStore`` splits ``PRNGKey(0)`` once per
detection) and hands them to the port (``*_from_samples``, or
``map_objects.draw_samples`` patched — a test-side hook). Inlier masks and
observation masks then agree exactly; poses carry the tolerances stated at
each check.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.features import orb as jorb
from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.slam import loop_closing as jloop
from plvs_tpu.slam import map_objects as jmo
from plvs_tpu.slam.map_store import MapStore as JStore
from plvs_tpu_torch import convert
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.slam import map_objects as tmo
from plvs_tpu_torch.slam.loop_closing import LoopCloser

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)
TCAM = tcam.pinhole(*CAM_ARGS, **CAM_KW)
JCAM = jcam.pinhole(*CAM_ARGS, **CAM_KW)
_JIT_EXTRACT = jax.jit(jorb.extract, static_argnames=("num_features",))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _plane_samples(key, valid, n_hyp=jmo.RANSAC_HYPOTHESES):
    """What jmo.ransac_plane_homography draws from ``key``
    (map_objects.py:129-135)."""
    n = valid.shape[0]
    probs = jnp.asarray(valid).astype(jnp.float32)
    probs = probs / jnp.maximum(probs.sum(), 1.0)
    return np.asarray(jax.vmap(lambda k: jax.random.choice(
        k, n, (4,), replace=False, p=probs))(jax.random.split(key, n_hyp)))


def _rot(ax, ay):
    cx, sx, cy, sy = np.cos(ax), np.sin(ax), np.cos(ay), np.sin(ay)
    Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    return (Rx @ Ry).astype(np.float32)


@pytest.fixture(scope="module")
def template():
    """tests/test_objects_e2e.py's template: a 256 px crop at offset 20 of
    a wall texture, 256 / 220 m wide; both packages' templates, the JAX one
    extracted by its jitted ORB."""
    tex = tsyn.SyntheticRGBD(TCAM, wall_z=3.0, seed=1).tex
    img = np.asarray(tex[20:276, 20:276], np.float32)

    def jax_extractor(gray):
        k = _JIT_EXTRACT(jnp.asarray(gray, jnp.float32), num_features=512)
        m = np.asarray(k.mask)
        return np.asarray(k.xy)[m], np.asarray(k.desc)[m]

    jt = jmo.ObjectTemplate.from_image(img, 256 / 220.0,
                                       extractor=jax_extractor)
    tt = tmo.ObjectTemplate.from_image(img, 256 / 220.0, device="cpu")
    return jt, tt


def test_template_matches_jax(template):
    """The template's keypoints (the per-level ORB path at 512 features, 8
    levels) in the same order, plane coordinates and corners exact;
    descriptors at least 98% identical and within 2 bits
    (tests/test_torch_features.py's per-level bound; measured: all)."""
    jt, tt = template
    assert len(tt.desc) == len(jt.desc) > 200
    np.testing.assert_array_equal(tt.plane_xy, jt.plane_xy)
    np.testing.assert_array_equal(tt.corners, jt.corners)
    assert tt.desc.dtype == np.uint32
    x = np.unpackbits((tt.desc ^ jt.desc).view(np.uint8), axis=1).sum(1)
    assert (x == 0).mean() >= 0.98 and x.max() <= 2, np.bincount(
        x.astype(int))


def _plane_view(rng, plane_xy, R_co, t_co, noise_px=0.5, out_frac=0.3):
    """Normalized image coordinates of plane points seen at (R_co, t_co),
    with pixel noise (f = 300) and a fraction of outliers."""
    P = np.concatenate([plane_xy, np.zeros_like(plane_xy[:, :1])], -1)
    Xc = P @ R_co.T + t_co
    pn = Xc[:, :2] / Xc[:, 2:] + rng.normal(0, noise_px / 300.0,
                                            (len(P), 2))
    out = rng.random(len(P)) < out_frac
    pn[out] += rng.uniform(-0.3, 0.3, (out.sum(), 2))
    return pn.astype(np.float32), out


def test_plane_ransac_and_pose_from_jax_samples(template):
    """Same inlier mask exactly; H (normalized to H[2, 2] = 1 in both)
    within 1e-4 relative to its largest entry (1.3e-7 measured: the refit
    SVDs in float32); the planar pose from one H, R and t within 1e-4
    (measured equal)."""
    jt, _ = template
    rng = np.random.default_rng(4)
    R_co, t_co = _rot(0.2, -0.3), np.array([-0.5, -0.4, 2.5], np.float32)
    pn, out = _plane_view(rng, jt.plane_xy, R_co, t_co)
    valid = rng.random(len(pn)) < 0.8
    sigma2 = 1.0 / 300.0 ** 2
    key = jax.random.PRNGKey(3)
    jH, jinl, jn = jmo.ransac_plane_homography(
        jnp.asarray(jt.plane_xy), jnp.asarray(pn), jnp.asarray(valid),
        sigma2, key)
    tH, tinl, tn = tmo.ransac_plane_homography_from_samples(
        _t(jt.plane_xy), _t(pn), _t(valid), sigma2,
        _t(_plane_samples(key, valid)))
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tn) == int(jn) >= 0.9 * (valid & ~out).sum()
    jH = np.asarray(jH)
    np.testing.assert_allclose(tH.numpy(), jH, atol=1e-4 * np.abs(jH).max())
    jR, jtv = (np.asarray(a) for a in jmo.pose_from_plane_homography(
        jnp.asarray(jH)))
    tR, ttv = tmo.pose_from_plane_homography(torch.from_numpy(jH))
    np.testing.assert_allclose(tR.numpy(), jR, atol=1e-4)
    np.testing.assert_allclose(ttv.numpy(), jtv, atol=1e-4)
    np.testing.assert_allclose(tR.numpy(), R_co, atol=2e-2)
    np.testing.assert_allclose(ttv.numpy(), t_co, atol=5e-2)


def test_refine_object_sim3_matches_jax(template):
    """Three keyframes observe the object; from a pose 3 cm / 2 degrees and
    5% in scale off, both refinements land on the same Sim3: R within
    1e-4, t within 1e-4 m, s within 1e-4 (8 float32 Gauss-Newton steps;
    the port's Jacobian is forward-mode like jacfwd), the inlier count
    exact, and the truth recovered to 1 cm."""
    jt, _ = template
    rng = np.random.default_rng(6)
    R_wo, t_wo, s_wo = _rot(0.05, 0.1), np.array([0.1, 0.05, 3.0],
                                                  np.float32), 1.0
    P = np.concatenate([jt.plane_xy, np.zeros_like(jt.plane_xy[:, :1])], -1)
    Pw = s_wo * P @ R_wo.T + t_wo
    kf_R = np.stack([_rot(0, a) for a in (-0.1, 0.0, 0.12)])
    kf_t = np.array([[0.3, 0, 0], [0, 0.05, 0.1], [-0.4, 0, 0]], np.float32)
    Xc = np.einsum("kij,nj->kni", kf_R, Pw) + kf_t[:, None]
    uv = (300.0 * Xc[..., :2] / Xc[..., 2:] + [160.0, 120.0]
          + rng.normal(0, 0.5, Xc[..., :2].shape)).astype(np.float32)
    mask = rng.random(uv.shape[:2]) < 0.7
    R0 = (_rot(0.02, -0.02) @ R_wo).astype(np.float32)
    t0 = (t_wo + [0.02, -0.02, 0.01]).astype(np.float32)
    args = (jt.plane_xy, kf_R, kf_t)
    jR, jtt, js, jn = jmo.refine_object_sim3(
        jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(1.05, jnp.float32),
        *(jnp.asarray(a) for a in args), 300.0, 300.0, 160.0, 120.0,
        jnp.asarray(uv), jnp.asarray(mask))
    tR, ttt, ts, tn = tmo.refine_object_sim3(
        _t(R0), _t(t0), torch.tensor(1.05), *(_t(a) for a in args), 300.0,
        300.0, 160.0, 120.0, _t(uv), _t(mask))
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(ttt.numpy(), np.asarray(jtt), atol=1e-4)
    assert abs(float(ts) - float(js)) < 1e-4
    assert int(tn) == int(jn) > 0.9 * mask.sum()
    np.testing.assert_allclose(ttt.numpy(), t_wo, atol=1e-2)
    assert abs(float(ts) - s_wo) < 1e-2


def _store_standin(kf_R, kf_t):
    import types

    return types.SimpleNamespace(kf_mask=np.ones(len(kf_R), bool),
                                 kf_R=kf_R, kf_t=kf_t)


def test_detect_and_refine_on_a_converted_store(template):
    """One JAX ObjectStore and the port's converted from it detect the
    object in two keyframes (the template's points plus clutter, seen from
    two poses) with JAX's samples: the same detections, observation masks
    and inlier counts exactly, world poses within 1e-4; then both refine
    against the two keyframes: R, t within 1e-4, s within 1e-4."""
    jt, _ = template
    rng = np.random.default_rng(8)
    jstore = jmo.ObjectStore(JCAM)
    jstore.add_template(jt)
    tstore = convert.object_store_from_numpy(TCAM, jstore.objects,
                                             device="cpu")
    R_wo = _rot(0.0, 0.05)
    t_wo = np.array([-0.6, -0.5, 3.0], np.float32)
    P = np.concatenate([jt.plane_xy, np.zeros_like(jt.plane_xy[:, :1])], -1)
    Pw = P @ R_wo.T + t_wo
    poses = [(_rot(0, 0), np.zeros(3, np.float32)),
             (_rot(0.02, -0.05), np.array([0.2, 0.0, 0.05], np.float32))]
    key = jax.random.PRNGKey(0)
    replay = []
    for kf, (R_cw, t_cw) in enumerate(poses):
        Xc = Pw @ R_cw.T + t_cw
        uv = 300.0 * Xc[:, :2] / Xc[:, 2:] + [160.0, 120.0]
        uv += rng.normal(0, 0.5, uv.shape)
        n_clutter = 300
        kp_xy = np.concatenate([uv, rng.uniform([0, 0], [320, 240],
                                                (n_clutter, 2))])
        flip = (rng.integers(0, 2 ** 32, jt.desc.shape, dtype=np.uint64)
                & rng.integers(0, 2 ** 32, jt.desc.shape, dtype=np.uint64)
                & rng.integers(0, 2 ** 32, jt.desc.shape, dtype=np.uint64)
                & rng.integers(0, 2 ** 32, jt.desc.shape, dtype=np.uint64))
        desc = np.concatenate([
            jt.desc ^ flip.astype(np.uint32),
            rng.integers(0, 2 ** 32, (n_clutter, 8),
                         dtype=np.uint64).astype(np.uint32)])
        mask = rng.random(len(kp_xy)) < 0.95
        perm = rng.permutation(len(kp_xy))
        kp_xy, desc, mask = kp_xy[perm].astype(np.float32), desc[perm], \
            mask[perm]
        key, sub = jax.random.split(key)
        jhits = jstore.detect_in_frame(kp_xy, desc, mask, R_cw, t_cw,
                                       kf_id=kf)
        # JAX's samples of this detection, from its split key
        idx = np.asarray(jmo.matching.match_nn_ratio(
            jnp.asarray(jt.desc), jnp.asarray(desc),
            jnp.asarray(np.ones(len(jt.desc), bool)), jnp.asarray(mask),
            ratio=0.8)[0])
        ok = idx >= 0
        replay.append(_plane_samples(sub, ok))
        orig = tmo.draw_samples
        tmo.draw_samples = lambda valid, gen, n_hyp=512: torch.from_numpy(
            replay[-1]).long()
        try:
            thits = tstore.detect_in_frame(kp_xy, desc, mask, R_cw, t_cw,
                                           kf_id=kf)
        finally:
            tmo.draw_samples = orig
        assert thits == jhits == [0]
        jr, tr = jstore.objects[0], tstore.objects[0]
        assert tr.n_inliers == jr.n_inliers > 0.5 * len(jt.desc)
        np.testing.assert_array_equal(tr.obs[kf][1], jr.obs[kf][1])
        np.testing.assert_array_equal(tr.obs[kf][0], jr.obs[kf][0])
        np.testing.assert_allclose(tr.R_wo, jr.R_wo, atol=1e-4)
        np.testing.assert_allclose(tr.t_wo, jr.t_wo, atol=1e-4)
    st = _store_standin(np.stack([p[0] for p in poses]),
                        np.stack([p[1] for p in poses]))
    jstore.refine(st)
    tstore.refine(st)
    jr, tr = jstore.objects[0], tstore.objects[0]
    np.testing.assert_allclose(tr.R_wo, jr.R_wo, atol=1e-4)
    np.testing.assert_allclose(tr.t_wo, jr.t_wo, atol=1e-4)
    assert abs(tr.s_wo - jr.s_wo) < 1e-4
    np.testing.assert_allclose(tr.corners_world(), jr.corners_world(),
                               atol=1e-3)
    np.testing.assert_allclose(tr.t_wo, t_wo, atol=2e-2)


def test_loop_correction_moves_the_object():
    """Both loop closers correct one map holding two detected objects: the
    corrected keyframe poses agree, and each object moves (or, without an
    observation in the map, stays) alike in both packages."""
    rng = np.random.default_rng(1)
    js = JStore(max_kf=8, max_pts=64, n_kp=8)
    for k in range(4):
        assert js.alloc_kf() == k
        js.kf_mask[k] = True
        js.kf_R[k] = _rot(0.0, 0.05 * k)
        js.kf_t[k] = np.array([-0.2 * k, 0.0, 0.0], np.float32)
    st = convert.map_store_from_numpy(
        {k: copy.deepcopy(v) for k, v in vars(js).items() if k != "lock"})
    tpl = dict(plane_xy=rng.normal(size=(4, 2)).astype(np.float32),
               desc=np.zeros((4, 8), np.uint32),
               corners=np.zeros((4, 2), np.float32))
    objs = [dict(template=tpl, R_wo=_rot(0.1, 0.0),
                 t_wo=np.array([0.0, 0.0, 3.0], np.float32), detected=True,
                 obs={1: (np.zeros((4, 2)), np.ones(4, bool)),
                      2: (np.zeros((4, 2)), np.ones(4, bool))}),
            dict(template=tpl, R_wo=np.eye(3, dtype=np.float32),
                 t_wo=np.ones(3, np.float32), detected=True, obs={7: (
                     np.zeros((4, 2)), np.ones(4, bool))})]
    jostore = jmo.ObjectStore(JCAM)
    for o in objs:
        rec = jmo.ObjectRecord(template=jmo.ObjectTemplate(**o["template"]),
                               R_wo=o["R_wo"].copy(), t_wo=o["t_wo"].copy(),
                               detected=o["detected"], obs=dict(o["obs"]))
        jostore.objects.append(rec)
    ostore = convert.object_store_from_numpy(TCAM, jostore.objects,
                                             device="cpu")
    jlc = jloop.LoopCloser(js, cam=JCAM)
    jlc.object_store = jostore
    lc = LoopCloser(st, cam=TCAM, device="cpu")
    lc.object_store = ostore
    t0 = ostore.objects[0].t_wo.copy()
    R_rel = np.eye(3, dtype=np.float32)
    t_rel = np.array([0.25, 0.0, 0.0], np.float32)
    jlc._correct(3, 0, R_rel, t_rel, fuse_pairs=[])
    lc._correct(3, 0, R_rel, t_rel, fuse_pairs=[])
    # both packages solve the pose graph in float32 with their own
    # linear algebra: measured gaps 6e-7 in R and 7.8e-6 m in t (the
    # object inherits its anchor keyframe's); 5e-5 bounds that rounding
    np.testing.assert_allclose(st.kf_R[:4], js.kf_R[:4], atol=5e-5)
    np.testing.assert_allclose(st.kf_t[:4], js.kf_t[:4], atol=5e-5)
    assert np.abs(js.kf_t[3] - [-0.6, 0.0, 0.0]).max() > 1e-3
    for trec, jrec in zip(ostore.objects, jostore.objects):
        np.testing.assert_allclose(trec.R_wo, jrec.R_wo, atol=5e-5)
        np.testing.assert_allclose(trec.t_wo, jrec.t_wo, atol=5e-5)
    assert np.linalg.norm(ostore.objects[0].t_wo - t0) > 1e-3
    np.testing.assert_array_equal(ostore.objects[1].t_wo, np.ones(3))
    np.testing.assert_array_equal(jostore.objects[1].t_wo, np.ones(3))
