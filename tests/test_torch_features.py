"""The port's feature modules (pyramid, FAST, ORB, matching, lines) against
the JAX package's on equal inputs. Integer outputs (masks, keypoint
positions, descriptor bits, match indices, component labels) must agree
exactly; float outputs carry the tolerance stated at each check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.features import fast as jfast
from plvs_tpu.features import lines as jlines
from plvs_tpu.features import matching as jmatch
from plvs_tpu.features import orb as jorb
from plvs_tpu.features import pyramid as jpyr
from plvs_tpu_torch.features import fast as tfast
from plvs_tpu_torch.features import lines as tlines
from plvs_tpu_torch.features import matching as tmatch
from plvs_tpu_torch.features import orb as torb
from plvs_tpu_torch.features import pyramid as tpyr
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn

N_LEVELS, SCALE, N_FEAT = 4, 1.2, 512


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gray():
    """A quantized 320x240 frame of the structured-panel scene."""
    cam = tcam.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                       bf=24.0)
    tex = tsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    scene = tsyn.SyntheticRGBD(cam, wall_z=3.0, texture=tex, tex_scale=220.0)
    R, t = tsyn.default_trajectory(36)[3]
    g, _ = scene.render(R, t)
    return np.clip(g, 0, 255).astype(np.uint8).astype(np.float32)


@pytest.fixture(scope="module")
def jstack(gray):
    return np.asarray(jpyr.build_pyramid_stack(jnp.asarray(gray), N_LEVELS,
                                               SCALE))


def _jw(a):
    """JAX uint32 words -> the port's int32 words."""
    return torch.from_numpy(np.asarray(a).view(np.int32))


def test_pyramid_levels(gray, jstack):
    """1e-3 on 0..255 intensities (relative ~4e-6): the per-axis resampling
    matrices are rebuilt from JAX's formula, but XLA evaluates that formula
    and the contraction in its own float32 order — its weights differ from
    the numpy ones by up to 2.7e-6 and its levels from a float64 evaluation
    by up to 4.7e-4 (measured), which bounds any port's agreement."""
    ts = tpyr.build_pyramid_stack(torch.from_numpy(gray), N_LEVELS, SCALE)
    np.testing.assert_allclose(ts.numpy(), jstack, atol=1e-3)
    for n_in, n_out in ((240, 200), (320, 267), (480, 400), (167, 139)):
        w = np.asarray(jpyr.jax.image.resize(jnp.eye(n_in), (n_out, n_in),
                                             "linear", antialias=True))
        np.testing.assert_allclose(tpyr._resize_weights(n_in, n_out), w,
                                   atol=5e-6)


def test_blur_and_patches(jstack):
    """Blur 1e-4 (same shift-and-add order, float32); patches gathered from
    the same blurred stack are exact."""
    jb = np.asarray(jpyr.gaussian_blur_batched(jnp.asarray(jstack)))
    tb = tpyr.gaussian_blur_batched(torch.from_numpy(jstack.copy()))
    np.testing.assert_allclose(tb.numpy(), jb, atol=1e-4)
    rng = np.random.default_rng(1)
    xy = np.stack([rng.uniform(0, 319, 64), rng.uniform(0, 239, 64)],
                  -1).astype(np.float32)
    lvl = rng.integers(0, N_LEVELS, 64).astype(np.int32)
    jp = np.asarray(jorb.extract_patches_stack(jnp.asarray(jb),
                                               jnp.asarray(lvl),
                                               jnp.asarray(xy)))
    tp = torb.extract_patches_stack(torch.from_numpy(jb), torch.from_numpy(lvl),
                                    torch.from_numpy(xy))
    np.testing.assert_array_equal(tp.numpy(), jp)


def test_fast_on_the_jax_pyramid(jstack):
    """Fed the JAX pyramid, FAST scores, masks and the selected keypoints
    agree exactly (same float32 operations in the same order)."""
    js_lo, js_hi = jfast.fast_score2(jnp.asarray(jstack), 7.0, 20.0)
    ts_lo, ts_hi = tfast.fast_score2(torch.from_numpy(jstack), 7.0, 20.0)
    np.testing.assert_array_equal(ts_lo.numpy() > 0, np.asarray(js_lo) > 0)
    np.testing.assert_array_equal(ts_hi.numpy() > 0, np.asarray(js_hi) > 0)
    np.testing.assert_array_equal(ts_lo.numpy(), np.asarray(js_lo))
    per = jorb.features_per_level(N_FEAT, N_LEVELS, SCALE)
    assert per == torb.features_per_level(N_FEAT, N_LEVELS, SCALE)
    shapes = jpyr.level_shapes(240, 320, N_LEVELS, SCALE)
    budget = [max(n, 1) for n in per]
    jxy, jsc, jva = jfast.detect_batched(jnp.asarray(jstack), shapes, budget,
                                         border=jorb.HALF + 1)
    txy, tsc, tva = tfast.detect_batched(torch.from_numpy(jstack), shapes,
                                         budget, border=torb.HALF + 1)
    np.testing.assert_array_equal(tva.numpy(), np.asarray(jva))
    np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


def test_top_k_breaks_ties_like_lax():
    x = torch.tensor([[3.0, 1.0, 3.0, 2.0, 3.0, 1.0]])
    vals, idx = tfast.top_k(x, 4)
    jv, ji = jfast.jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_patterns_regenerated_exactly():
    np.testing.assert_array_equal(torb.PATTERN, jorb.PATTERN)
    np.testing.assert_array_equal(torb._MASK, jorb._MASK)
    np.testing.assert_array_equal(tlines._LBD_PAIRS, jlines._LBD_PAIRS)
    rows, S = torb._sampling(torch.device("cpu"))
    np.testing.assert_array_equal(rows.numpy(), jorb._S_ROWS)
    np.testing.assert_array_equal(S.numpy(), jorb._SAMPLING_S_PRUNED)


def test_descriptors_from_equal_patches(rng):
    """Same patches and angles -> the same 256 bits (the 4 bilinear taps
    per sample are the only non-zero terms of each float32 dot)."""
    patches = rng.uniform(0, 255, (300, 41, 41)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    jd = np.asarray(jorb.descriptors(jnp.asarray(patches), jnp.asarray(ang)))
    td = torb.descriptors(torch.from_numpy(patches), torch.from_numpy(ang))
    np.testing.assert_array_equal(td.numpy(), jd.view(np.int32))
    # 2e-4 rad: atan2 of two sums of 1681 products, summed in another
    # order (measured 1e-4 on random patches; 12-degree steering bins)
    ja = np.asarray(jorb.ic_angle(jnp.asarray(patches)))
    np.testing.assert_allclose(torb.ic_angle(torch.from_numpy(patches)).numpy(),
                               ja, atol=2e-4)


def test_extract_end_to_end(gray):
    """Whole multi-scale extraction. Keypoints: at least 97% identical
    (pyramid differences of ~1e-4 may move a FAST tie; measured: all).
    Descriptors of identical keypoints: at least 95% bit-identical and 99%
    within 2 bits — a bilinear sample pair closer than the pyramid's float
    difference flips its bit (measured 478 of 489 identical, the rest 1-2
    bits apart)."""
    jk = jorb.extract(jnp.asarray(gray), N_FEAT, N_LEVELS, SCALE)
    tk = torb.extract(torch.from_numpy(gray), N_FEAT, N_LEVELS, SCALE)
    same = (np.all(tk.xy.numpy() == np.asarray(jk.xy), -1)
            & (tk.mask.numpy() == np.asarray(jk.mask)))
    assert same.mean() >= 0.97, same.mean()
    valid = same & np.asarray(jk.mask)
    bits = tmatch.hamming_pairs(
        tk.desc[torch.from_numpy(valid)],
        _jw(np.asarray(jk.desc)[valid])).numpy()
    assert (bits == 0).mean() >= 0.95, np.bincount(bits)
    assert (bits <= 2).mean() >= 0.99, np.bincount(bits)
    np.testing.assert_array_equal(tk.octave.numpy(), np.asarray(jk.octave))
    np.testing.assert_allclose(
        torb.inv_scale_sigma2(tk.octave, SCALE).numpy(),
        np.asarray(jorb.inv_scale_sigma2(jk.octave, SCALE)), rtol=1e-6)


def _match_inputs(rng, q=300, k=256):
    base = rng.integers(0, 2 ** 32, (k, 8), dtype=np.uint64).astype(np.uint32)
    # queries: noisy copies of keys, so that real matches exist
    qi = rng.integers(0, k, q)
    flip = rng.integers(0, 2 ** 32, (q, 8), dtype=np.uint64).astype(np.uint32)
    flip &= rng.integers(0, 2 ** 32, (q, 8), dtype=np.uint64).astype(np.uint32)
    flip &= rng.integers(0, 2 ** 32, (q, 8), dtype=np.uint64).astype(np.uint32)
    dq = base[qi] ^ flip
    kp_xy = rng.uniform(0, 320, (k, 2)).astype(np.float32)
    uv = (kp_xy[qi] + rng.normal(0, 3, (q, 2))).astype(np.float32)
    return dict(dq=dq, dk=base, uv=uv, kp_xy=kp_xy,
                q_oct=rng.integers(0, 4, q).astype(np.int32),
                k_oct=rng.integers(0, 4, k).astype(np.int32),
                q_valid=rng.random(q) < 0.9, k_mask=rng.random(k) < 0.95,
                q_ang=rng.uniform(-3, 3, q).astype(np.float32),
                k_ang=rng.uniform(-3, 3, k).astype(np.float32),
                radius=rng.uniform(4, 15, q).astype(np.float32))


@pytest.mark.parametrize("check_rotation", [False, True])
def test_search_by_projection_equal_inputs(rng, check_rotation):
    m = _match_inputs(rng)
    j_idx, j_d = jmatch.search_by_projection(
        jnp.asarray(m["uv"]), jnp.asarray(m["q_valid"]), jnp.asarray(m["dq"]),
        jnp.asarray(m["q_oct"]), jnp.asarray(m["kp_xy"]), jnp.asarray(m["dk"]),
        jnp.asarray(m["k_oct"]), jnp.asarray(m["k_mask"]),
        radius=jnp.asarray(m["radius"]), kp_angle=jnp.asarray(m["k_ang"]),
        map_angle=jnp.asarray(m["q_ang"]), check_rotation=check_rotation)
    t = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
         for k, v in m.items()}
    t_idx, t_d = tmatch.search_by_projection(
        t["uv"], t["q_valid"], t["dq"], t["q_oct"], t["kp_xy"], t["dk"],
        t["k_oct"], t["k_mask"], radius=t["radius"], kp_angle=t["k_ang"],
        map_angle=t["q_ang"], check_rotation=check_rotation)
    assert (np.asarray(j_idx) >= 0).sum() > 20
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))


def test_match_nn_ratio_equal_inputs(rng):
    m = _match_inputs(rng)
    j_idx, j_d = jmatch.match_nn_ratio(
        jnp.asarray(m["dq"]), jnp.asarray(m["dk"]), jnp.asarray(m["q_valid"]),
        jnp.asarray(m["k_mask"]), max_dist=64, ratio=0.8)
    t_idx, t_d = tmatch.match_nn_ratio(
        _jw(m["dq"]), _jw(m["dk"]), torch.from_numpy(m["q_valid"]),
        torch.from_numpy(m["k_mask"]), max_dist=64, ratio=0.8)
    assert (np.asarray(j_idx) >= 0).sum() > 20
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))
    np.testing.assert_array_equal(
        tmatch.hamming_pairs(_jw(m["dq"][:256]), _jw(m["dk"])).numpy(),
        np.asarray(jmatch.hamming_pairs(jnp.asarray(m["dq"][:256]),
                                        jnp.asarray(m["dk"]))))


def _sorted_segments(sp, ep):
    """Endpoints as unordered pairs (a PCA direction may flip by pi when
    the two frameworks' atan2 lands on opposite sides of the branch cut,
    which swaps start and end of the same segment)."""
    swap = (sp[:, 0] > ep[:, 0]) | ((sp[:, 0] == ep[:, 0]) & (sp[:, 1] > ep[:, 1]))
    a = np.where(swap[:, None], ep, sp)
    b = np.where(swap[:, None], sp, ep)
    return a, b


def test_detect_and_extract_lines(gray):
    """Component labels are exact (supports and validity agree exactly);
    endpoints within 1e-2 px: the moment sums cancel (sxx/c - cx^2) in
    float32, so the two frameworks' summation orders move endpoints by up
    to ~5e-3 px (measured). Given the JAX detector's output, merging and
    LBD descriptors are exact."""
    jk = jlines.detect_lines(jnp.asarray(gray), max_lines=64)
    tk = tlines.detect_lines(torch.from_numpy(gray), max_lines=64)
    np.testing.assert_array_equal(tk.response.numpy(), np.asarray(jk.response))
    np.testing.assert_array_equal(tk.mask.numpy(), np.asarray(jk.mask))
    m = np.asarray(jk.mask)
    assert m.sum() >= 8
    ja, jb = _sorted_segments(np.asarray(jk.sp)[m], np.asarray(jk.ep)[m])
    ta, tb = _sorted_segments(tk.sp.numpy()[m], tk.ep.numpy()[m])
    np.testing.assert_allclose(ta, ja, atol=1e-2)
    np.testing.assert_allclose(tb, jb, atol=1e-2)

    jm = jlines.merge_collinear(jk)
    tin = tlines.KeyLines(*(torch.from_numpy(np.asarray(a).view(np.int32))
                            if np.asarray(a).dtype == np.uint32
                            else torch.from_numpy(np.array(a)) for a in jk))
    tm = tlines.merge_collinear(tin)
    for f in ("sp", "ep", "response", "mask"):
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)))
    jd = np.asarray(jlines.lbd_descriptors(jnp.asarray(gray), jm))
    td = tlines.lbd_descriptors(torch.from_numpy(gray), tm)
    mm = np.asarray(jm.mask)
    np.testing.assert_array_equal(td.numpy()[mm], jd.view(np.int32)[mm])

    je = jlines.extract_lines(jnp.asarray(gray), max_lines=64)
    te = tlines.extract_lines(torch.from_numpy(gray), max_lines=64)
    np.testing.assert_array_equal(te.mask.numpy(), np.asarray(je.mask))
    th_j, d_j = jlines.line_theta_d(je.sp, je.ep)
    th_t, d_t = tlines.line_theta_d(te.sp, te.ep)
    em = np.asarray(je.mask)
    np.testing.assert_allclose(np.abs(np.sin(th_t.numpy()[em]
                                             - np.asarray(th_j)[em])), 0,
                               atol=1e-3)
    # normals to 1e-3, offsets to 0.2 px: an angle difference of ~3e-4
    # rad (measured) over a lever arm of up to the image width
    tn = tlines.line_nld(te.sp, te.ep).numpy()[em]
    jn = np.asarray(jlines.line_nld(je.sp, je.ep))[em]
    np.testing.assert_allclose(tn[:, :2], jn[:, :2], atol=1e-3)
    np.testing.assert_allclose(tn[:, 2], jn[:, 2], atol=0.2)


# ---------------------------------------------------------------------------
# the per-level extraction path (uniformity cells that differ by level)
# ---------------------------------------------------------------------------

# (h, w, features, levels): the map-object template's extraction and
# 320x240 at bench.py's budget (image_scale=0.5 on bench.py's camera)
PER_LEVEL = [(256, 256, 512, 8), (240, 320, 1024, 8)]


def _per_level_case(h, w, n, levels):
    """A quantized crop of the structured texture, the per-level budgets
    and cells (which must differ: the per-level path is taken)."""
    tex = tsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    img = np.clip(tex[20:20 + h, 20:20 + w], 0, 255).astype(np.uint8)
    per = torb.features_per_level(n, levels, SCALE)
    assert per == jorb.features_per_level(n, levels, SCALE)
    shapes = tpyr.level_shapes(h, w, levels, SCALE)
    cells = [max(8, min(16, int(np.sqrt(hl * wl / max(nl, 1)))))
             for (hl, wl), nl in zip(shapes, per)]
    assert len({cells[lv] for lv in range(levels) if per[lv] > 0}) > 1
    return img.astype(np.float32), per, cells


# jitted, as the JAX package runs them (eager dispatch compiles op by op)
_JIT_DETECT = jax.jit(jfast.detect, static_argnums=(1,),
                      static_argnames=("border", "cell"))
_JIT_BLUR = jax.jit(jpyr.gaussian_blur)


@pytest.mark.parametrize("h,w,n,levels", PER_LEVEL)
def test_per_level_steps_on_the_jax_levels(h, w, n, levels):
    """Fed each JAX pyramid level: the single-level FAST selection (masks,
    positions, scores) and the patches are exact; the single-image blur
    within 1e-4 (as the batched blur above); the IC angle from the
    UNBLURRED patch within 2e-3 rad (measured 1.1e-3: an unblurred patch
    whose moments nearly cancel turns the sums' float32 order into angle;
    the steering bins are 0.21 rad wide); descriptors from JAX's
    blurred patches and angles at least 99% of words exact and every
    descriptor within 2 bits. Not all exact: the 30-bin sampling is one float32
    product whose 4 non-zero terms XLA's dot and torch's matmul sum in
    different association (a tenth of the samples differ in the last
    place, measured), and on smooth blurred patches a sample pair that
    close flips its bit (measured: 1 descriptor of 64 on one level 2 bits
    apart, the rest exact); random
    patches (test_descriptors_from_equal_patches) show no such pair."""
    img, per, cells = _per_level_case(h, w, n, levels)
    jlevels = jpyr.build_pyramid(jnp.asarray(img), levels, SCALE)
    for lv, (jl, n_l) in enumerate(zip(jlevels, per)):
        if n_l <= 0:
            continue
        jl = np.asarray(jl)
        jxy, jsc, jva = _JIT_DETECT(jnp.asarray(jl), n_l,
                                    border=jorb.HALF + 1, cell=cells[lv])
        txy, tsc, tva = tfast.detect(torch.from_numpy(jl), n_l,
                                     border=torb.HALF + 1, cell=cells[lv])
        np.testing.assert_array_equal(tva.numpy(), np.asarray(jva))
        np.testing.assert_array_equal(txy.numpy(), np.asarray(jxy))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
        jp = np.asarray(jorb.extract_patches(jnp.asarray(jl), jxy))
        tp = torb.extract_patches(torch.from_numpy(jl), txy)
        np.testing.assert_array_equal(tp.numpy(), jp)
        ja = np.asarray(jorb.ic_angle(jnp.asarray(jp)))
        np.testing.assert_allclose(torb.ic_angle(tp).numpy(), ja, atol=2e-3)
        jb = np.asarray(_JIT_BLUR(jnp.asarray(jl)))
        np.testing.assert_allclose(
            tpyr.gaussian_blur(torch.from_numpy(jl)).numpy(), jb, atol=1e-4)
        jbp = np.asarray(jorb.extract_patches(jnp.asarray(jb), jxy))
        jd = np.asarray(jorb.descriptors(jnp.asarray(jbp), jnp.asarray(ja)))
        td = torb.descriptors(torch.from_numpy(jbp), torch.from_numpy(ja))
        words_same = td.numpy() == jd.view(np.int32)
        assert words_same.mean() >= 0.99, (lv, words_same.mean())
        bits = tmatch.hamming_pairs(td, _jw(jd)).numpy()
        assert bits.max() <= 2, (lv, np.bincount(bits))


_JIT_EXTRACT = jax.jit(jorb.extract, static_argnums=(1, 2))


@pytest.mark.parametrize("h,w,n,levels", PER_LEVEL)
def test_per_level_extract_end_to_end(h, w, n, levels):
    """The whole per-level extraction against the JAX package's: keypoints,
    octaves and masks identical (measured: all), responses within 0.1 (a
    sum of 16 threshold excesses on levels that differ by ~1e-3, measured
    0.06), and the descriptors of the valid keypoints identical (measured:
    all 230 and 326; the sampling product's association, which can flip a
    bit on smooth patches, test_per_level_steps_on_the_jax_levels, leaves
    these two images' bits alone)."""
    img, _, _ = _per_level_case(h, w, n, levels)
    jk = _JIT_EXTRACT(jnp.asarray(img), n, levels)
    tk = torb.extract(torch.from_numpy(img), n, levels)
    np.testing.assert_array_equal(tk.xy.numpy(), np.asarray(jk.xy))
    np.testing.assert_array_equal(tk.octave.numpy(), np.asarray(jk.octave))
    np.testing.assert_array_equal(tk.mask.numpy(), np.asarray(jk.mask))
    np.testing.assert_allclose(tk.response.numpy(), np.asarray(jk.response),
                               atol=0.1)
    valid = np.asarray(jk.mask)
    assert valid.sum() >= 200, valid.sum()
    np.testing.assert_array_equal(tk.desc.numpy()[valid],
                                  np.asarray(jk.desc).view(np.int32)[valid])


def _kp_set(rng, n, w=320, h=240):
    return dict(
        xy=rng.uniform(0, [w, h], (n, 2)).astype(np.float32),
        desc=rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
            np.uint32),
        mask=rng.random(n) < 0.9)


def test_search_for_initialization_equal_inputs(rng):
    """Exact: a 100 px window around each keypoint and the ratio test."""
    a = _kp_set(rng, 400)
    b = _kp_set(rng, 380)
    # a second view: noisy copies of half the keypoints, 30 px away
    b["xy"][:200] = a["xy"][:200] + rng.normal(0, 30, (200, 2))
    b["desc"][:200] = a["desc"][:200] ^ (
        rng.integers(0, 2 ** 32, (200, 8), dtype=np.uint64).astype(np.uint32)
        & rng.integers(0, 2 ** 32, (200, 8), dtype=np.uint64).astype(
            np.uint32)
        & rng.integers(0, 2 ** 32, (200, 8), dtype=np.uint64).astype(
            np.uint32))
    j_idx, j_d = jmatch.search_for_initialization(
        *(jnp.asarray(a[k]) for k in ("xy", "desc", "mask")),
        *(jnp.asarray(b[k]) for k in ("xy", "desc", "mask")))
    t_idx, t_d = tmatch.search_for_initialization(
        *(_jw(a[k]) if k == "desc" else torch.from_numpy(a[k])
          for k in ("xy", "desc", "mask")),
        *(_jw(b[k]) if k == "desc" else torch.from_numpy(b[k])
          for k in ("xy", "desc", "mask")))
    assert (np.asarray(j_idx) >= 0).sum() > 50
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))


def test_search_for_triangulation_equal_inputs(rng):
    """Exact: the float32 epipolar gate (|ray1 . l| / |l_xy| + 1e-12
    against 2 / fx, JAX's operation order) and the ratio test."""
    n1, n2 = 350, 330
    X = np.stack([rng.uniform(-1, 1, 300), rng.uniform(-1, 1, 300),
                  rng.uniform(2, 5, 300)], -1)
    R12 = np.array([[np.cos(0.05), 0, np.sin(0.05)], [0, 1, 0],
                    [-np.sin(0.05), 0, np.cos(0.05)]], np.float32)
    t12 = np.array([0.2, 0.01, 0.03], np.float32)
    X2 = (X - t12) @ R12            # x2 = R12^T (x1 - t12)
    rays1 = np.concatenate([X[:, :2] / X[:, 2:], np.ones((300, 1))], -1)
    rays2 = np.concatenate([X2[:, :2] / X2[:, 2:], np.ones((300, 1))], -1)
    rays1 = np.concatenate([rays1, rng.uniform(-0.5, 0.5, (n1 - 300, 3))
                            + [0, 0, 1]]).astype(np.float32)
    rays2 = np.concatenate([rays2[:280], rng.uniform(-0.5, 0.5, (n2 - 280, 3))
                            + [0, 0, 1]]).astype(np.float32)
    d1 = rng.integers(0, 2 ** 32, (n1, 8), dtype=np.uint64).astype(np.uint32)
    d2 = rng.integers(0, 2 ** 32, (n2, 8), dtype=np.uint64).astype(np.uint32)
    d2[:280] = d1[:280] ^ (d2[:280] & rng.integers(
        0, 2 ** 32, (280, 8), dtype=np.uint64).astype(np.uint32)
        & rng.integers(0, 2 ** 32, (280, 8), dtype=np.uint64).astype(
            np.uint32))
    m1, m2 = rng.random(n1) < 0.9, rng.random(n2) < 0.9
    j_idx, j_d = jmatch.search_for_triangulation(
        jnp.asarray(d1), jnp.asarray(m1), jnp.asarray(rays1),
        jnp.asarray(d2), jnp.asarray(m2), jnp.asarray(rays2),
        jnp.asarray(R12), jnp.asarray(t12), epi_thresh=2.0 / 300.0)
    t_idx, t_d = tmatch.search_for_triangulation(
        _jw(d1), torch.from_numpy(m1), torch.from_numpy(rays1), _jw(d2),
        torch.from_numpy(m2), torch.from_numpy(rays2), torch.from_numpy(R12),
        torch.from_numpy(t12), epi_thresh=2.0 / 300.0)
    assert (np.asarray(j_idx) >= 0).sum() > 100
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(j_d))


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_fast_score_on_the_jax_pyramid(jstack, threshold):
    """fast_score is fast_score2's low-threshold score: exact."""
    got = tfast.fast_score(torch.from_numpy(jstack), threshold).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jfast.fast_score(jnp.asarray(jstack), threshold)))
    assert (got > 0).sum() > 100


def test_scale_sigma2_like_jax():
    oct_ = np.arange(8, dtype=np.int32).repeat(3)
    for scale in (1.2, 2.0):
        got = torb.scale_sigma2(torch.from_numpy(oct_), scale).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jorb.scale_sigma2(jnp.asarray(oct_), scale)),
            rtol=2e-7)
        np.testing.assert_allclose(
            got * torb.inv_scale_sigma2(torch.from_numpy(oct_), scale).numpy(),
            1.0, rtol=1e-6)
