"""The port's kernel modules on the CPU: K1 (all-pairs Hamming) and K2
(connected-component min labels) through their plain versions, held
against the JAX package — exact, because both functions are integer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from plvs_tpu.features import lines as jlines
from plvs_tpu.ops import hamming as jham
from plvs_tpu_torch import ops
from plvs_tpu_torch.features import lines as tlines
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.io import synthetic as tsyn
from plvs_tpu_torch.ops import cc_labels, hamming
from plvs_tpu_torch.slam import tracking


def _words(rng, n, fill=None):
    if fill is not None:
        return np.full((n, 8), fill, np.uint32)
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int32))


@pytest.mark.parametrize("q,k", [(1, 1), (7, 130), (129, 64), (200, 257)])
def test_hamming_plain_matches_jnp(rng, q, k):
    dq, dk = _words(rng, q), _words(rng, k)
    ref = np.asarray(jham.hamming_jnp(jnp.asarray(dq), jnp.asarray(dk)))
    out = hamming.hamming_matrix(_t(dq), _t(dk))
    assert out.dtype == torch.int32 and out.shape == (q, k)
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("kernel", ["mxu", "vpu"])
def test_hamming_plain_matches_pallas_interpret(rng, kernel):
    dq, dk = _words(rng, 150), _words(rng, 201)
    ref = np.asarray(jham.hamming_pallas(jnp.asarray(dq), jnp.asarray(dk),
                                         kernel=kernel, interpret=True))
    np.testing.assert_array_equal(
        hamming.hamming_matrix(_t(dq), _t(dk)).numpy(), ref)


@pytest.mark.parametrize("q,k,kind", [(600, 512, "random"),
                                      (1024, 520, "random"),
                                      (512, 512, "random"),
                                      (600, 512, "high_bit_set"),
                                      (512, 600, "zeros_vs_ones")])
def test_hamming_matches_jax_big_product_branch(rng, q, k, kind):
    """At Q x K >= 512 x 512 the JAX package's hamming_matrix takes its
    MXU route, hamming_mxu_xla: (256 - <s_q, s_k>) / 2 with s = +-1 in
    bf16 — the formulation K1's library yardsticks compute on the card."""
    if kind == "zeros_vs_ones":
        dq, dk = _words(rng, q, 0), _words(rng, k, 0xFFFFFFFF)
    else:
        dq, dk = _words(rng, q), _words(rng, k)
    if kind == "high_bit_set":
        dq |= np.uint32(0x80000000)
    ref = np.asarray(jham.hamming_matrix(jnp.asarray(dq), jnp.asarray(dk)))
    np.testing.assert_array_equal(
        ref, np.asarray(jham.hamming_mxu_xla(jnp.asarray(dq), jnp.asarray(dk))))
    out = hamming.hamming_matrix(_t(dq), _t(dk))
    assert out.dtype == torch.int32 and out.shape == (q, k)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_hamming_extremes(rng):
    zeros, ones = _words(rng, 5, 0), _words(rng, 6, 0xFFFFFFFF)
    out = hamming.hamming_matrix(_t(zeros), _t(ones)).numpy()
    assert (out == 256).all()
    assert (hamming.hamming_matrix(_t(ones), _t(ones)).numpy() == 0).all()


def test_hamming_rejects_bad_input():
    with pytest.raises(ValueError):
        hamming.hamming_matrix(torch.zeros((3, 8), dtype=torch.int64),
                               torch.zeros((3, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        hamming.hamming_matrix(torch.zeros((3, 7), dtype=torch.int32),
                               torch.zeros((3, 7), dtype=torch.int32))


def test_cuda_device_refused_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError):
        ops.resolve_device("cuda")


def _components_reference(init: np.ndarray, bits: np.ndarray) -> np.ndarray:
    """Independent reference of K2's contract: min of init over each
    connected component of the (cyclic) link graph, by scipy."""
    h, w = init.shape
    ys, xs = np.mgrid[0:h, 0:w]
    rows, cols = [], []
    for ci, (sy, sx) in enumerate(cc_labels.SHIFTS):
        m = ((bits >> ci) & 1).astype(bool)
        rows.append((ys * w + xs)[m])
        cols.append((((ys - sy) % h) * w + (xs - sx) % w)[m])
    r, c = np.concatenate(rows), np.concatenate(cols)
    graph = coo_matrix((np.ones(len(r)), (r, c)), shape=(h * w, h * w))
    _, comp = connected_components(graph, directed=False)
    lo = np.full(comp.max() + 1, np.iinfo(np.int64).max)
    np.minimum.at(lo, comp, init.reshape(-1).astype(np.int64))
    return lo[comp].reshape(h, w)


def _frame_gray(idx: int, size=(320, 240)) -> np.ndarray:
    cam = tcam.pinhole(300.0, 300.0, 160.0, 120.0, width=size[0],
                       height=size[1], bf=24.0)
    tex = tsyn.make_structured_texture(1024, rng=np.random.default_rng(7))
    scene = tsyn.SyntheticRGBD(cam, wall_z=3.0, texture=tex, tex_scale=220.0)
    R, t = tsyn.default_trajectory(36)[idx]
    gray, _ = scene.render(R, t)
    return np.clip(gray, 0, 255).astype(np.uint8).astype(np.float32)


@pytest.mark.parametrize("idx", [0, 9])
def test_cc_plain_on_frame_grids(idx):
    """On real frame grids: the plain version with the reference's cap
    equals the exact component minimum (the reference converged — checked
    on the JAX side by raising n_iters, which changes no line), and
    equals the uncapped run."""
    gray = _frame_gray(idx)
    _, _, init, conn = tlines.connectivity_grid(torch.from_numpy(gray))
    h2, w2 = init.shape
    cap = -(-((h2 + w2) // 3) // 8)
    capped = cc_labels.cc_min_labels(init, conn, ref_max_chunks=cap)
    free = cc_labels.cc_min_labels_plain(init, conn, max_chunks=None)
    ref = _components_reference(init.numpy(), conn.numpy())
    np.testing.assert_array_equal(capped.numpy(), ref)
    np.testing.assert_array_equal(free.numpy(), ref)
    a = jlines.detect_lines(jnp.asarray(gray), max_lines=64)
    b = jlines.detect_lines(jnp.asarray(gray), max_lines=64, n_iters=4 * (h2 + w2))
    for f in ("response", "mask", "sp", "ep"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))


def test_cc_plain_cap_binds_on_a_long_diagonal():
    """Where the reference's cap binds, the capped plain version stops
    short and the uncapped one reaches the true fixpoint (what the CUDA
    kernel returns)."""
    h, w = 64, 64
    init = np.full((h, w), h * w, np.int32)
    bits = np.zeros((h, w), np.int32)
    for i in range(h):
        init[i, i] = i * w + i
        if i:
            bits[i, i] |= 1 << 4        # link to (i-1, i-1): SHIFTS[4]
        if i < h - 1:
            bits[i, i] |= 1 << 5        # link to (i+1, i+1): SHIFTS[5]
    ti, tb = torch.from_numpy(init), torch.from_numpy(bits)
    ref = _components_reference(init, bits)
    np.testing.assert_array_equal(
        cc_labels.cc_min_labels_plain(ti, tb, None).numpy(), ref)
    capped = cc_labels.cc_min_labels_plain(ti, tb, 2).numpy()
    assert (capped != ref).any()


def test_cc_random_links(rng):
    h, w = 48, 80
    mask = rng.random((h, w)) < 0.6
    init = np.where(mask, np.arange(h * w).reshape(h, w), h * w).astype(np.int32)
    bits = np.zeros((h, w), np.int32)
    ys, xs = np.mgrid[0:h, 0:w]
    for ci in range(0, 8, 2):            # symmetric links, both directions
        sy, sx = cc_labels.SHIFTS[ci]
        ny, nx = (ys - sy) % h, (xs - sx) % w
        link = mask & mask[ny, nx] & (rng.random((h, w)) < 0.5)
        bits |= link.astype(np.int32) << ci
        back = np.zeros((h, w), bool)
        back[ny[link], nx[link]] = True
        bits |= back.astype(np.int32) << (ci + 1)
    out = cc_labels.cc_min_labels(torch.from_numpy(init), torch.from_numpy(bits))
    np.testing.assert_array_equal(out.numpy(), _components_reference(init, bits))


@pytest.mark.parametrize("grid", ["full_grid", "empty", "diagonal_staircase",
                                  "spiral", "random_links",
                                  "random_wrapping_links"])
def test_cc_plain_on_adversarial_grids(grid):
    """The grids chip_smoke.py and the card tests hold K2 to: the uncapped
    plain version reaches the exact component minimum (scipy)."""
    grids = {name: (init, bits) for name, init, bits in
             tsyn.cc_grids(24, 40, np.random.default_rng(11))}
    init, bits = grids[grid]
    out = cc_labels.cc_min_labels_plain(torch.from_numpy(init),
                                        torch.from_numpy(bits), None)
    np.testing.assert_array_equal(out.numpy(),
                                  _components_reference(init, bits))


@pytest.mark.parametrize("h,w", [(240, 320), (240, 376), (188, 620),
                                 (360, 640), (1, 232448), (8, 29056)])
def test_cc_cluster_holds_every_camera_grid(h, w):
    """640x480, EuRoC, KITTI and 1280x720 half-resolution grids, and grids
    of exactly the capacity, fit K2's 8-block cluster."""
    cc_labels.check_capacity(h, w)
    assert cc_labels.smem_per_block(h, w) <= cc_labels.SMEM_PER_BLOCK
    assert h * w <= cc_labels.CLUSTER_CAPACITY == 232448


@pytest.mark.parametrize("h,w", [(1, 232449), (8, 29057), (483, 482)])
def test_cc_cluster_refuses_grids_over_capacity(h, w):
    with pytest.raises(ValueError, match="capacity of 232448 cells"):
        cc_labels.check_capacity(h, w)


def test_scatter_duplicates_keep_the_last_source():
    """kp_pt.at[tgt].set(src, mode="drop") on XLA:CPU keeps the last write
    for a duplicated target; the port resolves duplicates the same way on
    every device (largest source index wins)."""
    import jax

    tgt = np.array([3, 1, 3, 5, 1, 0, 3, 7, 7], np.int32)
    ok = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1], bool)
    n = 6
    src = np.arange(len(tgt), dtype=np.int32)
    ref = jax.jit(lambda t, o: jnp.full((n,), -1, jnp.int32).at[
        jnp.where(o, t, n)].set(src, mode="drop"))(tgt, ok)
    out = tracking._scatter_last(n, torch.from_numpy(tgt.astype(np.int64)),
                                 torch.from_numpy(ok))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
