"""The port's CUDA kernels on the card, held against their plain versions.

These tests need a CUDA card and skip without one. They import nothing of
jax or plvs_tpu, so they also run on a GPU machine that has no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q

K1 and K2 compute integer functions, and K3's float steps are rounded once
each in the same order in the kernel and its plain version, so every
comparison is exact. K2 runs at every half-resolution grid of the cameras
the repo configures and on grids that defeat a bounded sweep count; K3 at
D in {3, 16, 64, 128}, r in {1, 2, 3}, ragged, main-path and KITTI shapes.
"""

import numpy as np
import pytest
import torch

from plvs_tpu_torch.features import lines
from plvs_tpu_torch.geometry import cameras
from plvs_tpu_torch.io import synthetic
from plvs_tpu_torch.dense import stereo_depth
from plvs_tpu_torch.ops import cc_labels, hamming, stereo

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(rng, n, dev):
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(dev)


# phase 2's shapes, then the edges of K1's 16 x 8 fragments, 16 x 32 warp
# tiles and 16 x 128 blocks
K1_SHAPES = [(4096, 1024), (2048, 1024), (1024, 1024), (512, 160),
             (256, 160), (128, 160), (1, 1), (15, 7), (17, 9), (63, 65),
             (129, 257), (1000, 999), (4097, 1023)]
# (q, k, kind of words): random words at every shape, the other kinds at
# the small main-path shapes and across the edges
K1_CASES = ([(q, k, "random") for q, k in K1_SHAPES]
            + [(q, k, kind) for q, k in K1_SHAPES[3:] if q * k < 4 * 10 ** 6
               for kind in ("zeros_vs_ones", "ones_vs_ones", "high_bit_set",
                            "strided_view")])


def _k1_inputs(rng, q, k, kind, dev):
    if kind == "random":
        return _words(rng, q, dev), _words(rng, k, dev)
    if kind == "zeros_vs_ones":
        return (torch.zeros((q, 8), dtype=torch.int32, device=dev),
                torch.full((k, 8), -1, dtype=torch.int32, device=dev))
    if kind == "ones_vs_ones":
        return (torch.full((q, 8), -1, dtype=torch.int32, device=dev),
                torch.full((k, 8), -1, dtype=torch.int32, device=dev))
    if kind == "high_bit_set":   # negative int32 words
        return _words(rng, q, dev) | -2 ** 31, _words(rng, k, dev) | -2 ** 31
    return _words(rng, 3 * q, dev)[::3], _words(rng, 2 * k, dev)[1::2]


@pytest.mark.parametrize("q,k,kind", K1_CASES)
def test_hamming_kernel_matches_plain(dev, q, k, kind):
    rng = np.random.default_rng(q * 7919 + k)
    a, b = _k1_inputs(rng, q, k, kind, dev)
    before = hamming.launches
    got = hamming.hamming_matrix(a, b)
    assert hamming.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    ref = hamming.hamming_plain(a, b)
    assert torch.equal(got, ref)
    if kind == "zeros_vs_ones":
        assert bool((got == 256).all())
    if kind == "ones_vs_ones":
        assert bool((got == 0).all())


@pytest.mark.parametrize("q,k", [(4096, 1024), (128, 160)])
def test_hamming_kernel_is_one_device_kernel(dev, q, k):
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    a, b = _words(rng, q, dev), _words(rng, k, dev)
    hamming.hamming_matrix(a, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        hamming.hamming_matrix(a, b)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 1 and "hamming_bmma_kernel" in names[0], names


def test_cc_kernel_matches_plain_on_a_frame(dev):
    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=420.0)
    R, t = synthetic.default_trajectory(120)[40]
    g, _ = scene.render(R, t)
    gray = torch.from_numpy(
        np.clip(g, 0, 255).astype(np.uint8).astype(np.float32)).to(dev)
    _, _, init, conn = lines.connectivity_grid(gray)
    before = cc_labels.launches
    got = cc_labels.cc_min_labels(init, conn)
    assert cc_labels.launches == before + 1
    assert torch.equal(got, cc_labels.cc_min_labels_plain(init, conn, None))


# K2's cluster holds up to 232,448 cells: every grid below fits, the last
# ones are 640x480's, EuRoC's, KITTI's and 1280x720's half-resolution grids
CC_SHAPES = [(96, 160), (1, 1), (1, 320), (240, 1), (240, 320), (240, 376),
             (188, 620), (360, 640)]


@pytest.mark.parametrize("h,w", CC_SHAPES)
def test_cc_kernel_matches_plain_on_random_links(dev, h, w):
    """Symmetric random links, cyclic across both borders."""
    rng = np.random.default_rng(3)
    mask = rng.random((h, w)) < 0.6
    init = np.where(mask, rng.permutation(h * w).reshape(h, w),
                    h * w).astype(np.int32)
    bits = np.zeros((h, w), np.int32)
    ys, xs = np.mgrid[0:h, 0:w]
    for ci in range(0, 8, 2):          # symmetric links, both directions
        sy, sx = cc_labels.SHIFTS[ci]
        ny, nx = (ys - sy) % h, (xs - sx) % w
        link = mask & mask[ny, nx] & (rng.random((h, w)) < 0.5)
        bits |= link.astype(np.int32) << ci
        back = np.zeros((h, w), bool)
        back[ny[link], nx[link]] = True
        bits |= back.astype(np.int32) << (ci + 1)
    ti = torch.from_numpy(init).to(dev)
    tb = torch.from_numpy(bits).to(dev)
    before = cc_labels.launches
    got = cc_labels.cc_min_labels(ti, tb)
    assert cc_labels.launches == before + 1
    assert torch.equal(got, cc_labels.cc_min_labels_plain(ti, tb, None))


@pytest.mark.parametrize("h,w", CC_SHAPES[1:])
@pytest.mark.parametrize("grid", ["full_grid", "empty", "diagonal_staircase",
                                  "spiral", "random_links",
                                  "random_wrapping_links"])
def test_cc_kernel_matches_plain_on_adversarial_grids(dev, grid, h, w):
    grids = {name: (init, bits) for name, init, bits in
             synthetic.cc_grids(h, w, np.random.default_rng(h * 1000 + w))}
    init, bits = (torch.from_numpy(a).to(dev) for a in grids[grid])
    assert torch.equal(cc_labels.cc_min_labels(init, bits),
                       cc_labels.cc_min_labels_plain(init, bits, None))


@pytest.mark.parametrize("extra", [0, 1])
def test_cc_kernel_capacity(dev, extra):
    """A grid of exactly the cluster's capacity runs; one cell more is
    refused before any launch."""
    h, w = 8, cc_labels.CLUSTER_CAPACITY // 8 + extra
    rng = np.random.default_rng(5)
    init = torch.from_numpy(rng.permutation(h * w).reshape(h, w).astype(
        np.int32)).to(dev)
    mask = rng.random((h, w)) < 0.7
    bits = torch.from_numpy(synthetic.link_bits(mask)).to(dev)
    if extra:
        before = cc_labels.launches
        with pytest.raises(ValueError, match="capacity"):
            cc_labels.cc_min_labels(init, bits)
        assert cc_labels.launches == before
    else:
        assert torch.equal(cc_labels.cc_min_labels(init, bits),
                           cc_labels.cc_min_labels_plain(init, bits, None))


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("d", [3, 16, 64, 128])
@pytest.mark.parametrize("h,w,census", [(37, 150, "random"),
                                        (480, 640, "shifted"),
                                        (481, 641, "shifted"),
                                        (376, 1241, "shifted")])
def test_stereo_wta_kernel_matches_plain(dev, h, w, census, d, r):
    rng = np.random.default_rng(h + w + d)
    if census == "random":
        cl, cr = (torch.from_numpy(rng.integers(
            0, 2 ** 32, (h, w), dtype=np.uint64).astype(np.uint32).view(
                np.int32)).to(dev) for _ in range(2))
    else:
        base = rng.uniform(0, 255, (h, w + 16)).astype(np.float32)
        left = torch.from_numpy(base[:, 8:w + 8]).to(dev)
        right = torch.from_numpy(base[:, 15:w + 15]).to(dev)  # disparity 7
        cl = stereo_depth.census_transform(left)
        cr = stereo_depth.census_transform(right)
    before = stereo.launches
    got = stereo.disparity_wta(cl, cr, max_disp=d, agg_radius=r)
    assert stereo.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.float32
    ref = stereo.disparity_wta_plain(cl, cr, max_disp=d, agg_radius=r)
    assert torch.equal(got, ref)
    if census == "shifted" and d >= 16:
        assert (got > 0).float().mean() > 0.9


def test_stereo_wta_kernel_rejects_a_textureless_pair(dev):
    flat = stereo_depth.census_transform(torch.zeros((480, 640), device=dev))
    got = stereo.disparity_wta(flat, flat)
    assert torch.equal(got, stereo.disparity_wta_plain(flat, flat))
    assert bool((got < 0).all())
