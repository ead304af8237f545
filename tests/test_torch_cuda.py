"""The port's CUDA kernels on the card, held against their plain versions.

These tests need a CUDA card and skip without one. They import nothing of
jax or plvs_tpu, so they also run on a GPU machine that has no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q

Both kernels compute integer functions, so the comparison is exact.
"""

import numpy as np
import pytest
import torch

from plvs_tpu_torch.features import lines
from plvs_tpu_torch.geometry import cameras
from plvs_tpu_torch.io import synthetic
from plvs_tpu_torch.ops import cc_labels, hamming

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(rng, n, dev):
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(dev)


@pytest.mark.parametrize("q,k", [(1, 1), (63, 65), (512, 160),
                                 (4096, 1024)])
def test_hamming_kernel_matches_plain(dev, q, k):
    rng = np.random.default_rng(q * 7919 + k)
    a, b = _words(rng, q, dev), _words(rng, k, dev)
    before = hamming.launches
    got = hamming.hamming_matrix(a, b)
    assert hamming.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    assert torch.equal(got, hamming.hamming_plain(a, b))


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


def test_cc_kernel_matches_plain_on_random_links(dev):
    rng = np.random.default_rng(3)
    h, w = 96, 160
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
    assert torch.equal(cc_labels.cc_min_labels(ti, tb),
                       cc_labels.cc_min_labels_plain(ti, tb, None))
