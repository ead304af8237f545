"""Census-stereo disparity: cost aggregation + winner-take-all (K3).

Counterpart of plvs_tpu/ops/stereo.py::disparity_wta_pallas, the dense
stereo engine's fused kernel. Census images are ``[H, W]`` int32 tensors
holding the census bit patterns (the JAX package's uint32 words); the result
is the ``[H, W]`` float32 disparity, -1 where invalid. Both versions compute
the TPU kernel's function, borders included (``ops/stereo.py:20-23`` and
``:89-151`` there; not the jnp path's column wrap-around):

* ``raw(y, x, d) = popcount(cl[y, x] ^ cr[y, x - d])``, 1000 where
  ``x < d``, 0 for rows or columns outside the image (the row rule first);
* ``agg`` is the integer box sum of ``raw`` over the ``(2r+1)^2`` window
  times ``float32(1 / (2r+1)^2)`` (one rounding, as the kernel scales);
* the lowest ``d`` of the smallest ``agg`` wins; ``second`` is the smallest
  ``agg`` with ``|d - bestd| > 1``; ``c0, c1, c2`` are ``agg`` around
  ``bm = clip(bestd, 1, D - 2)`` and the subpixel step is
  ``0.5 (c0 - c2) / (c0 - 2 c1 + c2)`` where ``|denom| > 1e-6``, clipped to
  +-1;
* the right-image winner ``bestRd(x)`` is the lowest argmin over d of
  ``agg(x + d, d)`` (1e9 past the right edge), and
  ``dR(x) = bestRd(x - bestd(x))`` (0 left of the image);
* a pixel is valid when ``best <= uniqueness * second``,
  ``|bestd - dR| <= lr_thresh`` and ``0 < bestd < D - 1``.

* CUDA tensors: the kernel in ``csrc/stereo_wta.cu``, one launch, one
  block per band of full-width rows, the cost volume kept on chip; no
  device scratch. :func:`band_config` gives its band geometry and refuses
  what it does not take (``agg_radius`` over :data:`MAX_RADIUS`,
  ``max_disp`` over :data:`MAX_DISP`, images wider than
  ``2 * MAX_THREADS - 2 * agg_radius`` columns).
* CPU tensors: :func:`disparity_wta_plain`.

The two agree bit for bit: the cost sums are integers, and both round the
same float32 steps once each, in the same order.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build, round_up
from .hamming import _POP8

INVALID_COST = 1000   # cost of a column with no right-image partner
BIG = 1e9             # cost of a right-image candidate past the edge

# launches of the CUDA kernel (one per wrapper call that reaches the card)
launches = 0

# the kernel's limits: box radii it is instantiated for, disparities its
# sweep keys hold (13 bits beside an 18-bit box sum), threads per block,
# and an H100 block's dynamic shared memory (227 KB)
MAX_RADIUS = 7
MAX_DISP = 8192
MAX_THREADS = 704
SMEM_PER_BLOCK = 232_448


class Band(NamedTuple):
    """Geometry of the kernel's blocks for one image width."""
    rows: int             # output rows per block (TH)
    cols_per_thread: int  # columns each thread owns
    threads: int          # threads per block
    smem_bytes: int       # dynamic shared memory per block


def band_config(w: int, agg_radius: int, max_disp: int = 64) -> Band:
    """The kernel's band for images ``w`` columns wide (``csrc/stereo_wta.cu``).

    Each block owns 4 full-width rows (2 where one thread per column of the
    band and its 2r halo columns would exceed ``MAX_THREADS``, and each
    thread then takes two columns). In stage 1 a thread forms one column's
    raw costs and vertical box sums; in stage 2 it owns 4 adjacent output
    pixels of one row. Shared memory holds the vertical sums of two
    disparities, double-buffered (rows padded for 16-B loads), the
    right-image winners
    (box sum and d packed in one key) and the right census rows with their
    r-row halo."""
    r = agg_radius
    if not 0 <= r <= MAX_RADIUS:
        raise ValueError(f"agg_radius={r}: the CUDA kernel takes 0.."
                         f"{MAX_RADIUS}")
    if max_disp > MAX_DISP:
        raise ValueError(f"max_disp={max_disp}: the CUDA kernel takes at "
                         f"most {MAX_DISP}")
    cols = w + 2 * r
    cpt = 1 if cols <= MAX_THREADS else 2
    if cols > cpt * MAX_THREADS:
        raise ValueError(f"width {w} with agg_radius {r}: the CUDA kernel "
                         f"takes at most {2 * MAX_THREADS - 2 * r} columns")
    rows = 4 if cpt == 1 else 2
    w4 = -(-w // 4)
    threads = round_up(max(rows * w4, -(-cols // cpt)), 32)
    sums_read = round_up(4 + 2 * r, 4)
    row_stride = 4 * w4 + sums_read - 4
    smem = 4 * (4 * rows * row_stride + 2 * rows * 4 * w4 + (rows + 2 * r) * w)
    if threads > MAX_THREADS or smem > SMEM_PER_BLOCK:
        raise ValueError(f"width {w} with agg_radius {r} needs {threads} "
                         f"threads and {smem} B of shared memory a block")
    return Band(rows, cpt, threads, smem)


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in the low 32 bits of an int64 tensor (byte table)."""
    pop = _POP8.to(x.device)
    out = pop[x & 0xFF]
    for s in (8, 16, 24):
        out = out + pop[(x >> s) & 0xFF]
    return out


def _check(cl: torch.Tensor, cr: torch.Tensor, max_disp: int) -> None:
    for t, name in ((cl, "census_l"), (cr, "census_r")):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name}: expected [H, W] int32 census words, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if cl.shape != cr.shape or cl.device != cr.device:
        raise ValueError("census_l and census_r must share shape and device")
    if max_disp < 3:
        raise ValueError(f"max_disp={max_disp}: needs at least 3 disparities "
                         "(the subpixel parabola reads d - 1, d, d + 1)")


def disparity_wta_plain(census_l: torch.Tensor, census_r: torch.Tensor,
                        max_disp: int = 64, agg_radius: int = 3,
                        uniqueness: float = 0.95,
                        lr_thresh: float = 1.5) -> torch.Tensor:
    """Plain PyTorch version: an integer [D, H, W] cost volume, integer box
    sums, the same float32 scale, and the same sweeps."""
    _check(census_l, census_r, max_disp)
    h, w = census_l.shape
    D, r = max_disp, agg_radius
    k = 2 * r + 1
    dev = census_l.device
    f32 = torch.float32
    a = census_l.to(torch.int64) & 0xFFFFFFFF
    b = census_r.to(torch.int64) & 0xFFFFFFFF
    raw = torch.full((D, h, w), INVALID_COST, dtype=torch.int32, device=dev)
    for d in range(min(D, w)):
        raw[d, :, d:] = _popcount32(a[:, d:] ^ b[:, :w - d]).to(torch.int32)
    # zero-padded separable box sum (integers: exact in any order)
    p = torch.nn.functional.pad(raw, (r, r, r, r))
    hs = sum(p[:, :, j:j + w] for j in range(k))
    vs = sum(hs[:, i:i + h, :] for i in range(k))
    agg = vs.to(f32) * torch.tensor(1.0 / (k * k), dtype=f32, device=dev)

    bestd = torch.argmin(agg, dim=0)                        # first minimum
    best = agg.gather(0, bestd[None])[0]
    didx = torch.arange(D, device=dev)[:, None, None]
    big = torch.tensor(BIG, dtype=f32, device=dev)
    second = torch.where((didx - bestd[None]).abs() > 1, agg, big).amin(0)
    bm = torch.clamp(bestd, 1, D - 2)
    c0 = agg.gather(0, (bm - 1)[None])[0]
    c1 = agg.gather(0, bm[None])[0]
    c2 = agg.gather(0, (bm + 1)[None])[0]

    agg_r = torch.full_like(agg, BIG)                       # agg(x + d, d)
    for d in range(min(D, w)):
        agg_r[d, :, :w - d] = agg[d, :, d:]
    best_rd = torch.argmin(agg_r, dim=0)
    xs = torch.arange(w, device=dev)[None, :]
    xr = xs - bestd
    d_r = torch.where(xr >= 0, best_rd.gather(1, xr.clamp(min=0)), 0)

    unique_ok = best <= torch.tensor(uniqueness, dtype=f32, device=dev) * second
    lr_ok = (bestd.to(f32) - d_r.to(f32)).abs() <= torch.tensor(
        lr_thresh, dtype=f32, device=dev)
    denom = c0 - c1 * 2.0 + c2
    delta = torch.where(denom.abs() > 1e-6, ((c0 - c2) * 0.5) / denom,
                        torch.zeros_like(denom))
    disp = bm.to(f32) + delta.clamp(-1.0, 1.0)
    valid = unique_ok & lr_ok & (bestd > 0) & (bestd < D - 1)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


def disparity_wta(census_l: torch.Tensor, census_r: torch.Tensor,
                  max_disp: int = 64, agg_radius: int = 3,
                  uniqueness: float = 0.95,
                  lr_thresh: float = 1.5) -> torch.Tensor:
    """[H, W] int32 census pair -> [H, W] float32 disparity (< 0 invalid)."""
    global launches
    _check(census_l, census_r, max_disp)
    if census_l.device.type == "cpu":
        return disparity_wta_plain(census_l, census_r, max_disp, agg_radius,
                                   uniqueness, lr_thresh)
    if census_l.device.type != "cuda":
        raise ValueError(f"unsupported device {census_l.device}")
    cl = census_l.contiguous()
    cr = census_r.contiguous()
    h, w = cl.shape
    dev = cl.device
    band = band_config(w, agg_radius, max_disp)
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    if h * w == 0:
        return out
    k = 2 * agg_radius + 1
    err = _lib().plvs_stereo_wta(
        cl.data_ptr(), cr.data_ptr(), out.data_ptr(), h, w, max_disp,
        agg_radius, 1.0 / (k * k), uniqueness, lr_thresh,
        band.cols_per_thread, band.threads, band.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "stereo_wta kernel")
    launches += 1
    return out


def _lib():
    lib = _build.load("stereo_wta")
    fn = lib.plvs_stereo_wta
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                       + [ctypes.c_float] * 3 + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
    return lib
