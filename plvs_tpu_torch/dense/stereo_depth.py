"""Dense rectified-stereo disparity: census cost, aggregation, WTA.

Counterpart of plvs_tpu/dense/stereo_depth.py. ``census_transform`` (5x5
census, wrap-around at the borders as in JAX), then one of two methods:

* "box": the fused cost-aggregation + winner-take-all step (kernel K3,
  ``ops/stereo.py``: the CUDA kernel for CUDA tensors, its plain version
  for CPU tensors). K3 has the TPU kernel's border semantics, not those of
  the JAX package's jnp volume path (which the JAX package runs on the
  CPU): a sparse set of image-border pixels can flip validity between the
  two (ROADMAP.md queue 3, "Stereo borders").
* "sgm": 4-path semi-global aggregation. The JAX package runs it on its jnp
  cost volume on every backend, never through its kernel, so the port runs
  the same volume, aggregation and winner-take-all tail in plain PyTorch on
  every device (``_cost_volume``, ``sgm_aggregate``, ``_wta_volume``), with
  the jnp path's border semantics. Each scan direction is a loop over the
  image axis of elementwise launches; the two directions of an axis run as
  one batch.

Both end with the 3x3 median post-filter, plain PyTorch as in JAX.
"""

from __future__ import annotations

import torch

from ..ops import hamming as hamming_ops
from ..ops import stereo as stereo_ops


def census_transform(img: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Census bit-string per pixel, packed into int32 words (the bit
    patterns of the JAX package's uint32); window=2 -> 5x5 -> 24 bits."""
    out = torch.zeros(img.shape, dtype=torch.int32, device=img.device)
    i = 0
    for dy in range(-window, window + 1):
        for dx in range(-window, window + 1):
            if (dy == 0 and dx == 0) or i >= 32:
                continue
            shifted = torch.roll(img, (-dy, -dx), (0, 1))
            out = out | ((shifted < img).to(torch.int32) << i)
            i += 1
    return out


def _median3(disp: torch.Tensor) -> torch.Tensor:
    """3x3 median (wrap-around neighbours) applied to valid pixels only."""
    neigh = torch.stack([torch.roll(disp, (dy, dx), (0, 1))
                         for dy in (-1, 0, 1) for dx in (-1, 0, 1)])
    med = neigh.median(dim=0).values   # 9 values: the exact middle one
    return torch.where(disp > 0, med, disp)


def _box_filter(x: torch.Tensor, r: int) -> torch.Tensor:
    """Mean over a (2r+1)^2 window of the last two axes, zero padding
    ("SAME"); the sum of the shifted copies, then one division."""
    k = 2 * r + 1
    h, w = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (r, r, r, r))
    acc = torch.zeros_like(x)
    for dy in range(k):
        for dx in range(k):
            acc = acc + xp[..., dy:dy + h, dx:dx + w]
    return acc / torch.tensor(float(k * k), dtype=x.dtype, device=x.device)


def _sgm_scan_lr(vol_sbd: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Directional SGM aggregation along the leading (scan) axis of
    ``vol_sbd`` [S, B, D] (scan position, batch, disparity):

        L(x, d) = C(x, d) + min(L(x-1, d), L(x-1, d+-1) + P1,
                                min_d' L(x-1, d') + P2) - min_d' L(x-1, d')
    """
    out = torch.empty_like(vol_sbd)
    big = torch.full_like(vol_sbd[0, :, :1], 1e9)
    L = vol_sbd[0]
    out[0] = L
    for s in range(1, vol_sbd.shape[0]):
        lmin = L.amin(dim=-1, keepdim=True)
        up = torch.cat([L[..., 1:], big], -1)
        dn = torch.cat([big, L[..., :-1]], -1)
        m = torch.minimum(torch.minimum(L, torch.minimum(up, dn) + p1),
                          lmin + p2)
        L = vol_sbd[s] + m - lmin
        out[s] = L
    return out


def _scan_both_ways(v: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """Forward scan + backward scan along axis 0 of [S, B, D], the two run
    as one batch of 2B."""
    b = v.shape[1]
    both = _sgm_scan_lr(torch.cat([v, v.flip(0)], 1), p1, p2)
    return both[:, :b] + both[:, b:].flip(0)


def sgm_aggregate(vol: torch.Tensor, p1: float = 7.0,
                  p2: float = 100.0) -> torch.Tensor:
    """4-path semi-global aggregation of a [D, H, W] cost volume: the mean
    of the left-right, right-left, top-down and bottom-up path costs."""
    horiz = _scan_both_ways(vol.permute(2, 1, 0), p1, p2)    # [W, H, D]
    vert = _scan_both_ways(vol.permute(1, 2, 0), p1, p2)     # [H, W, D]
    agg = horiz.permute(2, 1, 0) + vert.permute(2, 0, 1)
    return agg / torch.tensor(4.0, dtype=agg.dtype, device=agg.device)


def _cost_volume(cl: torch.Tensor, cr: torch.Tensor,
                 max_disp: int) -> torch.Tensor:
    """[D, H, W] census Hamming costs, left (y, x) against right (y, x - d);
    the wrapped-around columns x < d cost 1e3."""
    pop = hamming_ops._POP8.to(cl.device)
    vol = []
    for d in range(max_disp):
        x = (cl ^ torch.roll(cr, d, 1)).to(torch.int64) & 0xFFFFFFFF
        c = sum(pop[(x >> s) & 0xFF].to(torch.int32)
                for s in (0, 8, 16, 24)).to(torch.float32)
        c[:, :d] = 1e3
        vol.append(c)
    return torch.stack(vol)


def _wta_volume(vol: torch.Tensor, uniqueness: float,
                lr_thresh: float) -> torch.Tensor:
    """Winner-take-all on an aggregated [D, H, W] volume: uniqueness against
    the best cost outside +-1, parabolic subpixel refinement, and a
    left-right check against a right-image WTA from the same volume.
    Disparity [H, W], -1 where invalid."""
    D, _, w = vol.shape
    f32 = torch.float32
    best = torch.argmin(vol, dim=0)
    cbest = vol.amin(dim=0)
    didx = torch.arange(D, device=vol.device)[:, None, None]
    masked = torch.where((didx - best[None]).abs() <= 1,
                         torch.full_like(vol, float("inf")), vol)
    unique_ok = cbest <= uniqueness * masked.amin(dim=0)
    bm = torch.clamp(best, 1, D - 2)
    c0 = vol.gather(0, (bm - 1)[None])[0]
    c1 = vol.gather(0, bm[None])[0]
    c2 = vol.gather(0, (bm + 1)[None])[0]
    denom = c0 - 2 * c1 + c2
    delta = torch.where(denom.abs() > 1e-6, 0.5 * (c0 - c2) / denom,
                        torch.zeros_like(denom))
    disp = bm.to(f32) + torch.clamp(delta, -1.0, 1.0)
    # cost_right(y, x, d) = cost_left(y, x + d, d)
    volR = torch.stack([torch.roll(vol[d], -d, 1) for d in range(D)])
    bestR = torch.argmin(volR, dim=0).to(f32)
    xs = torch.arange(w, device=vol.device)[None, :]
    xr = torch.clamp(xs - best, 0, w - 1)
    dR = bestR.gather(1, xr)
    lr_ok = (best.to(f32) - dR).abs() <= lr_thresh
    valid = unique_ok & lr_ok & (best > 0) & (best < D - 1)
    return torch.where(valid, disp, torch.full_like(disp, -1.0))


def disparity(left: torch.Tensor, right: torch.Tensor, max_disp: int = 64,
              census_window: int = 2, agg_radius: int = 3,
              lr_thresh: float = 1.5, uniqueness: float = 0.95,
              method: str = "box", p1: float = 7.0,
              p2: float = 100.0) -> torch.Tensor:
    """Rectified pair [H, W] float32 -> float disparity map (<= 0 invalid)."""
    if method not in ("box", "sgm"):
        raise ValueError(f"unknown disparity method {method!r}")
    cl = census_transform(left, census_window)
    cr = census_transform(right, census_window)
    if method == "sgm":
        vol = sgm_aggregate(_box_filter(_cost_volume(cl, cr, max_disp), 1),
                            p1=p1, p2=p2)
        return _median3(_wta_volume(vol, uniqueness, lr_thresh))
    disp = stereo_ops.disparity_wta(cl, cr, max_disp=max_disp,
                                    agg_radius=agg_radius,
                                    uniqueness=uniqueness,
                                    lr_thresh=lr_thresh)
    return _median3(disp)


def disparity_to_depth(disp: torch.Tensor, bf: float) -> torch.Tensor:
    """depth = bf / disparity where the disparity is positive, else 0
    (a float32 division, as in JAX; ``float / tensor`` in PyTorch would
    multiply by a rounded reciprocal)."""
    bf_t = torch.full_like(disp, bf)
    return torch.where(disp > 0, bf_t / torch.clamp(disp, min=1e-6),
                       torch.zeros_like(disp))
