"""Euclidean signed distance field (ESDF) from the fused TSDF map.

Counterpart of plvs_tpu/dense/esdf.py. The field is computed over the
occupied bounding box by jump flooding: every voxel keeps the coordinates
of its nearest seed so far, and passes with strides n/2, n/4, ..., 1 (then
one clean-up pass at stride 1) offer it the seeds of its 26 neighbours at
that stride. The rolls wrap around, as in JAX: a wrapped-in seed keeps
its own coordinates, so the distance test takes it only where it is truly
nearer. Plain PyTorch on every device (the JAX package's is plain
``jnp``): about 8 elementwise launches per offset, 26 offsets per pass.
``esdf_from_tsdf`` and ``query_esdf`` are host-side numpy around it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.fetch import to_host
from . import tsdf as tsdf_mod

_OFFSETS = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1) if (dx, dy, dz) != (0, 0, 0)]


def jfa_steps(shape, max_steps: int = 0) -> int:
    """Strided passes of :func:`esdf_jfa` on a grid of ``shape`` (the
    clean-up pass not counted)."""
    n = max(shape)
    return max_steps or max(1, int(np.ceil(np.log2(max(n, 2)))))


def esdf_jfa(occupied: torch.Tensor, voxel_size: float,
             max_steps: int = 0) -> torch.Tensor:
    """Unsigned distance to the nearest occupied voxel on a dense
    [X, Y, Z] bool grid, in metres (float32; +inf without any seed)."""
    shape = occupied.shape
    steps = jfa_steps(shape, max_steps)
    dev = occupied.device
    big = 1e9
    ii, jj, kk = torch.meshgrid(
        *(torch.arange(s, device=dev) for s in shape), indexing="ij")
    coords = torch.stack([ii, jj, kk], -1).to(torch.float32)
    # occupied voxels point at themselves, the others at nowhere
    seed = torch.where(occupied[..., None], coords,
                       torch.full_like(coords, big))

    def dist2(s):
        d = s - coords
        return torch.where(s[..., 0] > big / 2,
                           torch.full_like(d[..., 0], big),
                           (d * d).sum(-1))

    def one_pass(seed, stride):
        best = seed
        best_d = dist2(seed)
        for dx, dy, dz in _OFFSETS:
            cand = torch.roll(seed, (dx * stride, dy * stride, dz * stride),
                              (0, 1, 2))
            d = dist2(cand)
            take = d < best_d
            best = torch.where(take[..., None], cand, best)
            best_d = torch.where(take, d, best_d)
        return best

    stride = 1 << (steps - 1)
    for _ in range(steps):
        seed = one_pass(seed, max(stride, 1))
        stride //= 2
    seed = one_pass(seed, 1)  # clean-up pass (JFA+1)
    d2 = dist2(seed)
    return torch.where(d2 > big / 2, torch.full_like(d2, float("inf")),
                       torch.sqrt(d2) * voxel_size)


def esdf_from_tsdf(vol: tsdf_mod.TSDFVolume, tsdf_eps: float = 0.25,
                   min_weight: float = 1.0, margin: int = 8):
    """Dense ESDF over the volume's occupied bounding box (``margin`` voxels
    around it): (origin [3] world coordinates of the grid corner, grid
    [X, Y, Z] float32 metres, sign [X, Y, Z] int8: -1 where the TSDF
    observed the inside, else +1)."""
    pts, _ = vol.occupied_cloud(tsdf_eps=tsdf_eps, min_weight=min_weight)
    if len(pts) == 0:
        return (np.zeros(3, np.float32), np.zeros((0, 0, 0), np.float32),
                np.zeros((0, 0, 0), np.int8))
    vs = vol.voxel_size
    idx = np.floor(pts / vs).astype(np.int64)
    lo = idx.min(0) - margin
    hi = idx.max(0) + margin + 1
    shape = tuple((hi - lo).tolist())
    occ = np.zeros(shape, bool)
    occ[tuple((idx - lo).T)] = True
    grid = to_host(esdf_jfa(torch.from_numpy(occ).to(vol.device), vs))

    sign = np.ones(shape, np.int8)
    n = vol.n_blocks
    S = tsdf_mod.BLOCK
    d = vol._dev
    inside = (d["tsdf"][:n] < 0) & (d["weight"][:n] > 0)
    b, zi, yi, xi = to_host(torch.nonzero(inside)).T
    if len(b):
        vidx = vol.block_coords[:n][b] * S + np.stack([xi, yi, zi], -1)
        keep = np.all((vidx >= lo) & (vidx < hi), axis=1)
        v = vidx[keep] - lo
        sign[v[:, 0], v[:, 1], v[:, 2]] = -1
    return lo.astype(np.float32) * vs, grid, sign


def query_esdf(origin: np.ndarray, grid: np.ndarray, voxel_size: float,
               pts_world: np.ndarray) -> np.ndarray:
    """Trilinear ESDF lookup at world points [N, 3] (+inf outside the
    grid)."""
    if grid.size == 0 or len(pts_world) == 0:
        return np.full(len(pts_world), np.inf, np.float32)
    g = (pts_world - origin) / voxel_size - 0.5
    lo = np.floor(g).astype(np.int64)
    f = (g - lo).astype(np.float32)
    out = np.full(len(pts_world), np.inf, np.float32)
    ok = np.all(lo >= 0, 1) & np.all(lo + 1 < np.asarray(grid.shape), 1)
    if not ok.any():
        return out
    l0 = lo[ok]
    fx, fy, fz = f[ok, 0], f[ok, 1], f[ok, 2]
    acc = np.zeros(ok.sum(), np.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                w = ((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                     * (fz if dz else 1 - fz))
                acc += w * grid[l0[:, 0] + dx, l0[:, 1] + dy, l0[:, 2] + dz]
    out[ok] = acc
    return out
