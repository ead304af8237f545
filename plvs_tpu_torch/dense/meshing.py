"""Isosurface extraction from the TSDF volume (marching tetrahedra).

Counterpart of plvs_tpu/dense/meshing.py. Each cube splits into 6
tetrahedra whose 16 sign cases reduce to two shapes (1 or 2 triangles), so
the extraction vectorizes over every surface cube at once. The device
gathers each listed block with its +x/+y/+z neighbour slabs into a padded
[S+1]^3 field and marks the surface cubes; the host (numpy) runs the
table-driven triangle generation on the fetched fields, as in JAX.

The padded tsdf is rounded to float16 on the device before the fetch, as
the JAX package does, so both packages interpolate the same field. Without
bucketed shapes to keep a compile cache small, the gather takes exactly
the listed blocks.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..utils.fetch import to_host
from .tsdf import BLOCK, TSDFVolume

# 6 tetrahedra per cube (corner indices into the cube's 8 corners).
# Cube corners indexed bit-wise: bit0=x, bit1=y, bit2=z.
_TETS = np.array(
    [
        [0, 5, 1, 6],
        [0, 1, 3, 6],
        [0, 3, 2, 6],
        [0, 2, 7, 6],
        [0, 7, 4, 6],
        [0, 4, 5, 6],
    ],
    np.int32,
)
_CORNER_OFF = np.array(
    [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)], np.int32
)  # (x, y, z)


def _build_tet_tables() -> np.ndarray:
    """[16, 2, 3, 2] per-sign-code triangle table: up to 2 triangles of 3
    vertices, each an (inside-corner, outside-corner) edge to interpolate;
    -1 marks absent triangles (1-in: fan over outs; 3-in: reversed; 2-2:
    quad split)."""
    tbl = np.full((16, 2, 3, 2), -1, np.int8)
    for c in range(1, 15):
        ins = [i for i in range(4) if (c >> i) & 1]
        outs = [i for i in range(4) if not (c >> i) & 1]
        if len(ins) == 1:
            a = ins[0]
            tbl[c, 0] = [(a, outs[0]), (a, outs[1]), (a, outs[2])]
        elif len(ins) == 3:
            a = outs[0]
            tbl[c, 0] = [(ins[0], a), (ins[2], a), (ins[1], a)]
        else:
            i0, i1 = ins
            o0, o1 = outs
            tbl[c, 0] = [(i0, o0), (i1, o0), (i1, o1)]
            tbl[c, 1] = [(i0, o0), (i1, o1), (i0, o1)]
    return tbl


_TET_TRI = _build_tet_tables()


def _interp(p0, p1, v0, v1):
    t = v0 / np.where(np.abs(v0 - v1) < 1e-12, 1e-12, v0 - v1)
    t = np.clip(t, 0.0, 1.0)[..., None]
    return p0 + t * (p1 - p0)


# padded-slab fills: neighbour offsets in (x, y, z) and the (z, y, x) slices
_NEIGHBOR_FILLS = [
    ((1, 0, 0), (slice(0, 8), slice(0, 8), 8), (slice(0, 8), slice(0, 8), 0)),
    ((0, 1, 0), (slice(0, 8), 8, slice(0, 8)), (slice(0, 8), 0, slice(0, 8))),
    ((0, 0, 1), (8, slice(0, 8), slice(0, 8)), (0, slice(0, 8), slice(0, 8))),
    ((1, 1, 0), (slice(0, 8), 8, 8), (slice(0, 8), 0, 0)),
    ((1, 0, 1), (8, slice(0, 8), 8), (0, slice(0, 8), 0)),
    ((0, 1, 1), (8, 8, slice(0, 8)), (0, 0, slice(0, 8))),
    ((1, 1, 1), (8, 8, 8), (0, 0, 0)),
]


def _gather_padded(tsdf, weight, idx, nbidx, min_weight: float = 1.0):
    """Device half of the mesher's data path: the listed blocks + their
    neighbour slabs as [S+1]^3 padded fields (missing neighbours: tsdf 1,
    weight 0) and the surface-cube mask (all 8 corners above ``min_weight``
    and a sign change). Returns (padded tsdf as float16, mask)."""
    S = BLOCK
    n = idx.shape[0]
    pt = torch.ones((n, S + 1, S + 1, S + 1), dtype=tsdf.dtype,
                    device=tsdf.device)
    pw = torch.zeros_like(pt)
    pt[:, :S, :S, :S] = tsdf[idx]
    pw[:, :S, :S, :S] = weight[idx]
    for j, (_, dst, src) in enumerate(_NEIGHBOR_FILLS):
        nb = nbidx[:, j]
        ok = nb >= 0
        tn = tsdf[torch.clamp(nb, min=0)][(slice(None),) + src]
        wn = weight[torch.clamp(nb, min=0)][(slice(None),) + src]
        okb = ok.reshape((-1,) + (1,) * (tn.dim() - 1))
        sel = (slice(None),) + dst
        pt[sel] = torch.where(okb, tn, pt[sel])
        pw[sel] = torch.where(okb, wn, pw[sel])
    vmin = torch.full((n, S, S, S), float("inf"), dtype=tsdf.dtype,
                      device=tsdf.device)
    vmax = -vmin
    wmin = vmin
    for ox, oy, oz in _CORNER_OFF.tolist():
        sub_t = pt[:, oz:oz + S, oy:oy + S, ox:ox + S]
        sub_w = pw[:, oz:oz + S, oy:oy + S, ox:ox + S]
        vmin = torch.minimum(vmin, sub_t)
        vmax = torch.maximum(vmax, sub_t)
        wmin = torch.minimum(wmin, sub_w)
    mask = (wmin > min_weight) & (vmin < 0) & (vmax > 0)
    return pt.to(torch.float16), mask


def _padded_fields_dispatch(volume: TSDFVolume, slots: np.ndarray,
                            min_weight: float = 1.0):
    """Dispatch half of the padded-field gather: neighbour slots looked up
    in the host block table, the gather queued on the device. Returns the
    device tensors (pt_f16 [n, 9, 9, 9], mask [n, 8, 8, 8])."""
    n = len(slots)
    coords = volume.block_coords[slots]
    bmap = volume.block_map
    nb_idx = np.full((n, len(_NEIGHBOR_FILLS)), -1, np.int64)
    for j, (off, _, _) in enumerate(_NEIGHBOR_FILLS):
        for i in range(n):
            nb = bmap.get((int(coords[i, 0] + off[0]),
                           int(coords[i, 1] + off[1]),
                           int(coords[i, 2] + off[2])))
            if nb is not None:
                nb_idx[i, j] = nb
    d = volume._dev
    dev = d["tsdf"].device
    return _gather_padded(
        d["tsdf"], d["weight"],
        torch.from_numpy(np.asarray(slots, np.int64)).to(dev),
        torch.from_numpy(nb_idx).to(dev), min_weight=float(min_weight))


def _padded_fields(volume: TSDFVolume, slots: np.ndarray,
                   min_weight: float = 1.0):
    pt, mask = to_host(_padded_fields_dispatch(volume, slots, min_weight))
    return np.asarray(pt, np.float32), mask


def _extract_triangles(volume: TSDFVolume, slots: np.ndarray,
                       min_weight: float = 1.0):
    """Marching-tetrahedra triangles for a subset of blocks: (tri [F, 3, 3]
    float32, tri_slot [F] int32, the slot that produced each triangle)."""
    slots = np.asarray(slots, np.int64)
    if len(slots) == 0:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0,), np.int32)
    tsdf, cube_mask = _padded_fields(volume, slots, min_weight)
    return _triangles_from_fields(volume, slots, tsdf, cube_mask)


def _triangles_from_fields(volume: TSDFVolume, slots: np.ndarray,
                           tsdf: np.ndarray, cube_mask: np.ndarray):
    """Host half of marching tetrahedra, given the fetched padded fields."""
    S = BLOCK
    vs = volume.voxel_size
    b, zi, yi, xi = np.nonzero(cube_mask)
    if len(b) == 0:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0,), np.int32)

    # corner values for the surface cubes only
    M = len(b)
    cval = np.empty((M, 8), np.float32)
    for ci, (ox, oy, oz) in enumerate(_CORNER_OFF):
        cval[:, ci] = tsdf[b, zi + oz, yi + oy, xi + ox]

    # cube corner world positions [M, 8, 3]
    base = (
        volume.block_coords[slots[b]] * (S * vs)
        + (np.stack([xi, yi, zi], -1) + 0.5) * vs
    )
    cpos = base[:, None, :] + _CORNER_OFF[None, :, :] * vs

    # table-driven over all M cubes x 6 tets
    P6 = cpos[:, _TETS].reshape(-1, 4, 3)      # [M*6, 4, 3]
    V6 = cval[:, _TETS].reshape(-1, 4)         # [M*6, 4]
    inside = V6 < 0
    code = (inside[:, 0].astype(np.int32) | (inside[:, 1] << 1)
            | (inside[:, 2] << 2) | (inside[:, 3] << 3))
    tet_slot = np.repeat(b, len(_TETS))

    verts_out = []
    slot_out = []
    for s in range(2):
        tbl = _TET_TRI[code, s]                # [M*6, 3, 2]
        idx = np.nonzero(tbl[:, 0, 0] >= 0)[0]
        if not len(idx):
            continue
        t = tbl[idx].astype(np.int64)          # [K, 3, 2]
        va = np.take_along_axis(V6[idx], t[..., 0], axis=1)   # [K, 3]
        vb = np.take_along_axis(V6[idx], t[..., 1], axis=1)
        pa = np.take_along_axis(P6[idx], t[..., 0:1].repeat(3, -1), axis=1)
        pb = np.take_along_axis(P6[idx], t[..., 1:2].repeat(3, -1), axis=1)
        verts_out.append(_interp(pa, pb, va, vb))
        slot_out.append(tet_slot[idx])

    if not verts_out:
        return np.zeros((0, 3, 3), np.float32), np.zeros((0,), np.int32)
    tri = np.concatenate(verts_out).astype(np.float32)  # [F, 3, 3]
    tri_slot = slots[np.concatenate(slot_out)].astype(np.int32)
    return tri, tri_slot


def marching_tetrahedra(volume: TSDFVolume, min_weight: float = 1.0):
    """Extract the full triangle mesh. Returns (vertices [V,3], faces [F,3])."""
    n = volume.n_blocks
    if n == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    tri, _ = _extract_triangles(volume, np.arange(n), min_weight)
    V = tri.reshape(-1, 3)
    F = np.arange(len(V), dtype=np.int32).reshape(-1, 3)
    return V, F


def sample_tsdf(volume: TSDFVolume, pts: np.ndarray) -> np.ndarray:
    """Nearest-voxel TSDF value at world points [N, 3] (1.0 where the block
    is unallocated); the gather runs on the device."""
    out = np.ones(len(pts), np.float32)
    if volume.n_blocks == 0 or len(pts) == 0:
        return out
    volume.flush_touched()
    slot, vox = volume._voxel_slots(pts)
    ok = slot >= 0
    if ok.any():
        i = torch.from_numpy(np.stack([slot[ok], vox[ok, 2], vox[ok, 1],
                                       vox[ok, 0]])).to(volume.device)
        out[ok] = to_host(volume._dev["tsdf"][i[0], i[1], i[2], i[3]])
    return out


def vertex_normals(volume: TSDFVolume, V: np.ndarray) -> np.ndarray:
    """Per-vertex surface normals from the TSDF gradient (central
    differences at one-voxel spacing), pointing from inside (tsdf < 0)
    toward free space."""
    if len(V) == 0:
        return np.zeros((0, 3), np.float32)
    h = volume.voxel_size
    g = np.empty((len(V), 3), np.float32)
    for a in range(3):
        e = np.zeros(3, np.float32)
        e[a] = h
        g[:, a] = sample_tsdf(volume, V + e) - sample_tsdf(volume, V - e)
    nrm = np.linalg.norm(g, axis=1, keepdims=True)
    return (g / np.maximum(nrm, 1e-12)).astype(np.float32)


class IncrementalMesher:
    """Per-block cached meshing: only blocks whose TSDF changed since their
    last extraction (or whose +x/+y/+z neighbour changed — the padded seam
    dependency) are re-meshed; the rest is served from the cache. A budget
    bounds the blocks extracted per update; the remainder waits in a FIFO
    queue for later updates."""

    def __init__(self, volume: TSDFVolume, min_weight: float = 1.0):
        self.volume = volume
        self.min_weight = min_weight
        self._block_tris: dict[int, np.ndarray] = {}  # slot -> [F,3,3]
        self._meshed_version: dict[int, int] = {}
        self._queue: list[int] = []
        self._queued: set[int] = set()
        self.last_n_remeshed = 0
        self.pending = 0          # dirty blocks deferred by the last budget
        self.stopwatch = None     # optional stage timing (.scope(name))

    def _scope(self, name: str):
        if self.stopwatch is None:
            return contextlib.nullcontext()
        return self.stopwatch.scope(name)

    def _dirty_slots(self) -> np.ndarray:
        vol = self.volume
        vol.flush_touched()  # apply deferred changed-block version bumps
        n = vol.n_blocks
        ver = vol.block_version[:n]
        coords = vol.block_coords[:n]
        meshed = np.array([self._meshed_version.get(s, -1)
                           for s in range(n)], np.int64)
        dirty = ver > meshed
        # seam dependency: a block's padded faces read its +offset
        # neighbours, so a changed block also dirties the blocks that read it
        changed = np.nonzero(dirty)[0]
        extra = set()
        for s in changed:
            c = coords[s]
            for off, _, _ in _NEIGHBOR_FILLS:
                nb = vol.block_map.get(
                    (int(c[0] - off[0]), int(c[1] - off[1]),
                     int(c[2] - off[2])))
                if nb is not None and not dirty[nb]:
                    extra.add(nb)
        if extra:
            dirty[list(extra)] = True
        return np.nonzero(dirty)[0]

    def update_begin(self, budget: int | None = None):
        """Stage 1 of a budgeted update: fold fresh dirty blocks into the
        FIFO queue, take up to ``budget`` of them and dispatch their
        padded-field gather. Returns a ctx for :meth:`update_finish` (its
        ``out`` is the device tuple to fetch), or None when nothing needs
        meshing."""
        vol = self.volume
        with self._scope("dense.mesh.dirty"):
            for s in self._dirty_slots():
                s = int(s)
                if s not in self._queued:
                    self._queued.add(s)
                    self._queue.append(s)
            if budget is not None and budget < len(self._queue):
                take, self._queue = (self._queue[:budget],
                                     self._queue[budget:])
            else:
                take, self._queue = self._queue, []
            for s in take:
                self._queued.discard(s)
            self.pending = len(self._queue)
            slots = np.asarray(sorted(s for s in take
                                      if s < vol.n_blocks), np.int64)
        self.last_n_remeshed = len(slots)
        if not len(slots):
            return None
        # snapshot versions now: a later integrate's content is not in the
        # gathered fields and must stay dirty for the next update
        return {"slots": slots,
                "versions": vol.block_version[slots].copy(),
                "out": _padded_fields_dispatch(vol, slots, self.min_weight)}

    def update_finish(self, ctx, fetched=None):
        """Stage 2: host-side marching tetrahedra over the gathered fields +
        per-block cache refresh. ``fetched``: the host (pt, mask) of
        ctx['out'] when another stage fetched it."""
        vol = self.volume
        if ctx is not None:
            slots = ctx["slots"]
            pt, mask = (fetched if fetched is not None
                        else to_host(ctx["out"]))
            tri, tri_slot = _triangles_from_fields(
                vol, slots, np.asarray(pt, np.float32), np.asarray(mask))
            order = np.argsort(tri_slot, kind="stable")
            tri_s = tri[order]
            slot_s = tri_slot[order]
            bounds = np.searchsorted(slot_s, np.asarray(slots, slot_s.dtype))
            bounds_hi = np.searchsorted(slot_s,
                                        np.asarray(slots, slot_s.dtype),
                                        side="right")
            for s, v, lo, hi in zip(slots, ctx["versions"], bounds,
                                    bounds_hi):
                self._block_tris[int(s)] = tri_s[lo:hi]
                self._meshed_version[int(s)] = int(v)
        # drop cache entries for blocks that no longer exist (reset)
        live = vol.n_blocks
        for s in [k for k in self._block_tris if k >= live]:
            del self._block_tris[s]
            self._meshed_version.pop(s, None)

    def update(self, assemble: bool = True, budget: int | None = None):
        """Re-mesh dirty blocks; returns (vertices [V,3], faces [F,3]) of
        the full cached mesh (``assemble=False``: (None, None), the caches
        only). ``budget`` bounds the blocks extracted this call."""
        ctx = self.update_begin(budget)
        with self._scope("dense.mesh.extract"):
            self.update_finish(ctx)
        if not assemble:
            return None, None
        tris = [t for t in self._block_tris.values() if len(t)]
        if not tris:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
        V = np.concatenate(tris).reshape(-1, 3)
        F = np.arange(len(V), dtype=np.int32).reshape(-1, 3)
        return V, F

    @property
    def n_triangles(self) -> int:
        """Triangles in the per-block cache."""
        return int(sum(len(t) for t in self._block_tris.values()))

    def invalidate(self):
        """Forget all cached blocks (after a volume reset)."""
        self._block_tris.clear()
        self._meshed_version.clear()
        self._queue.clear()
        self._queued.clear()
        self.pending = 0


def save_mesh_ply(path: str, V: np.ndarray, F: np.ndarray):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(V)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write(f"element face {len(F)}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        for p in V:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
        for t in F:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
