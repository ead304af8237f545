"""Voxel-block TSDF fusion: a host block table and a device projective update.

Counterpart of plvs_tpu/dense/tsdf.py. Fixed-capacity 8^3 voxel blocks hold
tsdf / weight / color; every voxel of every live block projects into the
depth image, gathers the measured depth, and takes the weighted TSDF
running average in one batched pass (a gather, so no scatter collisions).
Which blocks exist is host-side set arithmetic (numpy), as in JAX. With
``with_labels`` each voxel also holds a global segment label and its
confidence counter, fused by the same projective gather
(``integrate_labels``); ``remove_unstable`` carves voxels of old blocks
that never gathered enough weight.

The volume's state stays on the device across frames. Where the JAX package
donates its buffers to a jitted update and gets new ones back, the port
updates its tensors in place (slot ranges of the preallocated tensors),
which needs no second copy of the volume. Queries that read a few voxels
(``labels_at``) or the surface band (``occupied_cloud``,
``segmented_cloud``) select on the device and fetch only the hits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import cameras as cam_mod
from ..ops import resolve_device
from ..utils.fetch import to_host

BLOCK = 8  # voxels per block side
MESH_W = 1.0  # IncrementalMesher min_weight default
CHANGE_EPS = 0.01  # tsdf change that dirties a block (~sub-voxel shift)


def _next_bucket(n: int, floor: int, cap: int) -> int:
    """Round a live block count up to a power-of-two bucket (the slot range
    the update touches; slots past the live count are masked out)."""
    b = floor
    while b < n:
        b *= 2
    return min(b, cap)


def _project_voxels(block_coords, Rcw, tcw, cam, voxel_size, H, W):
    """Every voxel centre of ``B`` blocks in the camera: (uv [B, 512, 2],
    z [B, 512], vi, ui [B, 512] clamped nearest pixel). Voxel n of a block
    is (z, y, x) = (n // 64, n // 8 % 8, n % 8), the JAX package's
    layout."""
    S = BLOCK
    dev = block_coords.device
    f32 = torch.float32
    r = ((torch.arange(S, device=dev).to(f32) + 0.5)
         * torch.tensor(voxel_size, dtype=f32, device=dev))
    zz, yy, xx = torch.meshgrid(r, r, r, indexing="ij")
    offs = torch.stack([xx, yy, zz], -1).reshape(-1, 3)   # [S^3, 3] (x,y,z)
    origin = block_coords.to(f32) * torch.tensor(S * voxel_size, dtype=f32,
                                                  device=dev)
    Xw = origin[:, None, :] + offs[None, :, :]
    Xc = torch.einsum("ij,bnj->bni", Rcw, Xw) + tcw
    uv = cam_mod.project(cam, Xc)
    # torch.round, like jnp.round, rounds half to even
    ui = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, W - 1)
    vi = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, H - 1)
    return uv, Xc[..., 2], vi, ui


def _tsdf_update(block_coords, tsdf, weight, color, depth_img, color_img,
                 Rcw, tcw, cam, voxel_size, trunc, max_weight=100.0,
                 block_valid=None):
    """Projective TSDF update of ``B`` blocks against one depth frame.
    Returns (tsdf, weight, color) of the same shapes; the inputs are not
    modified."""
    B = block_coords.shape[0]
    dev = tsdf.device

    def c(v):  # a float32 constant on the device: tensor-tensor arithmetic
        return torch.tensor(v, dtype=torch.float32, device=dev)

    H, W = depth_img.shape
    uv, z, vi, ui = _project_voxels(block_coords, Rcw, tcw, cam, voxel_size,
                                    H, W)
    d = depth_img[vi, ui]
    col = color_img[vi, ui]
    if color_img.dim() == 2:
        col = col[..., None]   # grayscale broadcast into the RGB volume

    tr = c(trunc)
    zero = c(0.0)
    in_img = cam_mod.in_image(cam, uv) & (z > 0.05) & (d > 0.0)
    sdf = d - z
    upd = in_img & (sdf > -tr)
    tsdf_new = torch.clamp(sdf / tr, -1.0, 1.0)
    # tapered weight behind the surface (voxblox-style)
    w_new = torch.where(sdf < 0, torch.maximum((tr + sdf) / tr, zero),
                        c(1.0))
    w_new = torch.where(upd, w_new, zero)
    if block_valid is not None:
        w_new = torch.where(block_valid[:, None], w_new, zero)

    w_old = weight.reshape(B, -1)
    t_old = tsdf.reshape(B, -1)
    c_old = color.reshape(B, -1, 3)
    w_sum = w_old + w_new
    w_safe = torch.clamp(w_sum, min=1e-6)
    t_out = (t_old * w_old + tsdf_new * w_new) / w_safe
    c_out = ((c_old * w_old[..., None] + col * w_new[..., None])
             / w_safe[..., None])
    w_out = torch.minimum(w_sum, c(max_weight))
    return (t_out.reshape(tsdf.shape), w_out.reshape(weight.shape),
            c_out.reshape(color.shape))


def _integrate_resident(coords_full, tsdf_full, weight_full, color_full,
                        n_valid: int, depth_img, color_img, Rcw, tcw, cam,
                        voxel_size: float, trunc: float, nb: int):
    """Update the first ``nb`` slots of the device-resident block table in
    place (slots from ``n_valid`` on are masked out) and return the
    per-block meaningful-change mask [nb]: a block is dirty when its tsdf
    moved by more than CHANGE_EPS somewhere or a voxel just crossed the
    mesher's validity weight — weight-only accumulation on a converged
    surface must not dirty it, or the incremental mesher re-extracts the
    whole visible map per keyframe."""
    dev = tsdf_full.device
    valid = torch.arange(nb, device=dev) < n_valid
    t_old, w_old = tsdf_full[:nb], weight_full[:nb]
    t, w, c = _tsdf_update(
        coords_full[:nb], t_old, w_old, color_full[:nb], depth_img,
        color_img, Rcw, tcw, cam, voxel_size, trunc, block_valid=valid)
    changed = (((t - t_old).abs() > CHANGE_EPS).flatten(1).any(1)
               | ((w_old <= MESH_W) & (w > MESH_W)).flatten(1).any(1))
    tsdf_full[:nb] = t
    weight_full[:nb] = w
    color_full[:nb] = c
    return changed


def _label_update(block_coords, label, label_conf, depth_img, label_img, Rcw,
                  tcw, cam, voxel_size, trunc, max_conf=64.0,
                  block_valid=None):
    """Per-voxel label confidence fusion of ``B`` blocks against one label
    image, in the observation's surface band: observing the stored label
    raises its confidence (up to ``max_conf``), a conflicting label lowers
    it, and the label flips to the observed one once the confidence is
    exhausted. Returns (label, label_conf); the inputs are not modified."""
    B = block_coords.shape[0]
    H, W = depth_img.shape
    uv, z, vi, ui = _project_voxels(block_coords, Rcw, tcw, cam, voxel_size,
                                    H, W)
    d = depth_img[vi, ui]
    lbl_new = label_img[vi, ui]
    in_band = (cam_mod.in_image(cam, uv) & (z > 0.05) & (d > 0.0)
               & ((d - z).abs() < trunc) & (lbl_new > 0))
    if block_valid is not None:
        in_band = in_band & block_valid[:, None]
    l_old = label.reshape(B, -1)
    c_old = label_conf.reshape(B, -1)
    same = l_old == lbl_new
    unlabeled = l_old == 0
    one = torch.ones_like(c_old)
    c_out = torch.where(same, torch.clamp(c_old + 1.0, max=max_conf),
                        c_old - 1.0)
    c_out = torch.where(unlabeled, one, c_out)
    flip = (~same) & (~unlabeled) & (c_out <= 0.0)
    l_out = torch.where(unlabeled | flip, lbl_new, l_old)
    c_out = torch.where(flip, one, c_out)
    l_out = torch.where(in_band, l_out, l_old)
    c_out = torch.where(in_band, c_out, c_old)
    return l_out.reshape(label.shape), c_out.reshape(label_conf.shape)


@dataclasses.dataclass
class TSDFVolume:
    """Host-managed block table + device-batched integration."""

    cam: cam_mod.Camera
    voxel_size: float = 0.02
    trunc_factor: float = 4.0      # truncation = factor * voxel_size
    max_blocks: int = 8192
    depth_subsample: int = 4       # allocation raycast stride
    max_depth: float = 8.0
    bucket_floor: int = 512        # floor of the updated slot range
    with_labels: bool = False      # per-voxel segment labels
    device: str | torch.device = "cuda"

    def __post_init__(self):
        S = BLOCK
        self.device = resolve_device(self.device)
        self.block_map: dict[tuple, int] = {}
        self.block_coords = np.zeros((self.max_blocks, 3), np.int32)
        self.n_blocks = 0
        # per-block bookkeeping for incremental meshing and unstable-voxel
        # removal: frame counter, last-changed version, allocation frame
        self.frame_idx = 0
        self.block_version = np.zeros(self.max_blocks, np.int64)
        self.block_alloc_frame = np.zeros(self.max_blocks, np.int64)
        dev = self.device
        self._dev = {
            "tsdf": torch.ones((self.max_blocks, S, S, S), device=dev),
            "weight": torch.zeros((self.max_blocks, S, S, S), device=dev),
            "color": torch.zeros((self.max_blocks, S, S, S, 3), device=dev),
        }
        if self.with_labels:
            self._dev["label"] = torch.zeros((self.max_blocks, S, S, S),
                                             dtype=torch.int32, device=dev)
            self._dev["label_conf"] = torch.zeros((self.max_blocks, S, S, S),
                                                  device=dev)
        self._coords_d = None          # device copy, refreshed on allocation
        self._mirror: dict | None = None  # lazy host copy for queries
        self._alloc_rays = None        # cached subsampled unprojection rays
        self._pending_touch = []       # deferred (frame_idx, changed-mask)

    @property
    def trunc(self):
        return self.trunc_factor * self.voxel_size

    def _put(self, x, dtype=torch.float32) -> torch.Tensor:
        """``dtype`` (float32 by default) on the volume's device (device
        tensors stay put)."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        return torch.from_numpy(np.asarray(x, np_dtype)).to(self.device)

    # -- host views (read-only; pulled lazily, invalidated by integrate) ----
    def _pull(self):
        self.flush_touched()
        if self._mirror is None:
            self._mirror = {k: to_host(v) for k, v in self._dev.items()}
        return self._mirror

    @property
    def tsdf(self):
        return self._pull()["tsdf"]

    @property
    def weight(self):
        return self._pull()["weight"]

    @property
    def color(self):
        return self._pull()["color"]

    @property
    def label(self):
        return self._pull()["label"]

    @property
    def label_conf(self):
        return self._pull()["label_conf"]

    def load_state(self, block_coords, tsdf, weight, color, label=None,
                   label_conf=None):
        """Replace the volume contents (checkpoint restore path); labels
        only where the volume keeps them."""
        n = len(block_coords)
        assert n <= self.max_blocks
        self.n_blocks = n
        self.block_coords[:] = 0
        self.block_coords[:n] = block_coords
        self.block_map = {tuple(c): i for i, c in
                          enumerate(np.asarray(block_coords).tolist())}
        self.frame_idx = 1
        self.block_version[:] = 0
        self.block_version[:n] = 1
        self.block_alloc_frame[:] = 0
        for key, init, val in (("tsdf", 1.0, tsdf), ("weight", 0.0, weight),
                               ("color", 0.0, color), ("label", 0, label),
                               ("label_conf", 0.0, label_conf)):
            if key not in self._dev:
                continue
            full = self._dev[key]
            full.fill_(init)
            if val is not None:
                full[:n] = self._put(val, full.dtype)
        self._coords_d = None
        self._mirror = None
        self._pending_touch = []

    # -- allocation ---------------------------------------------------------
    def _allocate_for_frame(self, depth: np.ndarray, Rcw: np.ndarray,
                            tcw: np.ndarray):
        """New blocks touched by the depth frame (truncation band around the
        back-projected surface), host-side set arithmetic."""
        h, w = depth.shape
        ss = self.depth_subsample
        vs, us = np.mgrid[0:h:ss, 0:w:ss]
        d = depth[vs, us]
        ok = (d > 0) & (d < self.max_depth)
        if not ok.any():
            return
        if self._alloc_rays is None or self._alloc_rays.shape[:2] != d.shape:
            uv_all = np.stack([us, vs], -1).astype(np.float32).reshape(-1, 2)
            self._alloc_rays = cam_mod.unproject(
                self.cam, torch.from_numpy(uv_all)).numpy().reshape(
                    *d.shape, 3)
        rays = self._alloc_rays[ok]
        Rwc = Rcw.T
        C = -Rwc @ tcw
        pts = []
        for dd in (-self.trunc, 0.0, self.trunc):
            Xc = rays * (d[ok, None] + dd)
            pts.append(Xc @ Rwc.T + C)
        P = np.concatenate(pts)
        bc = np.floor(P / (BLOCK * self.voxel_size)).astype(np.int64)
        # dedup via packed int64 keys (a 1-D sort, not a row-wise unique)
        OFF = 1 << 20
        key = (((bc[:, 0] + OFF) << 42) | ((bc[:, 1] + OFF) << 21)
               | (bc[:, 2] + OFF))
        ku = np.unique(key)
        uniq = np.stack([(ku >> 42) - OFF, ((ku >> 21) & 0x1FFFFF) - OFF,
                         (ku & 0x1FFFFF) - OFF], axis=1).astype(np.int32)
        n0 = self.n_blocks
        for c in map(tuple, uniq.tolist()):
            if c in self.block_map:
                continue
            if self.n_blocks >= self.max_blocks:
                continue  # capacity — stop allocating (bounded map)
            i = self.n_blocks
            self.block_map[c] = i
            self.block_coords[i] = c
            self.block_alloc_frame[i] = self.frame_idx
            self.n_blocks += 1
        if self.n_blocks != n0:
            self._coords_d = None  # device copy stale

    # -- integration --------------------------------------------------------
    def integrate(self, depth, color, Rcw: np.ndarray, tcw: np.ndarray,
                  alloc_depth: np.ndarray | None = None):
        """Fuse one registered frame. ``depth`` [H, W] metres and ``color``
        ([H, W, 3] or [H, W] gray) may be device tensors or numpy arrays;
        ``alloc_depth`` is the host depth that block allocation scans
        (defaults to ``depth`` fetched). Does not synchronise: the exact
        changed-block mask is fetched lazily at the first block_version
        read (flush_touched / dispatch_touched)."""
        if alloc_depth is None:
            alloc_depth = (to_host(depth) if isinstance(depth, torch.Tensor)
                           else np.asarray(depth))
        self._allocate_for_frame(alloc_depth, Rcw, tcw)
        n = self.n_blocks
        if n == 0:
            return
        if self._coords_d is None:
            self._coords_d = torch.from_numpy(self.block_coords).to(
                self.device)
        nb = _next_bucket(n, self.bucket_floor, self.max_blocks)
        d = self._dev
        changed = _integrate_resident(
            self._coords_d, d["tsdf"], d["weight"], d["color"], n,
            self._put(depth), self._put(color), self._put(Rcw),
            self._put(tcw), self.cam, self.voxel_size, self.trunc, nb)
        self._mirror = None
        self.frame_idx += 1
        self._pending_touch.append((self.frame_idx, changed))

    def flush_touched(self):
        """Apply deferred changed-block version bumps (fetched now)."""
        if not self._pending_touch:
            return
        pending, self._pending_touch = self._pending_touch, []
        self._apply_touched(pending, to_host([ch for _, ch in pending]))

    def dispatch_touched(self, submit):
        """Staged alternative to flush_touched: hand the pending changed-
        mask fetch to ``submit`` (fn(outs) -> future); pass the returned ctx
        to :meth:`apply_touched` a stage later. None when nothing is
        pending."""
        if not self._pending_touch:
            return None
        pending, self._pending_touch = self._pending_touch, []
        return (pending, submit(tuple(ch for _, ch in pending)))

    def apply_touched(self, ctx):
        if ctx is None:
            return
        pending, fut = ctx
        self._apply_touched(pending, fut.result())

    def _apply_touched(self, pending, masks):
        for (fidx, _), ch in zip(pending, masks):
            idx = np.nonzero(np.asarray(ch))[0]
            if len(idx):
                self.block_version[idx] = fidx

    def _mark_touched(self, Rcw: np.ndarray, tcw: np.ndarray, changed=None):
        """Bump the version of the blocks an integration pass changed:
        exactly those of ``changed`` (the per-block mask of
        _integrate_resident) when given, else every block within camera
        range (centre in front of the camera, within ``max_depth``, both
        widened by the block diagonal)."""
        if changed is not None:
            idx = np.nonzero(np.asarray(changed))[0]
            if len(idx):
                self.block_version[idx] = self.frame_idx
            return
        n = self.n_blocks
        S = BLOCK
        centers = (self.block_coords[:n].astype(np.float32) + 0.5) * (
            S * self.voxel_size)
        Xc = centers @ Rcw.T + tcw
        diag = S * self.voxel_size * np.sqrt(3.0)
        touched = (Xc[:, 2] > -diag) & (
            np.linalg.norm(Xc, axis=1) < self.max_depth + diag)
        self.block_version[:n][touched] = self.frame_idx

    def remove_unstable(self, min_weight: float = 2.0, min_age: int = 3):
        """Clear voxels that never accumulated ``min_weight`` in blocks at
        least ``min_age`` frames old (tsdf 1, weight 0): sporadic depth
        noise is dropped once it fails to be observed again."""
        n = self.n_blocks
        if n == 0:
            return
        old = (self.frame_idx - self.block_alloc_frame[:n]) >= min_age
        d = self._dev
        w = d["weight"][:n]
        unstable = ((w > 0.0) & (w < min_weight)
                    & torch.from_numpy(old).to(self.device)[:, None, None,
                                                            None])
        d["tsdf"][:n] = torch.where(unstable, torch.ones_like(w),
                                    d["tsdf"][:n])
        d["weight"][:n] = torch.where(unstable, torch.zeros_like(w), w)
        self._mirror = None
        self.block_version[:n][old] = self.frame_idx

    def integrate_labels(self, depth, label_img, Rcw: np.ndarray,
                         tcw: np.ndarray):
        """Fuse one frame's global label image [H, W] (int32, 0 = none)
        into the voxel labels (after ``integrate``, so the blocks exist)."""
        assert self.with_labels
        n = self.n_blocks
        if n == 0:
            return
        if self._coords_d is None:
            self._coords_d = torch.from_numpy(self.block_coords).to(
                self.device)
        nb = _next_bucket(n, 512, self.max_blocks)
        d = self._dev
        valid = torch.arange(nb, device=self.device) < n
        lab, conf = _label_update(
            self._coords_d[:nb], d["label"][:nb], d["label_conf"][:nb],
            self._put(depth), self._put(label_img, torch.int32),
            self._put(Rcw), self._put(tcw), self.cam, self.voxel_size,
            self.trunc, block_valid=valid)
        d["label"][:nb] = lab
        d["label_conf"][:nb] = conf
        self._mirror = None

    def _voxel_slots(self, pts_world: np.ndarray):
        """(block slot [N] int64, -1 where unallocated; voxel index [N, 3]
        (x, y, z) in the block) of each world point."""
        S = BLOCK
        bs = S * self.voxel_size
        bc = np.floor(pts_world / bs).astype(np.int32)
        vox = np.floor(pts_world / self.voxel_size).astype(np.int32) - bc * S
        vox = np.clip(vox, 0, S - 1)
        uniq, inv = np.unique(bc, axis=0, return_inverse=True)
        slot = np.array(
            [self.block_map.get(tuple(c), -1) for c in uniq.tolist()],
            np.int64)[inv.reshape(-1)]
        return slot, vox

    def labels_at(self, pts_world: np.ndarray) -> np.ndarray:
        """Stored global label at each world point's voxel (0 where its
        block is unallocated): the map side of the local-to-global label
        association. The gather runs on the device."""
        assert self.with_labels
        out = np.zeros(len(pts_world), np.int32)
        if self.n_blocks == 0 or len(pts_world) == 0:
            return out
        slot, vox = self._voxel_slots(pts_world)
        ok = slot >= 0
        if ok.any():
            idx = torch.from_numpy(np.stack([slot[ok], vox[ok, 2],
                                             vox[ok, 1], vox[ok, 0]]))
            i = idx.to(self.device)
            out[ok] = to_host(self._dev["label"][i[0], i[1], i[2], i[3]])
        return out

    def reset(self):
        self.__post_init__()

    # -- queries ------------------------------------------------------------
    def occupied_cloud(self, tsdf_eps: float = 0.5, min_weight: float = 1.0):
        """Surface-band voxel centroids + colors (voxelgrid/octomap modes);
        the selection runs on the device, only the hits come back."""
        n = self.n_blocks
        if n == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
        self.flush_touched()
        S = BLOCK
        d = self._dev
        sel = (d["tsdf"][:n].abs() < tsdf_eps) & (d["weight"][:n] >= min_weight)
        b, zi, yi, xi = to_host(torch.nonzero(sel)).T
        centers = (
            self.block_coords[:n][b] * (S * self.voxel_size)
            + (np.stack([xi, yi, zi], -1) + 0.5) * self.voxel_size
        )
        return centers.astype(np.float32), to_host(d["color"][:n][sel])

    def segmented_cloud(self, tsdf_eps: float = 0.5, min_weight: float = 1.0,
                        min_conf: float = 2.0):
        """Surface voxel centroids + their global segment labels (labels
        below the confidence floor read 0)."""
        assert self.with_labels
        n = self.n_blocks
        if n == 0:
            return np.zeros((0, 3), np.float32), np.zeros((0,), np.int32)
        self.flush_touched()
        S = BLOCK
        d = self._dev
        sel = (d["tsdf"][:n].abs() < tsdf_eps) & (d["weight"][:n] >= min_weight)
        b, zi, yi, xi = to_host(torch.nonzero(sel)).T
        centers = (
            self.block_coords[:n][b] * (S * self.voxel_size)
            + (np.stack([xi, yi, zi], -1) + 0.5) * self.voxel_size
        ).astype(np.float32)
        lab = d["label"][:n][sel]
        keep = d["label_conf"][:n][sel] >= min_conf
        return centers, to_host(torch.where(keep, lab, torch.zeros_like(lab)))

    def save_ply(self, path: str, max_points: int | None = None):
        pts, cols = self.occupied_cloud()
        if max_points and len(pts) > max_points:
            idx = np.random.default_rng(0).choice(len(pts), max_points,
                                                  replace=False)
            pts, cols = pts[idx], cols[idx]
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(pts)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
            f.write("end_header\n")
            for p, c in zip(pts, cols):
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                        f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
