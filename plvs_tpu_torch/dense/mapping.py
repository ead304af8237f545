"""Dense mapping orchestrator: per-keyframe depth, segmentation,
integration and meshing, and the rebuild after a loop closure.

Counterpart of plvs_tpu/dense/mapping.py's ``DenseMapper``: per keyframe,
stereo depth (kernel K3) or the RGB-D depth, the depth filter, TSDF
integration (with ``multi_res`` the near field into the fine volume and the
depth beyond ``split_depth`` into a ``coarse_factor`` times coarser
companion volume), with ``use_segmentation`` the geometric segmentation of
the filtered depth, its association to the global segment ids and the
per-voxel label fusion, every ``carve_every`` keyframes the removal of
unstable voxels, and the budgeted incremental mesh, in the JAX package's
order. ``insert_stages`` is a generator driven with a given fetch (inline,
or the interleaved backend's helper threads); ``insert_keyframe_rgbd`` /
``insert_keyframe_stereo`` are the library's one-call entry points. Each
keyframe's raw depth and color stay on the device (``DenseKeyFrame``), and
``rebuild`` resets both volumes and the mesher and re-integrates every
stored keyframe (and its stored global labels) at its corrected pose.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..geometry import cameras as cam_mod
from ..ops import resolve_device
from ..utils.fetch import SyncFetch, to_host
from . import processing
from .labels import GlobalLabelMap
from .meshing import IncrementalMesher, marching_tetrahedra, vertex_normals
from .stereo_depth import disparity, disparity_to_depth
from .tsdf import TSDFVolume


@dataclasses.dataclass
class DenseKeyFrame:
    """Stored sensor data of one keyframe (device tensors)."""

    kf_id: int
    depth: torch.Tensor   # [H, W] raw metric depth
    color: torch.Tensor   # [H, W] gray or [H, W, 3], as integrated


@dataclasses.dataclass
class DenseMapper:
    cam: cam_mod.Camera
    voxel_size: float = 0.02
    max_blocks: int = 8192
    filter_depth: bool = True
    use_segmentation: bool = False
    # multi-resolution far field: depth beyond split_depth goes into a
    # coarse_factor x coarser companion volume
    multi_res: bool = False
    coarse_factor: int = 4
    split_depth: float = 3.0
    # unstable-voxel removal cadence in keyframes (0 = off)
    carve_every: int = 0
    # incremental-mesh cadence in keyframes (0 = on demand only)
    mesh_every: int = 0
    # max blocks extracted per incremental mesh update (0 = unbounded); the
    # rest carries over FIFO
    mesh_budget: int = 160
    # the fine volume's updated slot range starts at 1024 blocks
    fixed_shapes: bool = False
    stopwatch: object | None = None  # optional stage timing (.scope(name))
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.volume = TSDFVolume(self.cam, voxel_size=self.voxel_size,
                                 max_blocks=self.max_blocks,
                                 bucket_floor=(1024 if self.fixed_shapes
                                               else 512),
                                 with_labels=self.use_segmentation,
                                 device=self.device)
        self.coarse = None
        if self.multi_res:
            self.coarse = TSDFVolume(
                self.cam, voxel_size=self.voxel_size * self.coarse_factor,
                max_blocks=max(self.max_blocks // 4, 512),
                max_depth=self.volume.max_depth * 2.0, device=self.device)
        self.mesher = IncrementalMesher(self.volume)
        self.keyframes: list[DenseKeyFrame] = []
        self.remesh_counts: list[int] = []
        # global segment ids of each keyframe's pixels (use_segmentation)
        self.labels: dict[int, np.ndarray] = {}
        self._n_inserted = 0
        # one-KF-lagged changed-block fetch (see insert_stages)
        self._touched_ctx = None
        if self.use_segmentation:
            self.label_map = GlobalLabelMap()

    def _scope(self, name: str):
        if self.stopwatch is None:
            return contextlib.nullcontext()
        return self.stopwatch.scope(name)

    def _mesh_due(self) -> bool:
        return bool(self.mesh_every
                    and self._n_inserted % self.mesh_every == 0)

    def _insert_rgbd_core(self, kf_id: int, color, depth, Rcw: np.ndarray,
                          tcw: np.ndarray):
        """Filter, integrate, segment, carve. With the filter and without
        segmentation the depth is quantized to u16 millimetres (and a gray
        color plane to u8) before filtering, as the JAX package uploads it,
        and block allocation scans the raw depth; under segmentation the
        unquantized depth is filtered and allocation scans the filtered
        depth. The raw depth and the integrated color are kept for
        :meth:`rebuild`."""
        raw = self.volume._put(depth)
        color = self.volume._put(color)
        if self.filter_depth and self.use_segmentation:
            depth = processing.filter_depth(raw)
            alloc = to_host(depth)
        elif self.filter_depth:
            d16 = torch.clamp(raw * 1000.0, 0, 65535).to(torch.int32)
            if color.dim() == 2:
                color = torch.clamp(color, 0, 255).to(torch.uint8).to(
                    torch.float32)
            depth = processing.filter_depth(d16.to(torch.float32) * 1e-3)
            alloc = to_host(raw)
        else:
            depth = raw
            alloc = to_host(raw)
        self.keyframes.append(DenseKeyFrame(kf_id, raw, color))
        with self._scope("dense.integrate"):
            self._integrate_split(depth, color, Rcw, tcw, alloc)
        if self.use_segmentation:
            with self._scope("dense.segment"):
                self._segment_and_fuse(kf_id, depth, Rcw, tcw)
        self._n_inserted += 1
        if self.carve_every and self._n_inserted % self.carve_every == 0:
            self.volume.remove_unstable()
            if self.coarse is not None:
                self.coarse.remove_unstable()

    def _segment_and_fuse(self, kf_id: int, depth: torch.Tensor,
                          Rcw: np.ndarray, tcw: np.ndarray):
        """Segment the keyframe's depth, associate its local labels with the
        global ids stored at its surface voxels, and fuse the global label
        image into the voxel labels."""
        local, _ = processing.segment_depth(self.cam, depth)
        local, _ = processing.relabel_compact(to_host(local))
        pts_c = to_host(processing.backproject_image(self.cam, depth)
                        ).reshape(-1, 3)
        valid = (to_host(depth) > 0).ravel() & (local.ravel() > 0)
        Rwc = Rcw.T
        pts_w = pts_c[valid] @ Rwc.T + (-Rwc @ tcw)
        glob_at_px = np.zeros(local.size, np.int32)
        glob_at_px[valid] = self.volume.labels_at(pts_w)
        lut = self.label_map.associate(local, glob_at_px.reshape(local.shape))
        glob = self.label_map.apply(local, lut)
        self.volume.integrate_labels(depth, glob, Rcw, tcw)
        self.labels[kf_id] = glob

    def _integrate_split(self, depth, color, Rcw, tcw, alloc_depth=None):
        """The fine volume takes the near field; the coarse companion (with
        ``multi_res``) the depth beyond ``split_depth``. The near field's
        blocks are allocated from the near field itself."""
        if self.coarse is None:
            self.volume.integrate(depth, color, Rcw, tcw,
                                  alloc_depth=alloc_depth)
            return
        depth = self.volume._put(depth)
        zero = torch.zeros_like(depth)
        near = torch.where(depth <= self.split_depth, depth, zero)
        far = torch.where(depth > self.split_depth, depth, zero)
        self.volume.integrate(near, color, Rcw, tcw)
        far_h = to_host(far)
        if (far_h > 0).any():
            self.coarse.integrate(far, color, Rcw, tcw, alloc_depth=far_h)

    def _mesh_due(self) -> bool:
        return bool(self.mesh_every
                    and self._n_inserted % self.mesh_every == 0)

    def insert_keyframe_rgbd(self, kf_id: int, color, depth, Rcw: np.ndarray,
                             tcw: np.ndarray):
        """Insert one RGB-D keyframe (``color`` [H, W, 3] or gray [H, W]);
        when a mesh is due the touched blocks are settled first, so the mesh
        reflects this keyframe."""
        self._insert_rgbd_core(kf_id, color, depth, Rcw, tcw)
        if self._mesh_due():
            self.mesher.stopwatch = self.stopwatch
            with self._scope("dense.mesh"):
                self.settle_touched()
                self.mesher.update(assemble=False,
                                   budget=self.mesh_budget or None)
            self.remesh_counts.append(self.mesher.last_n_remeshed)

    def insert_keyframe_stereo(self, kf_id: int, left, right, Rcw: np.ndarray,
                               tcw: np.ndarray, max_disp: int = 64):
        """Rectified pair -> disparity (K3) -> depth -> insert."""
        self.insert_keyframe_rgbd(kf_id, *self._stereo_depth(left, right,
                                                             max_disp),
                                  Rcw, tcw)

    def _stereo_depth(self, left, right, max_disp: int = 64):
        """(left gray in 3 channels, depth) of a rectified pair through
        K3."""
        left = self.volume._put(left)
        with self._scope("dense.disparity"):
            disp = disparity(left, self.volume._put(right), max_disp=max_disp)
            depth = disparity_to_depth(disp, self.cam.bf)
        return left[..., None].expand(-1, -1, 3), depth

    def insert_stages(self, kind: str, kf_id: int, a, b, Rcw: np.ndarray,
                      tcw: np.ndarray, submit):
        """Staged insert (generator): integrate now; the changed-block mask
        fetch is dispatched here and applied at the NEXT keyframe's mesh
        stage, so the mesh lags the integration by one keyframe; then the
        padded-field gather is dispatched, and the triangles are made a
        stage later. ``kind`` "rgbd": (a, b) = (color, depth); "stereo":
        (a, b) = (left, right) gray images."""
        if kind == "rgbd":
            self._insert_rgbd_core(kf_id, a, b, Rcw, tcw)
        else:
            self._insert_rgbd_core(kf_id, *self._stereo_depth(a, b), Rcw,
                                   tcw)
        mesh_due = self._mesh_due()
        prev_ctx = self._touched_ctx
        self._touched_ctx = (self.volume.dispatch_touched(submit)
                             if mesh_due else None)
        yield None if prev_ctx is None else prev_ctx[1]
        if not mesh_due:
            # still fold the previous keyframe's changed blocks into the
            # block versions, or the mesher would never re-mesh them
            self.volume.apply_touched(prev_ctx)
            return
        self.mesher.stopwatch = self.stopwatch
        with self._scope("dense.mesh"):
            self.volume.apply_touched(prev_ctx)
            ctx = self.mesher.update_begin(budget=self.mesh_budget or None)
        fut = submit(ctx["out"]) if ctx is not None else None
        yield fut
        with self._scope("dense.mesh"):
            fetched = None if fut is None else fut.result()
            self.mesher.update_finish(ctx, fetched)
        self.remesh_counts.append(self.mesher.last_n_remeshed)

    def insert_keyframe(self, kind: str, kf_id: int, a, b, Rcw: np.ndarray,
                        tcw: np.ndarray):
        """Run :meth:`insert_stages` to its end with inline fetches."""
        for _ in self.insert_stages(kind, kf_id, a, b, Rcw, tcw,
                                    SyncFetch()):
            pass

    def rebuild(self, get_pose):
        """Re-integrate every stored keyframe at its corrected pose after a
        loop closure. ``get_pose``: kf_id -> (Rcw, tcw), or (None, None)
        for a keyframe that no longer exists. The stored raw depth is
        filtered again as the JAX package does (unquantized), and the
        stored global label images are fused again."""
        # the lagged changed-block fetch refers to the volume being reset
        self._touched_ctx = None
        self.volume.reset()
        if self.coarse is not None:
            self.coarse.reset()
        self.mesher.invalidate()
        for dkf in self.keyframes:
            Rcw, tcw = get_pose(dkf.kf_id)
            if Rcw is None:
                continue
            d = dkf.depth
            if self.filter_depth:
                d = processing.filter_depth(d)
            self._integrate_split(d, dkf.color, Rcw, tcw,
                                  alloc_depth=to_host(dkf.depth))
            if self.use_segmentation and dkf.kf_id in self.labels:
                self.volume.integrate_labels(dkf.depth,
                                             self.labels[dkf.kf_id], Rcw, tcw)

    def cloud(self):
        """Occupied voxel centroids and colors of both volumes."""
        pts, cols = self.volume.occupied_cloud()
        if self.coarse is not None:
            p2, c2 = self.coarse.occupied_cloud()
            pts = np.concatenate([pts, p2])
            cols = np.concatenate([cols, c2])
        return pts, cols

    def segment_cloud(self):
        """Surface voxels + global segment labels of the fine volume."""
        return self.volume.segmented_cloud()

    def mesh(self):
        """Full marching-tetrahedra mesh of both volumes."""
        V, F = marching_tetrahedra(self.volume)
        if self.coarse is not None:
            V2, F2 = marching_tetrahedra(self.coarse)
            F = np.concatenate([F, F2 + len(V)])
            V = np.concatenate([V, V2])
        return V, F

    def mesh_normals(self, V: np.ndarray):
        """TSDF-gradient normals of the fine volume at mesh vertices."""
        return vertex_normals(self.volume, V)

    def settle_touched(self):
        """Fold the one-keyframe-lagged changed-block fetch into the
        volume's dirty state (before a mesh that must reflect the last
        integrate too)."""
        ctx, self._touched_ctx = self._touched_ctx, None
        if ctx is not None:
            self.volume.apply_touched(ctx)

    def mesh_incremental(self):
        """Changed-blocks-only mesh update (see IncrementalMesher)."""
        self.settle_touched()
        return self.mesher.update()

    def save_ply(self, path: str):
        self.volume.save_ply(path)
