"""Dense mapping orchestrator: per-keyframe depth, integration and meshing,
and the rebuild after a loop closure.

Counterpart of plvs_tpu/dense/mapping.py's ``DenseMapper``: per keyframe,
stereo depth (kernel K3) or the RGB-D depth, the depth filter, TSDF
integration and the budgeted incremental mesh, in the JAX package's order
(``insert_stages``, a generator driven with a given fetch: inline, or the
interleaved backend's helper threads). Each keyframe's raw
depth and color stay on the device (``DenseKeyFrame``), and ``rebuild``
resets the volume and the mesher and re-integrates every stored keyframe
at its corrected pose. The multi-resolution far field (the coarse volume),
unstable-voxel carving and segmentation raise ``NotImplementedError``.
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
from .meshing import IncrementalMesher, marching_tetrahedra
from .stereo_depth import disparity, disparity_to_depth
from .tsdf import TSDFVolume


@dataclasses.dataclass
class DenseKeyFrame:
    """Stored sensor data of one keyframe (device tensors)."""

    kf_id: int
    depth: torch.Tensor   # [H, W] raw metric depth
    color: torch.Tensor   # [H, W] gray or [H, W, 3], as integrated


# settings outside the ported slice -> (value that is in it, ROADMAP item)
_NOT_IN_SLICE = {
    "use_segmentation": (False, "queue 1 item 7, segmentation"),
    "multi_res": (False, "queue 1 item 2, multi-resolution far field"),
    "carve_every": (0, "queue 1 item 2, unstable-voxel carving"),
}


@dataclasses.dataclass
class DenseMapper:
    cam: cam_mod.Camera
    voxel_size: float = 0.02
    max_blocks: int = 8192
    use_segmentation: bool = False
    multi_res: bool = False
    carve_every: int = 0
    # incremental-mesh cadence in keyframes (0 = on demand only)
    mesh_every: int = 0
    # max blocks extracted per incremental mesh update (0 = unbounded); the
    # rest carries over FIFO
    mesh_budget: int = 160
    stopwatch: object | None = None  # optional stage timing (.scope(name))
    device: str | torch.device = "cuda"

    def __post_init__(self):
        for name, (ok_value, item) in _NOT_IN_SLICE.items():
            if getattr(self, name) != ok_value:
                raise NotImplementedError(
                    f"DenseMapper.{name}={getattr(self, name)!r} is not in "
                    f"the ported slice; ROADMAP.md {item} ports it")
        self.device = resolve_device(self.device)
        self.volume = TSDFVolume(self.cam, voxel_size=self.voxel_size,
                                 max_blocks=self.max_blocks,
                                 device=self.device)
        self.mesher = IncrementalMesher(self.volume)
        self.keyframes: list[DenseKeyFrame] = []
        self.remesh_counts: list[int] = []
        self._n_inserted = 0
        # one-KF-lagged changed-block fetch (see insert_stages)
        self._touched_ctx = None

    def _scope(self, name: str):
        if self.stopwatch is None:
            return contextlib.nullcontext()
        return self.stopwatch.scope(name)

    def _mesh_due(self) -> bool:
        return bool(self.mesh_every
                    and self._n_inserted % self.mesh_every == 0)

    def _insert_rgbd_core(self, kf_id: int, color, depth, Rcw: np.ndarray,
                          tcw: np.ndarray):
        """Filter + integrate. The depth is quantized to u16 millimetres
        (and a gray color plane to u8) before filtering, as the JAX package
        uploads it; block allocation scans the raw depth. The raw depth and
        the integrated color are kept for :meth:`rebuild`."""
        raw = self.volume._put(depth)
        color = self.volume._put(color)
        alloc = to_host(raw)
        d16 = torch.clamp(raw * 1000.0, 0, 65535).to(torch.int32)
        if color.dim() == 2:
            color = torch.clamp(color, 0, 255).to(torch.uint8).to(
                torch.float32)
        depth = processing.filter_depth(d16.to(torch.float32) * 1e-3)
        self.keyframes.append(DenseKeyFrame(kf_id, raw, color))
        with self._scope("dense.integrate"):
            self.volume.integrate(depth, color, Rcw, tcw, alloc_depth=alloc)
        self._n_inserted += 1

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
            left = self.volume._put(a)
            with self._scope("dense.disparity"):
                disp = disparity(left, self.volume._put(b), max_disp=64)
                depth = disparity_to_depth(disp, self.cam.bf)
            self._insert_rgbd_core(kf_id, left[..., None].expand(-1, -1, 3),
                                   depth, Rcw, tcw)
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
        filtered again as the JAX package does (unquantized)."""
        # the lagged changed-block fetch refers to the volume being reset
        self._touched_ctx = None
        self.volume.reset()
        self.mesher.invalidate()
        for dkf in self.keyframes:
            Rcw, tcw = get_pose(dkf.kf_id)
            if Rcw is None:
                continue
            self.volume.integrate(processing.filter_depth(dkf.depth),
                                  dkf.color, Rcw, tcw,
                                  alloc_depth=to_host(dkf.depth))

    def cloud(self):
        return self.volume.occupied_cloud()

    def mesh(self):
        return marching_tetrahedra(self.volume)

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
