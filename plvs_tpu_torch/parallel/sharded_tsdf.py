"""Multi-device TSDF fusion: the voxel blocks split by shard.

Counterpart of plvs_tpu/parallel/sharded_tsdf.py. A frame's block batch
splits into equal contiguous blocks, one a shard; the depth and color
images and the pose are replicated (one image against thousands of
blocks), so each shard's projective update (``dense/tsdf.py``'s
``integrate_blocks``) runs on its own device with no communication, and
the results are gathered back on the mesh's first device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dense import tsdf as tsdf_mod
from ..geometry import cameras as cam_mod
from .sharded_ba import Mesh, make_mesh  # noqa: F401  (re-exported)


def integrate_blocks_sharded(mesh: Mesh, block_coords, tsdf, weight, color,
                             depth_img, color_img, Rcw, tcw,
                             cam: cam_mod.Camera, voxel_size: float,
                             trunc: float, axis: str = "obs"):
    """One frame's projective TSDF update with the block dimension split
    over the mesh. The block count must divide by the shard count (pad
    with empty blocks). Returns (tsdf, weight, color) on the mesh's first
    device."""
    n_blocks = block_coords.shape[0]
    if n_blocks % mesh.size:
        raise ValueError(f"block count {n_blocks} not divisible by "
                         f"{mesh.size} shards")
    per = n_blocks // mesh.size
    home = mesh.devices[0]
    outs = []
    for s, d in enumerate(mesh.devices):
        sl = slice(s * per, (s + 1) * per)
        outs.append(tsdf_mod.integrate_blocks(
            block_coords[sl].to(d), tsdf[sl].to(d), weight[sl].to(d),
            color[sl].to(d), depth_img.to(d), color_img.to(d), Rcw.to(d),
            tcw.to(d), cam, voxel_size, trunc))
    return tuple(torch.cat([o.to(home) for o in part])
                 for part in zip(*outs))


class ShardedTSDFVolume(tsdf_mod.TSDFVolume):
    """TSDFVolume whose integration runs block-sharded over a mesh (its
    tables on the mesh's first device unless ``device`` says otherwise).

    The host allocation bookkeeping is the base class's; only the batched
    device update is split. The block batch pads to a multiple of the
    shard count with empty blocks (coordinates 1 << 20, tsdf 1, weight 0),
    and the live slots are written back into the volume's own device
    tables. As in the JAX package, this integrate keeps no frame counter
    or changed-block versions."""

    def __init__(self, mesh: Mesh, *args, **kwargs):
        kwargs.setdefault("device", mesh.devices[0])
        super().__init__(*args, **kwargs)
        self.mesh = mesh
        self.n_dev = mesh.size

    def integrate(self, depth, color, Rcw: np.ndarray, tcw: np.ndarray):
        host = depth.cpu().numpy() if isinstance(depth, torch.Tensor) \
            else np.asarray(depth)
        self._allocate_for_frame(host, Rcw, tcw)
        n = self.n_blocks
        if n == 0:
            return
        m = n + (-n % self.n_dev)
        d, dev = self._dev, self.device

        def padded(key, fill):
            out = torch.full((m,) + d[key].shape[1:], fill,
                             dtype=d[key].dtype, device=dev)
            out[:n] = d[key][:n]
            return out

        bc = torch.full((m, 3), 1 << 20, dtype=torch.int32, device=dev)
        bc[:n] = torch.from_numpy(self.block_coords[:n]).to(dev)
        t_out, w_out, c_out = integrate_blocks_sharded(
            self.mesh, bc, padded("tsdf", 1.0), padded("weight", 0.0),
            padded("color", 0.0), self._put(depth), self._put(color),
            self._put(Rcw), self._put(tcw), self.cam, self.voxel_size,
            self.trunc)
        d["tsdf"][:n] = t_out[:n].to(dev)
        d["weight"][:n] = w_out[:n].to(dev)
        d["color"][:n] = c_out[:n].to(dev)
        self._mirror = None
