"""Device pipelining: tracking and dense mapping on separate devices.

Counterpart of plvs_tpu/parallel/pipeline.py. The tracker keeps its device
while the TSDF volume's integration runs on another; CUDA launches are
asynchronous, so the host queues a keyframe's integration on the mapping
device and returns to tracking without waiting for it. A query of the
volume's host views waits for the integrations before it.
"""

from __future__ import annotations

import torch

from ..dense import tsdf as tsdf_mod
from ..geometry import cameras as cam_mod


class DevicePlacedTSDF(tsdf_mod.TSDFVolume):
    """TSDFVolume pinned to ``device``: the base class already keeps its
    tables on a device and updates them asynchronously; this only selects
    which one, so integration runs beside tracking on another card."""

    def __init__(self, device, *args, **kwargs):
        super().__init__(*args, device=device, **kwargs)

    def flush(self):
        """Wait for the outstanding integrations."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def make_pipelined_dense_mapper(cam: cam_mod.Camera, voxel_size: float = 0.02,
                                device=None, mapper_device="cuda", **kwargs):
    """A DenseMapper (its depth filter and meshing on ``mapper_device``)
    whose TSDF volume lives on ``device``: by default the second visible
    CUDA device, else the first, the JAX package's rule. The mesher is
    rebound to the placed volume (the JAX package's keeps meshing the
    volume it replaced)."""
    from ..dense.mapping import DenseMapper
    from ..dense.meshing import IncrementalMesher

    if device is None:
        device = f"cuda:{1 if torch.cuda.device_count() > 1 else 0}"
    mapper = DenseMapper(cam, voxel_size=voxel_size, device=mapper_device,
                         **kwargs)
    vol = DevicePlacedTSDF(device, cam, voxel_size=voxel_size,
                           with_labels=mapper.volume.with_labels,
                           max_blocks=mapper.volume.max_blocks)
    mapper.volume = vol
    mapper.mesher = IncrementalMesher(vol)
    return mapper
