"""The multi-device backend: observation-sharded bundle adjustment,
edge-sharded pose graph, block-sharded TSDF fusion, a TSDF volume on a
device of its own, and the multi-process check on ``torch.distributed``
(counterpart of plvs_tpu/parallel/)."""

from . import pipeline, sharded_ba, sharded_pose_graph, sharded_tsdf  # noqa: F401
