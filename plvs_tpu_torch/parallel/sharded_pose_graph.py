"""Multi-device pose-graph optimization: the edge table split by shard.

Counterpart of plvs_tpu/parallel/sharded_pose_graph.py. The edge table
(the bulk of a long trajectory's essential graph) splits into equal
contiguous blocks, one a shard; the vertices stay replicated. The
batched edge linearization runs on the mesh's first device, and the two
vertex segment sums and the cost's sum over edges go through
``solvers/pose_graph.py``'s ``edges`` hook: each shard's ``index_add_`` on
its own device, the partials summed on the first device (and all-reduced
over the mesh's process group), as ``sharded_ba`` does for observations.
"""

from __future__ import annotations

import torch

from ..solvers import pose_graph
from .sharded_ba import Mesh, make_mesh, sharded_segment_sum, sharded_total  # noqa: F401  (make_mesh re-exported)


def shard_problem(prob: pose_graph.PoseGraphProblem, mesh: Mesh,
                  axis: str = "obs") -> pose_graph.PoseGraphProblem:
    """The problem on the mesh's first device, its edge rows padded to a
    multiple of the shard count with edges that add nothing (vertex 0 to
    vertex 0, identity measurement, scale 1, weight 0, masked)."""
    prob = pose_graph.PoseGraphProblem(*(f.to(mesh.devices[0])
                                         for f in prob))
    pad = -prob.edge_i.shape[0] % mesh.size
    if not pad:
        return prob

    def grow(a, fill):
        return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                        dtype=a.dtype, device=a.device)])

    eye = torch.eye(3, dtype=prob.edge_R.dtype, device=prob.edge_R.device)
    return prob._replace(
        edge_i=grow(prob.edge_i, 0), edge_j=grow(prob.edge_j, 0),
        edge_R=torch.cat([prob.edge_R, eye.expand(pad, 3, 3)]),
        edge_t=grow(prob.edge_t, 0.0), edge_s=grow(prob.edge_s, 1.0),
        edge_weight=grow(prob.edge_weight, 0.0),
        edge_mask=grow(prob.edge_mask, False))


def optimize_sharded(prob: pose_graph.PoseGraphProblem, mesh: Mesh,
                     num_iters: int = 15, cg_iters: int = 50,
                     fix_scale: bool = False):
    """``pose_graph.optimize`` over the edge-sharded problem; returns its
    (R, t, s, info) on the mesh's first device."""
    prob = shard_problem(prob, mesh)
    K = prob.R.shape[0]
    edges = (sharded_segment_sum(prob.edge_i, K, mesh),
             sharded_segment_sum(prob.edge_j, K, mesh),
             sharded_total(prob.edge_i.shape[0], mesh))
    return pose_graph._optimize(prob, num_iters, cg_iters, fix_scale, 1e-4,
                                None, edges=edges)
