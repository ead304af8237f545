"""Multi-device bundle adjustment: the observation table split by shard.

Counterpart of plvs_tpu/parallel/sharded_ba.py. The JAX package places the
observation table on a ``jax.sharding.Mesh`` axis and GSPMD turns each
segment sum over it into per-device partial sums plus a ``psum``. PyTorch
has no such compiler pass, so the port writes the plan out. A
:class:`Mesh` names the devices of its shards and, when the shards span
processes, a ``torch.distributed`` process group. The solver's row
reductions (``solvers/ba.py``, its ``Reductions`` hook) split the
observation rows into equal contiguous blocks, one a shard, reduce each
block on its shard's device with ``index_add_`` (the ``scatter_free=False``
formulation), sum the partials on the first device, and all-reduce that
sum over the group when there is one. The per-observation Jacobian pass
and the CG vectors live on the first device, with cameras, landmarks and
line observations replicated (the JAX package shards only the point
observations too).

With ``shard_points`` the observations are first sorted by the shard that
owns their landmark (:func:`partition_by_point`, the JAX package's host
sort and pad): each shard then gathers ``points[obs_pt]`` from its own
landmark range and writes its point-side sums into that range alone, so
only the camera blocks are summed across shards.

``make_mesh(n, device=...)`` makes ``n`` shards on one device, the
counterpart of XLA's forced host device count that the JAX tests use: the
same split and reductions, every shard's on that device. The JAX package
caches one jitted program per (camera, mesh, mode) (``_sharded_fn``) so
that a dispatch does not re-trace the LM program; PyTorch traces nothing,
so that cache has no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..geometry import cameras as cam_mod
from ..solvers import ba


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The shards of one axis: ``devices`` holds each shard's torch device,
    in order; ``group`` is the ``torch.distributed`` process group the
    partial sums are all-reduced over (None within one process)."""

    devices: tuple
    axis: str = "obs"
    group: object | None = None

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "obs",
              device=None) -> Mesh:
    """A mesh over the first ``n_devices`` CUDA devices (all visible ones
    when None); raises when fewer are visible. With ``device`` given (e.g.
    "cpu", "cuda:0") it makes ``n_devices`` shards (default 1) on that one
    device instead."""
    if device is not None:
        dev = torch.device(device)
        return Mesh(tuple(dev for _ in range(n_devices or 1)), axis)
    visible = torch.cuda.device_count()
    n = n_devices or visible
    if n < 1 or visible < n:
        raise RuntimeError(
            f"requested {n}-device mesh but only {visible} CUDA devices "
            "visible (pass device= for shards on one device)")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def _blocks(n_rows: int, mesh: Mesh) -> list:
    """Each shard's (device, start, end) row range."""
    if n_rows % mesh.size:
        raise ValueError(f"row capacity {n_rows} not divisible by "
                         f"{mesh.size} shards")
    per = n_rows // mesh.size
    return [(d, s * per, (s + 1) * per) for s, d in enumerate(mesh.devices)]


def _all_reduce(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    if mesh.group is not None:
        import torch.distributed as dist

        dist.all_reduce(x, group=mesh.group)
    return x


def sharded_segment_sum(idx: torch.Tensor, num_segments: int, mesh: Mesh):
    """Segment sum over rows split by shard: each shard's ``index_add_`` on
    its own device, the partials summed on the first device (and
    all-reduced over the group)."""
    home = mesh.devices[0]
    parts = [(d, lo, hi, idx[lo:hi].to(d)) for d, lo, hi in
             _blocks(idx.shape[0], mesh)]

    def reduce(v):
        out = None
        for d, lo, hi, ix in parts:
            part = torch.zeros((num_segments,) + v.shape[1:], dtype=v.dtype,
                               device=d).index_add_(0, ix, v[lo:hi].to(d))
            out = part.to(home) if out is None else out + part.to(home)
        return _all_reduce(out, mesh)

    return reduce


def sharded_total(n_rows: int, mesh: Mesh):
    """Plain sum over rows split by shard, as :func:`sharded_segment_sum`."""
    home = mesh.devices[0]
    blocks = _blocks(n_rows, mesh)

    def total(v):
        out = None
        for d, lo, hi in blocks:
            part = v[lo:hi].to(d).sum().to(home)
            out = part if out is None else out + part
        return _all_reduce(out, mesh)

    return total


def _owned(idx: torch.Tensor, n_owned: int, mesh: Mesh):
    """Each shard's rows as indices into its own range of ``n_owned``
    landmarks (rows outside it are masked ones, whose terms are zero:
    clamped into the range)."""
    return [(d, lo, hi, s * n_owned,
             (idx[lo:hi] - s * n_owned).clamp(0, n_owned - 1).to(d))
            for s, (d, lo, hi) in enumerate(_blocks(idx.shape[0], mesh))]


def _obs_reductions(prob: ba.BAProblem, mesh: Mesh, shard_points: bool):
    """The point observations' (seg_c, seg_p, gather_p, total) over the
    mesh (``ba.Reductions``' first four)."""
    K, P, M = prob.R.shape[0], prob.points.shape[0], prob.obs_cam.shape[0]
    seg_c = sharded_segment_sum(prob.obs_cam, K, mesh)
    total = sharded_total(M, mesh)
    if not shard_points:
        return (seg_c, sharded_segment_sum(prob.obs_pt, P, mesh),
                lambda x: x[prob.obs_pt], total)
    home = mesh.devices[0]
    per = P // mesh.size
    parts = _owned(prob.obs_pt, per, mesh)

    def seg_p(v):
        # each shard's landmark range written by that shard alone
        return torch.cat([
            torch.zeros((per,) + v.shape[1:], dtype=v.dtype, device=d)
            .index_add_(0, ix, v[lo:hi].to(d)).to(home)
            for d, lo, hi, _, ix in parts])

    def gather_p(x):
        return torch.cat([x[p0:p0 + per].to(d)[ix].to(home)
                          for d, _, _, p0, ix in parts])

    return seg_c, seg_p, gather_p, total


def _on(prob: ba.BAProblem, device) -> ba.BAProblem:
    return ba.BAProblem(*(f.to(device) for f in prob))


def shard_problem(prob: ba.BAProblem, mesh: Mesh,
                  axis: str = "obs") -> ba.BAProblem:
    """The problem on the mesh's first device, its observation rows padded
    to a multiple of the shard count with masked rows (camera 0, point 0,
    uR -1, weight 1), which add nothing to any sum. The JAX package asks
    the caller for a divisible capacity; its local mapper's shape buckets
    give one, the port's unpadded problems do not."""
    prob = _on(prob, mesh.devices[0])
    pad = -prob.obs_cam.shape[0] % mesh.size
    if not pad:
        return prob

    def grow(a, fill):
        return torch.cat([a, torch.full((pad,) + a.shape[1:], fill,
                                        dtype=a.dtype, device=a.device)])

    return prob._replace(
        obs_cam=grow(prob.obs_cam, 0), obs_pt=grow(prob.obs_pt, 0),
        obs_uvr=grow(prob.obs_uvr, -1.0),
        obs_inv_sigma2=grow(prob.obs_inv_sigma2, 1.0),
        obs_mask=grow(prob.obs_mask, False))


def partition_by_point(prob: ba.BAProblem, n_shards: int) -> ba.BAProblem:
    """Reorder the observation table so each shard's observations reference
    a contiguous range of landmark ids (host-side sort and pad, the JAX
    package's arithmetic): observations of landmark range s, in their
    order, fill shard s's rows; masked observations go to the last shard;
    every shard's row count pads to the largest, rounded up to 8."""
    M = int(prob.obs_cam.shape[0])
    P_ = int(prob.points.shape[0])
    if P_ % n_shards != 0:
        raise ValueError(f"point capacity {P_} not divisible by {n_shards}")
    per = P_ // n_shards
    obs_pt = prob.obs_pt.cpu().numpy()
    obs_mask = prob.obs_mask.cpu().numpy()
    owner = np.where(obs_mask, obs_pt // per, n_shards - 1)
    order = np.argsort(owner, kind="stable")
    counts = np.bincount(owner, minlength=n_shards)
    cap = int(counts.max())
    cap = ((cap + 7) // 8) * 8
    new_M = cap * n_shards

    def take(a, fill=0):
        a = a.cpu().numpy()
        out = np.full((new_M,) + a.shape[1:], fill, a.dtype)
        pos = 0
        for s in range(n_shards):
            c = counts[s]
            out[s * cap: s * cap + c] = a[order[pos: pos + c]]
            pos += c
        return torch.from_numpy(out).to(prob.obs_cam.device)

    return prob._replace(
        obs_cam=take(prob.obs_cam), obs_pt=take(prob.obs_pt),
        obs_uvr=take(prob.obs_uvr, fill=-1.0),
        obs_inv_sigma2=take(prob.obs_inv_sigma2),
        obs_mask=take(prob.obs_mask, fill=False))


def shard_problem_points(prob: ba.BAProblem, mesh: Mesh,
                         axis: str = "obs") -> ba.BAProblem:
    """The observation table and the landmark array both split over the
    mesh (cameras replicated). Call :func:`partition_by_point` first so the
    observation shards align with their landmark shards; both capacities
    must divide by the shard count."""
    for name, n in (("point", prob.points.shape[0]),
                    ("observation", prob.obs_cam.shape[0])):
        if n % mesh.size:
            raise ValueError(f"{name} capacity {n} not divisible by "
                             f"{mesh.size} shards")
    return _on(prob, mesh.devices[0])


def bundle_adjust_sharded(cam: cam_mod.Camera, prob: ba.BAProblem,
                          mesh: Mesh, num_iters: int = 5, cg_iters: int = 20,
                          shard_points: bool = False):
    """``ba.bundle_adjust`` in its segment-sum formulation with every sum
    over the point observations split over the mesh (module docstring);
    returns its (R, t, points, lines_Xs, lines_Xe, info) on the mesh's
    first device. In a process group ``prob`` holds this process's
    observations, and every process gets the same result. With
    ``shard_points`` the landmark array is partitioned too (one process
    only)."""
    if shard_points:
        if mesh.group is not None:
            raise ValueError("shard_points partitions the landmarks within "
                             "one process; a process group shards the "
                             "observations only")
        prob = shard_problem_points(partition_by_point(prob, mesh.size), mesh)
    else:
        prob = shard_problem(prob, mesh)
    return ba._bundle_adjust(cam, prob, num_iters, cg_iters, 1e-3, 1.0,
                             False, False,
                             obs=_obs_reductions(prob, mesh, shard_points))
