"""Multi-process sharded-BA check on ``torch.distributed``.

Counterpart of plvs_tpu/parallel/distributed_check.py, where each process
owns its local devices and ``jax.distributed`` joins them into one mesh.
Here each process is one rank of a gloo process group: it builds the same
problem from the same seed (16 keyframes, 1,024 landmarks, 8,192
observations with 0.5 px of noise), keeps its rank's block of the
observation rows, and runs ``bundle_adjust_sharded`` (2 LM x 8 CG) over a
one-shard mesh whose partial sums are all-reduced across the ranks. The
cameras and landmarks are replicated, every process takes the same steps,
and each prints ``DIST_OK cost=<float>``.

gloo serves tensors on the CPU and on CUDA (where it supports only
``all_reduce``, ``broadcast`` and ``barrier``; the solve uses
``all_reduce`` alone), and it lets several ranks share one card, which
NCCL refuses. Run one worker per rank:

    python -m plvs_tpu_torch.parallel.distributed_check \\
        tcp://127.0.0.1:<port> <nprocs> <rank> [--device cpu|cuda]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

K_CAMS, N_POINTS, N_OBS = 16, 1024, 8192


def make_problem(device):
    """The check's problem (the JAX package's, from the same seed) on
    ``device``, and its camera."""
    from ..geometry import cameras
    from ..solvers import ba

    cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                          bf=24.0)
    rng = np.random.default_rng(0)  # identical problem on every process
    K, Pn, M = K_CAMS, N_POINTS, N_OBS
    pts = np.stack([rng.uniform(-2, 2, Pn), rng.uniform(-1.5, 1.5, Pn),
                    rng.uniform(3, 8, Pn)], -1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    t[:, 0] = np.linspace(0, -0.5, K)
    obs_cam = rng.integers(0, K, M).astype(np.int64)
    obs_pt = rng.integers(0, Pn, M).astype(np.int64)
    Rd, td, pd = (torch.from_numpy(a) for a in (R, t, pts))
    Xc = (Rd[obs_cam] @ pd[obs_pt][..., None])[..., 0] + td[obs_cam]
    uv = cameras.project(cam, Xc) + torch.from_numpy(
        rng.normal(0, 0.5, (M, 2)).astype(np.float32))
    uvr = torch.cat([uv, -torch.ones((M, 1))], -1)
    fixed = torch.zeros((K,), dtype=torch.bool)
    fixed[0] = True
    prob = ba.make_problem(Rd, td, fixed, pd, torch.from_numpy(obs_cam),
                           torch.from_numpy(obs_pt), uvr, torch.ones((M,)),
                           torch.ones((M,), dtype=torch.bool))
    return cam, ba.BAProblem(*(f.to(device) for f in prob))


def rank_rows(prob, rank: int, world: int):
    """The rank's contiguous block of the observation rows."""
    per = prob.obs_cam.shape[0] // world
    sl = slice(rank * per, (rank + 1) * per)
    return prob._replace(obs_cam=prob.obs_cam[sl], obs_pt=prob.obs_pt[sl],
                         obs_uvr=prob.obs_uvr[sl],
                         obs_inv_sigma2=prob.obs_inv_sigma2[sl],
                         obs_mask=prob.obs_mask[sl])


def run_worker(init_method: str, world: int, rank: int,
               device: str = "cuda") -> float:
    import torch.distributed as dist

    from ..ops import resolve_device
    from .sharded_ba import Mesh, bundle_adjust_sharded

    dev = resolve_device(device)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        cam, prob = make_problem(dev)
        mesh = Mesh((dev,), group=dist.group.WORLD)
        out = bundle_adjust_sharded(cam, rank_rows(prob, rank, world), mesh,
                                    num_iters=2, cg_iters=8)
        cost = float(out[-1]["cost"])
        assert np.isfinite(cost), cost
        print(f"DIST_OK cost={cost:.6f}", flush=True)
        return cost
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("init_method")
    ap.add_argument("nprocs", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    a = ap.parse_args(argv)
    run_worker(a.init_method, a.nprocs, a.rank, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
