"""How many PyTorch operations one bundle-adjustment (or pose-graph) solve
dispatches.

    python3 scripts/count_ba_ops.py [--device cpu|cuda] [--lm 5] [--cg 14]
    python3 scripts/count_ba_ops.py --pose-graph [--lm 12] [--cg 50]

The port's ``solvers/ba.py`` runs its LM and CG loops at their full trip
counts (device-side active flags, no host reads), so the number of
operations a solve dispatches does not depend on the data or on the
problem's size, only on the budget and on whether the problem has lines.
On the card each non-view operation is about one kernel launch, and a
solve of the local BA is launch-bound. This script counts them with a
``TorchDispatchMode`` on a small random window (cameras, points and lines)
and prints one JSON line: dispatched operations in all, views among them,
and the non-view count per solve, per LM iteration without CG and per CG
iteration. ``--pose-graph`` counts the loop correction's Sim3 pose graph
(``solvers/pose_graph.py``, also at full trip counts) on a 24-vertex
drifted circle with one loop edge instead. Imports nothing of jax or
plvs_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _problem(torch, ba, device):
    rng = np.random.default_rng(0)
    K, P, M, L, Ml = 4, 64, 200, 8, 24

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    R = np.repeat(np.eye(3, dtype=np.float32)[None], K, 0)
    tr = np.stack([[-0.3 * k, 0, 0] for k in range(K)]).astype(np.float32)
    Xs = np.c_[rng.uniform(-1, 1, (L, 2)), rng.uniform(2, 4, L)]
    return ba.make_problem(
        t(R), t(tr), t(np.arange(K) < 1),
        t(np.c_[rng.uniform(-1, 1, (P, 2)), rng.uniform(2, 4, P)].astype(
            np.float32)),
        t(rng.integers(0, K, M)), t(rng.integers(0, P, M)),
        t(np.c_[rng.uniform(0, 640, M), rng.uniform(0, 480, M),
                rng.uniform(0, 600, M)].astype(np.float32)),
        t(np.ones(M, np.float32)), t(np.ones(M, bool)),
        lines_Xs=t(Xs.astype(np.float32)),
        lines_Xe=t((Xs + 0.5).astype(np.float32)),
        line_mask=t(np.ones(L, bool)), lobs_cam=t(rng.integers(0, K, Ml)),
        lobs_line=t(rng.integers(0, L, Ml)),
        lobs_nld=t(np.c_[np.ones((Ml, 1)), np.zeros((Ml, 1)),
                         -rng.uniform(0, 640, (Ml, 1))].astype(np.float32)),
        lobs_inv_sigma2=t(np.ones(Ml, np.float32)),
        lobs_mask=t(np.ones(Ml, bool)),
        lobs_depth=t(rng.uniform(2, 4, (Ml, 2)).astype(np.float32)))


def _pose_chain(torch, lie, pose_graph, device, K: int = 24):
    """A drifted odometry circle with one loop edge back to the start."""
    rng = np.random.default_rng(0)
    ang = 2 * np.pi * np.arange(K) / K
    R = lie.so3_exp(torch.from_numpy(np.stack(
        [np.zeros(K), ang, np.zeros(K)], -1).astype(np.float32)))
    C = torch.from_numpy(np.stack([np.sin(ang) * 3, np.zeros(K),
                                   3 - np.cos(ang) * 3], -1).astype(
        np.float32))
    t = -(R @ C[..., None])[..., 0]
    t = t + torch.from_numpy(rng.normal(size=(K, 3)).astype(np.float32)
                             * 0.05)
    one = torch.ones(K)
    pairs = torch.stack([torch.arange(1, K), torch.arange(0, K - 1)], -1)
    eR, et, es = pose_graph.make_edges_from_poses(R, t, one, pairs)
    lR, lt, ls = pose_graph.make_edges_from_poses(
        R, t + 0.1, one, torch.tensor([[K - 1, 0]]))
    prob = pose_graph.PoseGraphProblem(
        R, t, one, torch.arange(K) == 0,
        torch.cat([pairs[:, 0], torch.tensor([K - 1])]),
        torch.cat([pairs[:, 1], torch.tensor([0])]),
        torch.cat([eR, lR]), torch.cat([et, lt]), torch.cat([es, ls]),
        torch.ones(K), torch.ones(K, dtype=torch.bool))
    return pose_graph.PoseGraphProblem(*(a.to(device) for a in prob))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--lm", type=int, default=None,
                    help="LM iterations (5; 12 with --pose-graph)")
    ap.add_argument("--cg", type=int, default=None,
                    help="CG iterations (14; 50 with --pose-graph)")
    ap.add_argument("--pose-graph", action="store_true")
    args = ap.parse_args()
    lm_n = args.lm or (12 if args.pose_graph else 5)
    cg_n = args.cg or (50 if args.pose_graph else 14)

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from plvs_tpu_torch.geometry import cameras, lie
    from plvs_tpu_torch.solvers import ba, pose_graph

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = self.views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += 1
            self.views += bool(func.is_view)
            return func(*args, **(kwargs or {}))

    cam = cameras.pinhole(520.0, 520.0, 320.0, 240.0, width=640, height=480,
                          bf=40.0)
    dev = torch.device(args.device)
    if args.pose_graph:
        prob = _pose_chain(torch, lie, pose_graph, dev)

        def solve(lm, cg):
            pose_graph.optimize(prob, num_iters=lm, cg_iters=cg,
                                fix_scale=True)
    else:
        prob = _problem(torch, ba, dev)

        def solve(lm, cg):
            ba.bundle_adjust(cam, prob, num_iters=lm, cg_iters=cg)

    def count(lm, cg):
        c = Count()
        with c:
            solve(lm, cg)
        return c.ops, c.views

    ops, views = count(lm_n, cg_n)
    base = count(1, 0)
    one = count(1, 1)
    print(json.dumps({
        "device": args.device,
        "solver": "pose_graph" if args.pose_graph else "bundle_adjust",
        "lm_iters": lm_n, "cg_iters": cg_n,
        "dispatched_ops": ops, "views": views, "non_view_ops": ops - views,
        "non_view_per_lm_without_cg": (base[0] - base[1])
        - (count(0, 0)[0] - count(0, 0)[1]),
        "non_view_per_cg_iteration": (one[0] - one[1]) - (base[0] - base[1]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
