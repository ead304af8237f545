"""How many PyTorch operations one bundle-adjustment solve dispatches.

    python3 scripts/count_ba_ops.py [--device cpu|cuda] [--lm 5] [--cg 14]

The port's ``solvers/ba.py`` runs its LM and CG loops at their full trip
counts (device-side active flags, no host reads), so the number of
operations a solve dispatches does not depend on the data or on the
problem's size, only on the budget and on whether the problem has lines.
On the card each non-view operation is about one kernel launch, and a
solve of the local BA is launch-bound. This script counts them with a
``TorchDispatchMode`` on a small random window (cameras, points and lines)
and prints one JSON line: dispatched operations in all, views among them,
and the non-view count per solve, per LM iteration without CG and per CG
iteration. Imports nothing of jax or plvs_tpu.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--lm", type=int, default=5)
    ap.add_argument("--cg", type=int, default=14)
    args = ap.parse_args()

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from plvs_tpu_torch.geometry import cameras
    from plvs_tpu_torch.solvers import ba

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
    prob = _problem(torch, ba, torch.device(args.device))

    def count(lm, cg):
        c = Count()
        with c:
            ba.bundle_adjust(cam, prob, num_iters=lm, cg_iters=cg)
        return c.ops, c.views

    ops, views = count(args.lm, args.cg)
    base = count(1, 0)
    one = count(1, 1)
    print(json.dumps({
        "device": args.device, "lm_iters": args.lm, "cg_iters": args.cg,
        "dispatched_ops": ops, "views": views, "non_view_ops": ops - views,
        "non_view_per_lm_without_cg": (base[0] - base[1])
        - (count(0, 0)[0] - count(0, 0)[1]),
        "non_view_per_cg_iteration": (one[0] - one[1]) - (base[0] - base[1]),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
