"""How many PyTorch operations ORB extraction dispatches, on its batched
path (every level with a budget shares one uniformity cell: bench.py's
640x480 at 1024 features and 8 levels) and on its per-level path (the
cells differ: 320x240 at 1024 / 8, which ``image_scale=0.5`` gives
bench.py's camera, and a map object's 256x256 template at 512 / 8).

    python3 scripts/count_orb_ops.py [--device cpu|cuda]

On the card each non-view operation is about one kernel launch (K1 is not
on this path). The count does not depend on the image's content. This
script counts them with a ``TorchDispatchMode`` on a crop of the
structured wall texture (``io/synthetic.py``) and prints one JSON line.
Imports nothing of jax or plvs_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from plvs_tpu_torch.features import orb
    from plvs_tpu_torch.io import synthetic

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.is_view
            return func(*args, **(kwargs or {}))

    tex = synthetic.make_structured_texture(
        1024, rng=np.random.default_rng(7))
    out = {"device": str(torch.device(args.device))}
    for h, w, n in ((480, 640, 1024), (240, 320, 1024), (256, 256, 512)):
        img = torch.from_numpy(np.clip(tex[:h, :w], 0, 255).astype(
            np.float32)).to(args.device)
        orb.extract(img, n, 8)          # warm-up (caches, lazy loading)
        c = Count()
        with c:
            orb.extract(img, n, 8)
        out[f"{w}x{h}@{n}"] = c.n
    print(json.dumps(out))


if __name__ == "__main__":
    main()
