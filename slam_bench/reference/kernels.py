"""Plain versions of the program's two kernels that a run drives, written
from their definitions:

* K1: the [Q, K] matrix of popcount(d1[q] xor d2[k]) over 8 32-bit words
  (plain PyTorch, on the inputs' device);
* K2: for each cell of an [H, W] grid, the minimum ``init`` over its
  connected component, where bit ci of ``conn_bits`` links the cell to the
  cell ``SHIFTS[ci]`` back along each axis (with wrap-around, as
  ``torch.roll`` indexes), links taken as undirected (NumPy and SciPy).
"""

from __future__ import annotations

import numpy as np
import torch

SHIFTS = [(1, 0), (-1, 0), (0, 1), (0, -1),
          (1, 1), (-1, -1), (1, -1), (-1, 1)]


def hamming(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[Q, 8] x [K, 8] int32 words -> [Q, K] int32 distances."""
    lut = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.int32, device=d1.device)
    a = d1.to(torch.int64) & 0xFFFFFFFF
    b = d2.to(torch.int64) & 0xFFFFFFFF
    out = torch.zeros((d1.shape[0], d2.shape[0]), dtype=torch.int32,
                      device=d1.device)
    for w in range(a.shape[1]):
        x = a[:, w, None] ^ b[None, :, w]
        for s in (0, 8, 16, 24):
            out += lut[(x >> s) & 0xFF]
    return out


def cc_min_labels(init: np.ndarray, conn_bits: np.ndarray) -> np.ndarray:
    """[H, W] int32 minimum-label fixpoint over the linked components."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components

    h, w = init.shape
    n = h * w
    idx = np.arange(n).reshape(h, w)
    src, dst = [], []
    for ci, (sy, sx) in enumerate(SHIFTS):
        on = ((conn_bits >> ci) & 1).astype(bool)
        ys, xs = np.nonzero(on)
        src.append(idx[ys, xs])
        dst.append(idx[(ys - sy) % h, (xs - sx) % w])
    src = np.concatenate(src)
    dst = np.concatenate(dst)
    g = coo_matrix((np.ones(len(src), np.int8), (src, dst)), shape=(n, n))
    _, comp = connected_components(g, directed=True, connection="weak")
    best = np.full(comp.max() + 1, np.iinfo(np.int64).max, np.int64)
    np.minimum.at(best, comp, init.reshape(-1).astype(np.int64))
    return best[comp].reshape(h, w).astype(np.int32)
