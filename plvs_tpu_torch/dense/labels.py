"""Incremental 3D segmentation: global label association and bookkeeping.

A copy of plvs_tpu/dense/labels.py (numpy in both packages): each
keyframe's local segment labels are associated with the global ids already
stored in the volume by one bincount over (local, global) pairs, in the same
order and with the same argmax tie rule, so both packages allocate the same
ids; ``keyframes_in_radius`` is a brute-force radius search over keyframe
centres.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GlobalLabelMap:
    """Allocates global segment ids and associates each keyframe's local
    labels to them by overlap with the labels already stored in the volume
    (reference: LabelMap/GlobalLabelMap, include/LabelMap.h:39-172)."""

    min_overlap_frac: float = 0.2   # fraction of the local segment's pixels
    min_overlap_px: int = 20        # absolute floor
    next_global: int = 1

    def associate(self, local_labels: np.ndarray,
                  global_at_px: np.ndarray) -> np.ndarray:
        """Map a keyframe's local labels to global ids.

        local_labels: [H, W] int32, 0 = unlabeled, compact ids 1..L.
        global_at_px: [H, W] int32 global label currently stored in the map
        at each pixel's back-projected voxel (0 = none).

        Returns lut [L+1] int32 with lut[0] = 0: per-local-label global id —
        the dominant overlapping global label when the overlap passes the
        thresholds, else a freshly allocated id.
        """
        L = int(local_labels.max())
        lut = np.zeros(L + 1, np.int32)
        if L == 0:
            return lut
        loc = local_labels.ravel()
        glo = global_at_px.ravel()
        both = (loc > 0) & (glo > 0)
        area = np.bincount(loc[loc > 0], minlength=L + 1)
        if both.any():
            g_ids, g_inv = np.unique(glo[both], return_inverse=True)
            G = len(g_ids)
            # overlap histogram over (local, global) pairs
            pair = loc[both].astype(np.int64) * G + g_inv
            counts = np.bincount(pair, minlength=(L + 1) * G).reshape(L + 1, G)
            best_g = counts.argmax(1)
            best_c = counts[np.arange(L + 1), best_g]
        else:
            best_c = np.zeros(L + 1, np.int64)
            best_g = np.zeros(L + 1, np.int64)
            g_ids = np.zeros(1, np.int32)
        for l in range(1, L + 1):
            need = max(self.min_overlap_px,
                       int(self.min_overlap_frac * area[l]))
            if area[l] > 0 and best_c[l] >= need:
                lut[l] = g_ids[best_g[l]]
            elif area[l] > 0:
                lut[l] = self.next_global
                self.next_global += 1
        return lut

    def apply(self, local_labels: np.ndarray, lut: np.ndarray) -> np.ndarray:
        return lut[local_labels]


def keyframes_in_radius(kf_positions: np.ndarray, kf_mask: np.ndarray,
                        center: np.ndarray, radius: float) -> np.ndarray:
    """Keyframe ids whose camera center lies within ``radius`` of ``center``
    (reference: KeyFrameSearchTree radius search used to bound label
    merging to nearby keyframes, include/KeyFrameSearchTree.h:57-71).
    Brute-force batched distance — the KF count is bounded (<= max_kf), so
    a tree buys nothing."""
    d2 = np.sum((kf_positions - center[None]) ** 2, -1)
    return np.nonzero(kf_mask & (d2 <= radius * radius))[0]
