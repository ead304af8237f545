"""Map checkpoints: the sparse atlas and the dense volume as npz files.

Counterpart of plvs_tpu/io/serialization.py with the same npz keys,
dtypes, capacities (``_caps``), atlas ids (``_atlas``), counters and
vocabulary checksum, so a map written by either package loads in the
other. The store's SoA columns are host numpy arrays in both packages; the
vocabulary is rebuilt as the port's ``Vocabulary`` of numpy arrays, and
the dense volume as the port's ``TSDFVolume`` on the caller's device.
"""

from __future__ import annotations

import hashlib

import numpy as np

from ..slam.map_store import MapStore
from ..vocab.bow import Vocabulary


def _vocab_checksum(voc) -> str:
    """md5 of the node words then the word weights, as bytes (uint32 and
    float32: the same digest as the JAX package's on the same tables)."""
    if voc is None:
        return ""
    h = hashlib.md5()
    h.update(np.asarray(voc.nodes).tobytes())
    h.update(np.asarray(voc.word_weights).tobytes())
    return h.hexdigest()


_STORE_FIELDS = [
    "kf_R", "kf_t", "kf_mask", "kf_fixed", "kf_timestamp", "kf_frame_id",
    "kf_map",
    "kf_kp_xy", "kf_kp_uvr", "kf_kp_desc", "kf_kp_octave", "kf_kp_angle",
    "kf_kp_mask", "kf_kp_pt",
    "pt_xyz", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist",
    "pt_angle",
    "pt_mask", "pt_ref_kf", "pt_first_kf", "pt_n_obs", "pt_visible",
    "pt_found",
    "obs_kf", "obs_pt", "obs_kp", "obs_mask",
    "ln_Xs", "ln_Xe", "ln_desc", "ln_mask", "ln_ref_kf", "ln_first_kf",
    "ln_n_obs", "ln_visible", "ln_found",
    "kf_kl_sp", "kf_kl_ep", "kf_kl_desc", "kf_kl_mask", "kf_kl_line",
    "kf_kl_depth",
    "lobs_kf", "lobs_line", "lobs_kl", "lobs_mask",
]
_COUNTERS = ["_n_kf", "_n_pt", "_n_ln", "_obs_top", "_lobs_top"]


def save_atlas(path: str, store: MapStore, voc=None, extra: dict | None = None):
    """Save the whole sparse map (+ vocabulary checksum) to ``path`` (.npz)."""
    data = {f: getattr(store, f) for f in _STORE_FIELDS}
    data.update({c: np.asarray(getattr(store, c)) for c in _COUNTERS})
    data["_caps"] = np.asarray(
        [store.max_kf, store.max_pts, store.max_obs, store.n_kp,
         store.max_lines, store.max_lobs, store.n_kl]
    )
    data["_atlas"] = np.asarray([store.active_map, store.n_maps])
    data["_vocab_checksum"] = np.asarray(_vocab_checksum(voc))
    if voc is not None:
        data["_voc_k"] = np.asarray(voc.k)
        data["_voc_depth"] = np.asarray(voc.depth)
        data["_voc_nodes"] = np.asarray(voc.nodes)
        data["_voc_offsets"] = np.asarray(voc.level_offset)
        data["_voc_weights"] = np.asarray(voc.word_weights)
    if extra:
        for k, v in extra.items():
            data["x_" + k] = np.asarray(v)
    np.savez_compressed(path, **data)


def load_atlas(path: str, expected_vocab=None):
    """Load a map store (+ vocabulary). Raises ``ValueError`` when the
    stored vocabulary checksum differs from ``expected_vocab``'s."""
    z = np.load(path, allow_pickle=False)
    caps = z["_caps"]
    store = MapStore(max_kf=int(caps[0]), max_pts=int(caps[1]),
                     max_obs=int(caps[2]), n_kp=int(caps[3]),
                     max_lines=int(caps[4]), max_lobs=int(caps[5]),
                     n_kl=int(caps[6]))
    for f in _STORE_FIELDS:
        if f in z:  # checkpoints from before a field existed
            getattr(store, f)[...] = z[f]
    for c in _COUNTERS:
        setattr(store, c, int(z[c]))
    if "_atlas" in z:
        store.active_map = int(z["_atlas"][0])
        store.n_maps = int(z["_atlas"][1])

    voc = None
    if "_voc_nodes" in z:
        voc = Vocabulary(
            int(z["_voc_k"]), int(z["_voc_depth"]),
            np.asarray(z["_voc_nodes"], np.uint32),
            tuple(int(x) for x in z["_voc_offsets"]),
            np.asarray(z["_voc_weights"], np.float32),
            int(z["_voc_weights"].shape[0]),
        )
    if expected_vocab is not None:
        if str(z["_vocab_checksum"]) != _vocab_checksum(expected_vocab):
            raise ValueError(
                "vocabulary checksum mismatch: map was built with a "
                "different vocabulary")
    return store, voc


def save_dense(path: str, volume):
    """Save a TSDF volume's allocated blocks to .npz."""
    n = volume.n_blocks
    np.savez_compressed(
        path,
        block_coords=volume.block_coords[:n],
        tsdf=volume.tsdf[:n], weight=volume.weight[:n], color=volume.color[:n],
        voxel_size=np.asarray(volume.voxel_size),
        trunc_factor=np.asarray(volume.trunc_factor),
    )


def load_dense(path: str, cam, max_blocks: int | None = None,
               device="cuda"):
    """A ``TSDFVolume`` on ``device`` holding a saved volume."""
    from ..dense.tsdf import TSDFVolume

    z = np.load(path)
    n = len(z["block_coords"])
    vol = TSDFVolume(cam, voxel_size=float(z["voxel_size"]),
                     trunc_factor=float(z["trunc_factor"]),
                     max_blocks=max_blocks or max(n * 2, 1024),
                     device=device)
    vol.load_state(z["block_coords"], z["tsdf"], z["weight"], z["color"])
    return vol
