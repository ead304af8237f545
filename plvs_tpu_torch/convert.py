"""State carried across from the JAX package.

The port learns no weights; its state is the camera, the ORB pattern and
angle weights and the LBD pairs (regenerated from the same seeds in
``features/orb.py`` and ``features/lines.py``), and the map. The two
functions here rebuild the camera and the map from plain numpy data, so a
map built by plvs_tpu can be tracked against by plvs_tpu_torch (the tests
track one frame against an identical map in both packages).
"""

from __future__ import annotations

import numpy as np

from .geometry import cameras
from .slam.map_store import MapStore


def camera_from_numpy(kind, params, width, height, bf) -> cameras.Camera:
    """A port Camera from the JAX Camera's fields."""
    return cameras.Camera(int(kind), tuple(float(p) for p in params),
                          int(width), int(height), float(bf))


def map_store_from_numpy(arrays: dict) -> MapStore:
    """A port MapStore from the JAX MapStore's SoA columns and counters
    (``{name: value}`` for the attributes of the same names, e.g.
    ``vars(jax_store)``); capacities follow the column shapes, and columns
    the port does not keep are ignored."""
    st = MapStore(max_kf=arrays["kf_R"].shape[0],
                  max_pts=arrays["pt_xyz"].shape[0],
                  max_obs=arrays["obs_kf"].shape[0],
                  n_kp=arrays["kf_kp_xy"].shape[1],
                  max_lines=arrays["ln_Xs"].shape[0],
                  max_lobs=arrays["lobs_kf"].shape[0],
                  n_kl=arrays["kf_kl_sp"].shape[1])
    for name, val in arrays.items():
        cur = getattr(st, name, None)
        if isinstance(cur, np.ndarray):
            setattr(st, name, np.array(val, dtype=cur.dtype, copy=True))
        elif isinstance(cur, int) and not isinstance(cur, bool):
            setattr(st, name, int(val))
    st.uid_slot = {int(u): int(k) for k, u in enumerate(st.kf_uid) if u >= 0}
    return st
