"""State carried across from the JAX package.

The port learns no weights; its state is the camera, the ORB pattern and
angle weights and the LBD pairs (regenerated from the same seeds in
``features/orb.py`` and ``features/lines.py``), the vocabulary, the map,
the keyframe database and the dense volume. The functions here rebuild the
camera, a vocabulary, the map, the database's per-keyframe word lists, a
bundle-adjustment problem, a pose-graph problem, the inertial runtime's
state (its preintegrations among it), the map objects (templates and
records), the TSDF volume (labels included) and the dense mapper (both
volumes, the label map, the stored keyframes) from plain numpy data, so state built by plvs_tpu can be carried on by
plvs_tpu_torch (the tests track one frame against an identical map, run one
keyframe backend pass, one loop-closer pass, one bundle adjustment and one
pose graph on identical inputs, and integrate and mesh an identical
volume, in both packages).
"""

from __future__ import annotations

import numpy as np
import torch

from .dense.mapping import DenseKeyFrame, DenseMapper
from .dense.meshing import IncrementalMesher
from .dense.tsdf import TSDFVolume
from .geometry import cameras
from .imu import preintegration as pre
from .slam.inertial import InertialRuntime
from .slam.keyframe_database import KeyFrameDatabase
from .slam.map_objects import ObjectRecord, ObjectStore, ObjectTemplate
from .slam.map_store import MapStore
from .solvers import ba, pose_graph
from .vocab import bow


def camera_from_numpy(kind, params, width, height, bf) -> cameras.Camera:
    """A port Camera from the JAX Camera's fields."""
    return cameras.Camera(int(kind), tuple(float(p) for p in params),
                          int(width), int(height), float(bf))


def map_store_from_numpy(arrays: dict) -> MapStore:
    """A port MapStore from the JAX MapStore's SoA columns, counters (the
    uid counter among them) and keyframe tombstones (``{name: value}`` for
    the attributes of the same names, e.g. ``vars(jax_store)``); capacities
    follow the column shapes, and columns the port does not keep are
    ignored."""
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
    st.kf_tombstone = {
        int(uid): (int(parent),) + tuple(
            None if a is None else np.array(a, np.float32, copy=True)
            for a in rest)
        for uid, (parent, *rest) in arrays.get("kf_tombstone", {}).items()}
    return st


def vocabulary_from_numpy(arrays: dict):
    """A port vocabulary from the JAX vocabulary's fields (``{name:
    value}``, e.g. ``voc._asdict()``): a ``GeneralVocabulary`` when the
    fields hold a children table, else a regular ``Vocabulary``."""
    if "children" in arrays:
        return bow.GeneralVocabulary(
            int(arrays["k"]), int(arrays["depth"]),
            np.array(arrays["nodes"], np.uint32),
            np.array(arrays["children"], np.int32),
            np.array(arrays["word_id"], np.int32),
            np.array(arrays["word_weights"], np.float32),
            int(arrays["n_words"]))
    return bow.Vocabulary(
        int(arrays["k"]), int(arrays["depth"]),
        np.array(arrays["nodes"], np.uint32),
        tuple(int(x) for x in arrays["level_offset"]),
        np.array(arrays["word_weights"], np.float32), int(arrays["n_words"]))


def keyframe_database_from_numpy(store: MapStore, voc, kf_words: dict,
                                 device="cuda") -> KeyFrameDatabase:
    """A port KeyFrameDatabase over ``store`` holding the JAX database's
    per-keyframe sparse word lists (``{kf: (word ids, weights)}``, e.g. its
    ``_kf_words``), indexed in the given order."""
    db = KeyFrameDatabase(store, voc=voc, device=device)
    for kf, (words, weights) in kf_words.items():
        w = np.array(words, np.int32)
        v = np.array(weights, np.float32)
        db._kf_words[int(kf)] = (w, v)
        db._index().add(int(kf), w, v)
    return db


def pose_graph_problem_from_numpy(arrays: dict,
                                  device="cuda") -> pose_graph.PoseGraphProblem:
    """A port PoseGraphProblem from the JAX problem's fields as numpy
    (``{name: value}``): edge indices become int64."""
    def put(name):
        a = np.asarray(arrays[name])
        if name in ("edge_i", "edge_j"):
            a = a.astype(np.int64)
        return torch.as_tensor(np.array(a, copy=True), device=device)

    return pose_graph.PoseGraphProblem(
        *(put(f) for f in pose_graph.PoseGraphProblem._fields))


def ba_problem_from_numpy(arrays: dict, device="cuda") -> ba.BAProblem:
    """A port BAProblem from the JAX BAProblem's fields as numpy
    (``{name: value}``, e.g. ``{f: np.asarray(getattr(p, f)) for f in
    p._fields}``): index columns become int64, the rest keep their dtype."""
    def put(name):
        a = np.asarray(arrays[name])
        if name in ("obs_cam", "obs_pt", "lobs_cam", "lobs_line"):
            a = a.astype(np.int64)
        return torch.as_tensor(np.array(a, copy=True), device=device)

    return ba.BAProblem(*(put(f) for f in ba.BAProblem._fields))


def preintegrated_from_numpy(arrays, device="cuda") -> pre.Preintegrated:
    """A port Preintegrated from the JAX one's fields as numpy (a sequence
    in field order, or ``{name: value}``)."""
    if isinstance(arrays, dict):
        arrays = [arrays[f] for f in pre.Preintegrated._fields]
    return pre.Preintegrated(*(torch.as_tensor(
        np.array(a, np.float32, copy=True), device=device) for a in arrays))


def inertial_runtime_from_numpy(state: dict, device="cuda",
                                **kw) -> InertialRuntime:
    """A port InertialRuntime carrying the JAX runtime's state (``{name:
    value}`` with numpy leaves, e.g. from ``vars(jax_runtime)``):
    ``samples``, ``kf_chain``, ``kf_preint`` (``{kf: Preintegrated
    fields}``), ``kf_raw``, ``kf_velocity``, ``bias_gyro``, ``bias_acc``,
    ``gravity`` and, when present, ``_cur_velocity`` and ``_last_pose``;
    ``kw`` are the runtime's settings (calib, R_cb, init_min_time, ...)."""
    rt = InertialRuntime(device=device, **kw)

    def sample(s):
        return (float(s[0]), np.array(s[1], np.float32, copy=True),
                np.array(s[2], np.float32, copy=True))

    rt.samples = [sample(s) for s in state["samples"]]
    rt.kf_chain = [int(k) for k in state["kf_chain"]]
    rt.kf_preint = {int(k): preintegrated_from_numpy(p, device)
                    for k, p in state["kf_preint"].items()}
    rt.kf_raw = {int(k): (float(t0), [sample(s) for s in raw])
                 for k, (t0, raw) in state["kf_raw"].items()}
    rt.kf_velocity = {int(k): np.array(v, np.float32, copy=True)
                      for k, v in state["kf_velocity"].items()}
    rt.bias_gyro = np.array(state["bias_gyro"], np.float32, copy=True)
    rt.bias_acc = np.array(state["bias_acc"], np.float32, copy=True)
    g = state.get("gravity")
    rt.gravity = None if g is None else np.array(g, np.float32, copy=True)
    v = state.get("_cur_velocity")
    rt._cur_velocity = None if v is None else np.array(v, np.float32,
                                                       copy=True)
    lp = state.get("_last_pose")
    rt._last_pose = None if lp is None else (
        float(lp[0]), np.array(lp[1], np.float32, copy=True))
    return rt


def object_store_from_numpy(cam: cameras.Camera, objects, device="cuda",
                            **kw) -> ObjectStore:
    """A port ObjectStore carrying a JAX ObjectStore's objects: each entry
    of ``objects`` gives the template (``plane_xy``, ``desc``, ``corners``,
    ``object_id``) and the record (``R_wo``, ``t_wo``, ``s_wo``,
    ``detected``, ``n_inliers``, ``obs`` as ``{kf: (uv, mask)}``), as
    attributes (a JAX ObjectRecord itself) or as a dict."""
    store = ObjectStore(cam, device=device, **kw)

    def get(o, name, default=None):
        return o.get(name, default) if isinstance(o, dict) else getattr(
            o, name, default)

    def arr(a, dtype):
        return None if a is None else np.array(a, dtype, copy=True)

    for rec in objects:
        t = get(rec, "template")
        tpl = ObjectTemplate(plane_xy=arr(get(t, "plane_xy"), np.float32),
                             desc=arr(get(t, "desc"), np.uint32),
                             corners=arr(get(t, "corners"), np.float32),
                             object_id=int(get(t, "object_id", 0)))
        store.objects.append(ObjectRecord(
            template=tpl, R_wo=arr(get(rec, "R_wo"), np.float32),
            t_wo=arr(get(rec, "t_wo"), np.float32),
            s_wo=float(get(rec, "s_wo", 1.0)),
            detected=bool(get(rec, "detected", False)),
            n_inliers=int(get(rec, "n_inliers", 0)),
            obs={int(k): (arr(uv, np.float32), arr(m, bool))
                 for k, (uv, m) in get(rec, "obs", {}).items()}))
    return store


def tsdf_state(vol) -> dict:
    """The state :func:`tsdf_volume_from_numpy` takes, read from a volume
    of either package (full-capacity host arrays; labels where the volume
    keeps them)."""
    out = dict(block_coords=vol.block_coords, n_blocks=vol.n_blocks,
               block_map=vol.block_map, tsdf=vol.tsdf, weight=vol.weight,
               color=vol.color, block_version=vol.block_version,
               frame_idx=vol.frame_idx)
    if hasattr(vol, "block_alloc_frame"):
        out["block_alloc_frame"] = vol.block_alloc_frame
    if getattr(vol, "with_labels", False):
        out.update(label=vol.label, label_conf=vol.label_conf)
    return out


def tsdf_volume_from_numpy(cam: cameras.Camera, arrays: dict,
                           device="cuda", **kw) -> TSDFVolume:
    """A port TSDFVolume from the JAX TSDFVolume's state: ``block_coords``,
    ``n_blocks``, ``block_map``, ``tsdf``, ``weight``, ``color`` (full
    capacity, numpy), ``block_version``, ``frame_idx`` and, where given,
    ``block_alloc_frame`` and the voxel labels (``label``, ``label_conf``:
    the volume then keeps labels); ``kw`` are the volume's settings
    (voxel_size, ...), its capacity that of the arrays."""
    kw.setdefault("with_labels", "label" in arrays)
    vol = TSDFVolume(cam, max_blocks=arrays["block_coords"].shape[0],
                     device=device, **kw)
    vol.n_blocks = int(arrays["n_blocks"])
    vol.block_map = {tuple(int(v) for v in k): int(i)
                     for k, i in arrays["block_map"].items()}
    vol.frame_idx = int(arrays["frame_idx"])
    for name in ("block_coords", "block_version", "block_alloc_frame"):
        if name in arrays:
            cur = getattr(vol, name)
            setattr(vol, name, np.array(arrays[name], dtype=cur.dtype,
                                        copy=True))
    for name in ("tsdf", "weight", "color", "label", "label_conf"):
        if name in vol._dev:
            full = vol._dev[name]
            full.copy_(vol._put(np.asarray(arrays[name]), full.dtype))
    return vol


def dense_mapper_from_numpy(cam: cameras.Camera, state: dict,
                            device="cuda", **kw):
    """A port DenseMapper carrying a JAX DenseMapper's state: ``volume``
    and ``coarse`` (``tsdf_state`` dicts, ``coarse`` None without the far
    field), ``next_global`` (the label map's next id), ``labels`` ({kf_id:
    global label image}), ``keyframes`` ([(kf_id, raw depth, color)]) and
    ``n_inserted``; ``kw`` are the mapper's settings. The incremental
    mesher starts empty."""
    dm = DenseMapper(cam, device=device, **kw)
    dm.volume = tsdf_volume_from_numpy(
        cam, state["volume"], device=device, voxel_size=dm.voxel_size,
        bucket_floor=dm.volume.bucket_floor,
        with_labels=dm.use_segmentation)
    dm.mesher = IncrementalMesher(dm.volume)
    if state.get("coarse") is not None:
        dm.coarse = tsdf_volume_from_numpy(
            cam, state["coarse"], device=device,
            voxel_size=dm.coarse.voxel_size, max_depth=dm.coarse.max_depth)
    if dm.use_segmentation:
        dm.label_map.next_global = int(state["next_global"])
    dm.labels = {int(k): np.array(v, np.int32, copy=True)
                 for k, v in state.get("labels", {}).items()}
    dm.keyframes = [DenseKeyFrame(int(k), dm.volume._put(d),
                                  dm.volume._put(c))
                    for k, d, c in state.get("keyframes", [])]
    dm._n_inserted = int(state.get("n_inserted", len(dm.keyframes)))
    return dm
