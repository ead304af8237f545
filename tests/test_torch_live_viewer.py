"""The port's live viewer (viz/live_server.py) against the JAX package's:
the same ``state()`` and ``mesh_state()`` payloads on one map, a port
System served through a real socket with every control verb, a dense
System whose ``/mesh.json`` has triangles, and ``mesh_state()`` called
from another thread while frames are tracked (the port serialises it with
the dense mapper's lock; the final mesh must equal an undisturbed run's).

The JAX viewer reads a stand-in System that holds a JAX store converted
from the port's (every column and counter copied), the port's trajectory
and tracker pose: the payloads must then be equal, key for key.
"""

import collections
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from plvs_tpu.slam.map_store import MapStore as JStore
from plvs_tpu.viz import live_server as jls
from plvs_tpu_torch.geometry import cameras
from plvs_tpu_torch.io import serialization, synthetic
from plvs_tpu_torch.slam import System, SystemConfig
from plvs_tpu_torch.viz import live_server as tls
from plvs_tpu_torch.viz.map_drawer import covisibility_segments
from test_torch_place_recognition import _need_native

CAM = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                      bf=24.0)
FLAGS = dict(num_features=512, n_levels=4, max_kf=64, max_pts=16384,
             local_ba=False, loop_closing=False, pipelined=False)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.read()


def _tracked(n_frames=6, max_pts=16384, **kw):
    system = System(CAM, SystemConfig(**{**FLAGS, "max_pts": max_pts, **kw}),
                    device="cpu")
    scene = synthetic.SyntheticRGBD(CAM, wall_z=3.0, seed=0)
    for ts, gray, depth, _, _ in scene.sequence(n_frames=n_frames):
        system.track_rgbd(gray, depth, ts)
    return system


@pytest.fixture(scope="module")
def system():
    """Six frames of tests/test_live_viewer.py's scene; max_pts small
    enough that the viewer decimates the points."""
    return _tracked(max_pts=4096)


class _JaxView:
    """What the JAX viewer reads of a System, over a JAX store holding the
    port store's columns."""

    def __init__(self, tsys, dense_mapper=None):
        ts = tsys.store
        js = JStore(max_kf=ts.max_kf, max_pts=ts.max_pts, max_obs=ts.max_obs,
                    n_kp=ts.n_kp, max_lines=ts.max_lines,
                    max_lobs=ts.max_lobs, n_kl=ts.n_kl)
        for name, val in vars(ts).items():
            cur = getattr(js, name, None)
            if isinstance(cur, np.ndarray):
                setattr(js, name, np.array(val, dtype=cur.dtype, copy=True))
            elif isinstance(cur, int) and not isinstance(cur, bool):
                setattr(js, name, int(val))
        self.store = js
        self.trajectory = list(tsys.trajectory)
        self.tracker = tsys.tracker
        self.dense_mapper = dense_mapper
        self._stats = tsys.map_statistics()

    def map_statistics(self):
        return self._stats


def test_state_equals_the_jax_viewers(system):
    """``state()`` key for key equal to the JAX viewer's on the same map;
    and held to the store: the live points decimated to <= max_points, one
    centre per live keyframe, one trajectory entry per frame, a 12-number
    frustum, the covisibility segments of ``covisibility_segments``."""
    _need_native()
    tv = tls.LiveViewer(system, max_points=500)
    jv = jls.LiveViewer(_JaxView(system), max_points=500)
    try:
        got, want = tv.state(), jv.state()
    finally:
        tv.close()
        jv.close()
    assert got == want
    st = system.store
    live = np.nonzero(st.pt_mask)[0]
    assert len(live) > 500
    stride = len(live) // 500 + 1
    np.testing.assert_array_equal(
        got["points"], np.round(st.pt_xyz[live[::stride]], 3))
    assert len(got["keyframes"]) == int(st.kf_mask.sum()) >= 1
    assert len(got["trajectory"]) == len(system.trajectory) == 6
    assert len(got["frustum"]) == 12
    covis = covisibility_segments(st)
    assert got["covis"] == [np.round(np.concatenate(s), 3).tolist()
                            for s in covis[:2000]]


class _StubMapper:
    def __init__(self, V, F):
        self.V, self.F = V, F

    def mesh_incremental(self):
        return self.V, self.F


@pytest.mark.parametrize("n_tris", [0, 30, 25000])
def test_mesh_state_equals_the_jax_viewers(system, n_tris):
    """The triangle and wireframe payloads of one mesh (none, small, over
    max_tris so it is decimated) equal the JAX viewer's."""
    rng = np.random.default_rng(n_tris)
    V = rng.normal(size=(3 * n_tris, 3)).astype(np.float32)
    F = np.arange(3 * n_tris, dtype=np.int32).reshape(-1, 3)
    tv = tls.LiveViewer(system)
    view = _JaxView(system, dense_mapper=_StubMapper(V, F))
    jv = jls.LiveViewer(view)
    saved = system.dense_mapper
    system.dense_mapper = _StubMapper(V, F)
    try:
        got, want = tv.mesh_state(), jv.mesh_state()
    finally:
        system.dense_mapper = saved
        tv.close()
        jv.close()
    assert got == want
    assert (len(got["tris"]) > 0) == (n_tris > 0)


def test_state_and_controls_through_a_socket(system, tmp_path):
    """tests/test_live_viewer.py's session against the port: the page, the
    state, the empty mesh of a System without a dense mapper, pause /
    resume, save (the atlas loads), localization / mapping; a save into a
    missing directory answers HTTP 500 with the error."""
    save_path = os.path.join(tmp_path, "live_map.npz")
    viewer = tls.LiveViewer(system, save_path=save_path)
    try:
        page = _get(viewer.port, "/")
        assert b"canvas" in page and b"webgl" in page
        state = json.loads(_get(viewer.port, "/state.json"))
        assert state["stats"]["keyframes"] >= 1
        assert len(state["trajectory"]) == 6 and len(state["points"]) > 0
        assert state["pose"] is not None and len(state["frustum"]) == 12
        assert "lines" in state and "covis" in state
        assert state["trajectory"][-1][0] > state["trajectory"][0][0]
        assert json.loads(_get(viewer.port, "/mesh.json")) == {
            "tris": [], "wire": []}
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(viewer.port, "/nothing")
        assert e.value.code == 404

        _get(viewer.port, "/cmd?op=pause")
        assert json.loads(_get(viewer.port, "/state.json"))["paused"]
        viewer.wait_if_paused(timeout=0.1)  # returns via timeout
        _get(viewer.port, "/cmd?op=resume")
        assert not json.loads(_get(viewer.port, "/state.json"))["paused"]

        assert _get(viewer.port, "/cmd?op=save") == b"ok"
        st, _ = serialization.load_atlas(save_path)
        assert st.num_keyframes == system.store.num_keyframes
        np.testing.assert_array_equal(st.pt_xyz, system.store.pt_xyz)

        _get(viewer.port, "/cmd?op=localization")
        assert system.tracker.only_tracking
        _get(viewer.port, "/cmd?op=mapping")
        assert not system.tracker.only_tracking

        viewer.save_path = os.path.join(tmp_path, "missing", "map.npz")
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(viewer.port, "/cmd?op=save")
        assert e.value.code == 500
        assert e.value.read().startswith(b"save failed:")
    finally:
        viewer.close()


def _sorted_tris(V):
    tri = np.asarray(V, np.float32).reshape(-1, 9)
    return tri[np.lexsort(tri.T[::-1])]


def test_dense_mesh_served_while_frames_are_tracked():
    """A dense System meshing every keyframe on the tracking thread while
    another thread calls ``mesh_state()`` every 50 ms: no error, never two
    threads inside the mapper's integration or meshing at once, the
    page's ``/mesh.json`` has triangles, and after a last
    ``mesh_incremental()`` the cached mesh equals (as a set of triangles)
    that of the same run with no viewer."""
    n = 6
    flags = dict(dense_mapping=True, dense_mesh_every=1)
    quiet = _tracked(n_frames=n, **flags)
    want = _sorted_tris(quiet.dense_mapper.mesh_incremental()[0])
    assert len(want) > 0

    system = System(CAM, SystemConfig(**FLAGS, **flags), device="cpu")
    # the mapper's state changes, each held open a little longer: two
    # threads inside them at once is the race the lock prevents
    dm = system.dense_mapper
    inside, overlaps, guard = collections.Counter(), [], threading.Lock()

    def watched(fn):
        def run(*a, **kw):
            me = threading.get_ident()
            with guard:
                inside[me] += 1
                if sum(1 for n in inside.values() if n) > 1:
                    overlaps.append(fn.__name__)
            try:
                time.sleep(0.002)
                return fn(*a, **kw)
            finally:
                with guard:
                    inside[me] -= 1
        return run

    for obj, name in ((dm.mesher, "update_begin"),
                      (dm.mesher, "update_finish"),
                      (dm.volume, "integrate"), (dm.volume, "apply_touched")):
        setattr(obj, name, watched(getattr(obj, name)))
    viewer = tls.LiveViewer(system)
    stop = threading.Event()
    calls, errors = [], []

    def hammer():
        while not stop.is_set():
            try:
                calls.append(len(viewer.mesh_state()["tris"]))
            except Exception as e:  # recorded, then the test fails on it
                errors.append(e)
                return
            stop.wait(0.05)  # a browser polls; leave the tracker the GIL

    th = threading.Thread(target=hammer)
    th.start()
    try:
        scene = synthetic.SyntheticRGBD(CAM, wall_z=3.0, seed=0)
        for ts, gray, depth, _, _ in scene.sequence(n_frames=n):
            system.track_rgbd(gray, depth, ts)
    finally:
        stop.set()
        th.join()
    try:
        assert not errors, errors
        assert not overlaps, overlaps
        assert len(calls) >= n and max(calls) > 0
        mesh = json.loads(_get(viewer.port, "/mesh.json"))
        assert len(mesh["tris"]) > 0 and len(mesh["tris"]) % 18 == 0
    finally:
        viewer.close()
    got = _sorted_tris(system.dense_mapper.mesh_incremental()[0])
    np.testing.assert_array_equal(got, want)
