"""The window's arithmetic, the trajectory error and the roofline counts."""

import time
import types

import numpy as np
import pytest

from slam_bench import harness, registry, roofline, trace
from slam_bench.reference import evaluation
from slam_bench.tests import tiny


class _StubSystem:
    """Resolves frame i when frame i + ``lag`` is fed (or at a flush),
    sleeping ``step`` a call and ``stall`` more at the frame ``stall_ts``."""

    def __init__(self, step=0.01, lag=0, stall_ts=None, stall=0.0):
        self.step, self.lag = step, lag
        self.stall_ts, self.stall = stall_ts, stall
        self.trajectory = []
        self.store = types.SimpleNamespace(_next_kf_uid=1)
        self.dense_mapper = None
        self.pending = []
        self.resets = 0

    def _post_track(self, res, timestamp, dense_payload=None):
        self.trajectory.append((timestamp, None, None))
        return res.state, None, None

    def _resolve(self, keep):
        while len(self.pending) > keep:
            ts = self.pending.pop(0)
            self._post_track(types.SimpleNamespace(state=harness.OK), ts)

    def track_rgbd(self, gray, depth, ts):
        time.sleep(self.step + (self.stall if ts == self.stall_ts else 0.0))
        self.pending.append(ts)
        self._resolve(self.lag)

    def flush(self):
        self._resolve(0)

    def reset(self):
        self.flush()
        self.resets += 1
        self.store = types.SimpleNamespace(_next_kf_uid=1)

    def set_stopwatch(self, watch):
        pass


def _session(n=20):
    return types.SimpleNamespace(
        sensor="rgbd", fps=10.0,
        frames=[(i / 10.0, None, None) for i in range(n)])


def _window(system, seconds):
    probe = harness.Probe(system)
    logs, t0, t1 = harness.run_window(system, _session(), seconds, probe,
                                      None)
    n = sum(len(log.t_done) for log in logs)
    return logs, n / (t1 - t0)


def test_a_stall_in_the_window_lowers_frames_per_s():
    _, fps = _window(_StubSystem(), 0.6)
    _, fps_stall = _window(_StubSystem(stall_ts=0.5, stall=0.2), 0.6)
    assert fps_stall < 0.8 * fps


def test_every_frame_fed_resolves_and_sessions_reset():
    system = _StubSystem(lag=3)
    logs, _ = _window(system, 0.7)
    assert system.resets == sum(1 for log in logs[:-1] if log.complete)
    for log in logs:
        assert set(log.t_done) == set(log.fed)
    assert harness.count_failed(logs, 0.0) == 0


def test_latency_runs_to_the_call_that_resolves_the_frame():
    system = _StubSystem(step=0.02, lag=2)
    logs, _ = _window(system, 0.3)
    log = logs[0]
    ts = log.fed[0]
    # frame 0 resolves when frame 2 is fed: its latency spans three calls
    assert log.t_done[ts] == log.t_call_end[log.fed[2]]
    lat = harness.frame_latencies_ms(logs)
    assert min(lat[:-2]) >= 3 * 20.0 * 0.9


def test_p95_is_taken_over_all_frames_not_over_chunks():
    reader = registry.load_reader(registry.HERE, "frame_ms_p95")
    lat = [10.0] * 90 + [1000.0] * 10
    chunks = [lat[i:i + 20] for i in range(0, 100, 20)]
    chunked = float(np.mean([np.percentile(c, 95) for c in chunks]))
    got = reader.read({"latencies_ms": lat})
    assert got == pytest.approx(float(np.percentile(lat, 95)))
    assert got != pytest.approx(chunked)


def test_ate_is_invariant_to_a_rigid_transform_of_the_estimate():
    rng = np.random.default_rng(3)
    gt = np.cumsum(rng.normal(0, 0.05, (40, 3)), 0)
    est = gt + rng.normal(0, 0.004, gt.shape)
    a, _ = evaluation.aligned_errors(est, gt)
    from scipy.spatial.transform import Rotation

    R = Rotation.from_rotvec([0.3, -1.1, 0.7]).as_matrix()
    moved = est @ R.T + np.array([2.0, -5.0, 0.5])
    b, _ = evaluation.aligned_errors(moved, gt)
    assert np.allclose(a, b, atol=1e-9)
    assert evaluation.pooled_rmse([a]) == pytest.approx(
        evaluation.ate_rmse(est, gt))


def test_first_frame_transform_carries_points_into_the_truth():
    from scipy.spatial.transform import Rotation

    R0 = Rotation.from_rotvec([0.1, 0.2, -0.3]).as_matrix()
    t0 = np.array([0.3, -0.2, 1.0])
    # the estimate's world is the first camera: its pose is the identity
    row0 = np.array([0.0, 0, 0, 0, 0, 0, 0, 1])
    R, t = evaluation.first_frame_transform(row0, R0, t0)
    X_cam = np.array([[0.5, -0.1, 3.0]])
    X_world = (X_cam - t0) @ R0  # R0^T (X - t0)
    assert np.allclose(X_cam @ R.T + t, X_world)


def test_roofline_counts_at_k1_and_k2_shapes():
    # K1 at (4096, 1024): both descriptor sets once, the int32 matrix once
    n_bytes, n_ops = roofline.k1_bytes_ops(4096, 1024)
    assert n_bytes == (4096 + 1024) * 32 + 4096 * 1024 * 4
    assert n_ops == 4096 * 1024 * 24
    ms, by = roofline.k1_bound_ms(4096, 1024)
    assert by == "bytes" and ms == pytest.approx(0.005057, abs=1e-6)
    # K2 at the 640x480 line image's 240x320 grid
    assert roofline.k2_bytes_ops(240, 320, 0)[0] == 12 * 240 * 320
    ms2, by2 = roofline.k2_bound_ms(240, 320)
    assert by2 == "bytes" and ms2 == pytest.approx(0.000275, abs=1e-6)
    assert roofline.k2_bound_ms(240, 320, 0)[0] == ms2


def test_k1_roofline_reader_over_a_span():
    reader = registry.load_reader(registry.HERE, "k1_roofline")
    span = {"k1_shapes": {(4096, 1024): 2},
            "by_name": {"hamming_bmma_kernel(x)": (2, 2 * 0.010e-3)}}
    ctx = {"span": span, "roofline": roofline, "trace": trace}
    assert reader.read(ctx) == pytest.approx(100 * 0.005057 / 0.010,
                                             rel=1e-3)
    span["by_name"] = {}
    assert reader.read(ctx) is None


def test_device_intervals_union_and_idle_share():
    iv = np.array([[0, 10], [5, 12], [20, 30]])
    u = trace._union(iv)
    assert u.tolist() == [[0, 12], [20, 30]]
    assert trace.idle_share(0.25, 1.0) == pytest.approx(0.75)
    assert trace.idle_share(0.25, None) is None


def test_stereo_room_orbit_session_is_a_rectified_pair():
    """The generator's branches that a stereo cell's data files select:
    the room, the orbit and the rectified pair (no cell drives them yet)."""
    from scipy.ndimage import map_coordinates

    from slam_bench import scenes, traffic

    cfg = dict(tiny.SMALL, **{"Bench.sensor": "stereo", "Camera.fps": 20.0,
                              "Sequence.frames": 4})
    mix = {"scene": {"kind": "room", "half": 3.0, "tex_size": 512,
                     "tex_seed": 3},
           "trajectory": {"kind": "orbit", "radius": 0.6, "laps": 0.5},
           "mode": "mapping", "feed": "closed"}
    s = traffic.build_session(mix, cfg, 2 ** 31 + 5)
    assert s.sensor == "stereo" and len(s.frames) == 4
    assert np.allclose(np.linalg.norm(s.centres[:, [0, 2]], axis=1), 0.6,
                       atol=1e-5)
    cam = traffic.camera(cfg)
    R, t = s.poses[1]
    _, left, right = s.frames[1]
    _, depth = s.scene.render(R, t)
    # a left pixel (v, u) at depth z sits at (v, u - bf / z) on the right
    v, u = np.mgrid[20:220:7, 40:300:7].reshape(2, -1)
    z = depth[v, u]
    got = map_coordinates(right, [v, u - cam.bf / z], order=1)
    assert np.median(np.abs(got - left[v, u])) < 2.0
    # every rendered pixel lies on a wall
    X_c = cam.rays()[:, v * cam.width + u] * z
    X_w = (X_c - t[:, None]).T @ R
    assert np.abs(s.scene.surface_distance(X_w)).max() < 1e-3
    assert isinstance(s.scene, scenes.SyntheticRoom)
