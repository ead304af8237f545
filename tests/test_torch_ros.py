"""The port's ROS layer (plvs_tpu_torch/ros/) against the JAX package's,
without ROS: every conversion on the same fake messages, the
approximate-time pairing and the IMU queue on the same pushes, and the
bridges over a port System on the CPU.

Messages are duck-typed dataclasses, as in tests/test_ros.py. Images and
depth maps are exact in both packages (the same numpy code); the pose
message's quaternion comes from each package's ``rotmat_to_quat`` on the
same float32 3x3 (1e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

from plvs_tpu.ros import conversions as jcv
from plvs_tpu.ros import nodes as jnodes
from plvs_tpu.ros import ros1_nodes as jros1
from plvs_tpu_torch.geometry import cameras
from plvs_tpu_torch.io import synthetic
from plvs_tpu_torch.ros import conversions as tcv
from plvs_tpu_torch.ros import nodes as tnodes
from plvs_tpu_torch.ros import ros1_nodes as tros1
from plvs_tpu_torch.slam import System, SystemConfig

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


@dataclasses.dataclass
class Stamp:
    sec: int
    nanosec: int


@dataclasses.dataclass
class Header:
    stamp: Stamp
    frame_id: str = ""


@dataclasses.dataclass
class Image:
    height: int
    width: int
    encoding: str
    step: int
    data: bytes
    header: Header = None


@dataclasses.dataclass
class Info:
    k: list
    d: list
    width: int
    height: int
    distortion_model: str


def _stamp(ts: float) -> Stamp:
    ns = int(round(ts * 1e9))
    return Stamp(ns // 10 ** 9, ns % 10 ** 9)


def _img(arr: np.ndarray, encoding: str, ts: float = 0.0, pad: int = 0):
    """A message of ``arr`` ([H, W] or [H, W, C]) with ``pad`` bytes of row
    padding (``step`` > width x bytes per pixel)."""
    h, w = arr.shape[:2]
    rows = arr.reshape(h, -1).view(np.uint8)
    rows = np.concatenate([rows, np.zeros((h, pad), np.uint8)], 1)
    return Image(h, w, encoding, rows.shape[1], rows.tobytes(),
                 Header(_stamp(ts)))


def mono8(gray, ts):
    return _img(np.clip(np.round(gray), 0, 255).astype(np.uint8), "mono8", ts)


def depth16(depth, ts):
    mm = np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16)
    return _img(mm, "16UC1", ts)


# ---------------------------------------------------------------------------
# conversions


def test_image_conversions_match_jax(rng):
    """Every encoding both packages read, with and without row padding:
    equal arrays; an unknown encoding raises ValueError in both."""
    h, w = 9, 13
    u8 = rng.integers(0, 256, (h, w), dtype=np.uint8)
    u16 = rng.integers(0, 65536, (h, w), dtype=np.uint16)
    c3 = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    c4 = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    f32 = rng.uniform(0.2, 5.0, (h, w)).astype(np.float32)
    f32[rng.random((h, w)) < 0.2] = np.nan
    f32[0, 0], f32[0, 1] = np.inf, -np.inf
    for pad in (0, 4):
        for arr, enc in ((u8, "mono8"), (u16, "mono16"), (c3, "rgb8"),
                         (c3, "bgr8"), (c4, "rgba8"), (c4, "BGRA8")):
            msg = _img(arr, enc, pad=pad)
            got, want = tcv.image_to_gray(msg), jcv.image_to_gray(msg)
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
        for arr, enc in ((u16, "16UC1"), (u16, "mono16"), (f32, "32FC1")):
            msg = _img(arr, enc, pad=pad)
            for scale in (1.0, 0.5):
                got = tcv.image_to_depth(msg, scale)
                np.testing.assert_array_equal(got,
                                              jcv.image_to_depth(msg, scale))
    bad = _img(u8, "yuv422")
    for fn in (tcv.image_to_gray, jcv.image_to_gray, tcv.image_to_depth,
               jcv.image_to_depth):
        with pytest.raises(ValueError):
            fn(bad)


@pytest.mark.parametrize("model,d", [
    ("plumb_bob", [0.1, -0.2, 0.001, -0.002, 0.05]),
    ("plumb_bob", [0.1, -0.2]),
    ("equidistant", [0.01, -0.02, 0.003, -0.001]),
    ("", [])])
def test_camera_from_info_matches_jax(model, d):
    info = Info([525.0, 0, 319.5, 0, 524.0, 239.5, 0, 0, 1], d, 640, 480,
                model)
    got, want = tcv.camera_from_info(info, bf=40.0), \
        jcv.camera_from_info(info, bf=40.0)
    assert got.kind == want.kind
    assert (got.width, got.height, got.bf) == (want.width, want.height,
                                               want.bf)
    np.testing.assert_array_equal(np.asarray(got.params, np.float64),
                                  np.asarray(want.params, np.float64))


def test_pose_and_cloud_messages_match_jax(rng):
    """Poses at random rotations (each of the quaternion's four pivot
    cases among them): positions exact, quaternions within 1e-6; the
    PointCloud2 xyzrgb bytes equal."""
    rots = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
            np.diag([-1.0, -1.0, 1.0])]
    for _ in range(12):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        rots.append(q * np.sign(np.linalg.det(q)))
    for R in rots:
        R = R.astype(np.float32)
        t = rng.normal(size=3).astype(np.float32)
        got, want = tcv.pose_to_msg_dict(R, t), jcv.pose_to_msg_dict(R, t)
        assert got["position"] == want["position"]
        for k in "xyzw":
            assert abs(got["orientation"][k] - want["orientation"][k]) < 1e-6
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    assert tcv.cloud_to_xyz_rgb_bytes(pts, cols) == \
        jcv.cloud_to_xyz_rgb_bytes(pts, cols)
    assert tcv.stamp_to_sec(Stamp(12, 345678901)) == \
        jcv.stamp_to_sec(Stamp(12, 345678901))


# ---------------------------------------------------------------------------
# pairing and the IMU queue


@pytest.mark.parametrize("max_dt,queue", [(0.02, 30), (0.005, 4)])
def test_approx_time_sync_matches_jax(rng, max_dt, queue):
    """Two jittered streams with drops, bursts and a long gap: the same
    pair (or None) after every push, and the same queues at the end."""
    ta = np.cumsum(rng.uniform(0.02, 0.045, 200))
    tb = ta + rng.normal(0, 0.012, 200)
    keep_b = rng.random(200) > 0.15
    tb[120:] += 0.5                                    # a long gap
    events = [(t, "a", f"a{i}") for i, t in enumerate(ta)]
    events += [(t, "b", f"b{i}") for i, t in enumerate(tb) if keep_b[i]]
    order = np.argsort([e[0] + rng.normal(0, 0.01) for e in events],
                       kind="stable")
    got_s, want_s = tnodes.ApproxTimeSync(max_dt, queue), \
        jnodes.ApproxTimeSync(max_dt, queue)
    pairs = 0
    for i in order:
        t, side, msg = events[i]
        got = getattr(got_s, f"push_{side}")(float(t), msg)
        want = getattr(want_s, f"push_{side}")(float(t), msg)
        assert got == want
        pairs += got is not None
    assert pairs > 20
    assert got_s.a == want_s.a and got_s.b == want_s.b


def test_imu_queue_matches_jax(rng):
    """Random stamps drained at image stamps: the same batches (times and
    float32 samples) and the same remainder; None when nothing is due."""
    tq, jq = tros1.ImuQueue(), jros1.ImuQueue()
    stamps = np.sort(rng.uniform(0, 1, 300))
    for t in stamps:
        g, a = rng.normal(size=3), rng.normal(size=3)
        tq.push(float(t), g, a)
        jq.push(float(t), g, a)
    for t_img in (-0.1, 0.1, 0.1, 0.33, 0.5, 0.9, 2.0, 3.0):
        got, want = tq.drain_until(t_img), jq.drain_until(t_img)
        if want is None:
            assert got is None
            continue
        assert len(got) == len(want)
        for (t1, g1, a1), (t2, g2, a2) in zip(got, want):
            assert t1 == t2 and g1.dtype == g2.dtype == np.float32
            np.testing.assert_array_equal(g1, g2)
            np.testing.assert_array_equal(a1, a2)
    assert tq.samples == jq.samples == []


# ---------------------------------------------------------------------------
# the bridges


def test_rgbd_bridge_tracks_as_the_system_does():
    """Six frames as mono8 and 16UC1 messages, the depth first on odd
    frames: the bridge pairs every frame and tracks each as the System fed
    the converted arrays directly (the same states and poses exactly), and
    its pose messages hold the camera centres."""
    scene = synthetic.SyntheticRGBD(CAM, wall_z=3.0, seed=0)
    frames = list(scene.sequence(n_frames=6))
    bridge = tnodes.RgbdSlamBridge(System(CAM, SystemConfig(**FLAGS),
                                          device="cpu"))
    direct = System(CAM, SystemConfig(**FLAGS), device="cpu")
    outs = []
    for i, (ts, g, d, _, _) in enumerate(frames):
        m_rgb, m_d = mono8(g, ts), depth16(d, ts)
        if i % 2:
            assert bridge.on_depth(m_d) is None
            outs.append(bridge.on_rgb(m_rgb))
        else:
            assert bridge.on_rgb(m_rgb) is None
            outs.append(bridge.on_depth(m_d))
        state, R, t = direct.track_rgbd(tcv.image_to_gray(m_rgb),
                                        tcv.image_to_depth(m_d), ts)
        assert outs[-1][0] == state == 2
        pose = outs[-1][1]
        C = np.array([pose["position"][k] for k in "xyz"])
        np.testing.assert_array_equal(C, (-R.T @ t).astype(C.dtype))
    assert len(bridge.poses) == 6
    # stamps travel as (sec, nanosec)
    assert [p[0] for p in bridge.poses] == pytest.approx(
        [f[0] for f in frames], abs=1e-9)


def test_mono_and_inertial_bridges():
    """The mono bridge tracks (NOT_INITIALIZED, then a pose message); the
    inertial bridges hand each image the IMU samples up to its stamp."""
    scene = synthetic.SyntheticRGBD(CAM, wall_z=3.0, seed=0)
    frames = list(scene.sequence(n_frames=2))
    mono = tnodes.MonoSlamBridge(System(
        CAM, SystemConfig(**{**FLAGS, "sensor": "mono"}), device="cpu"))
    state, pose = mono.on_image(mono8(frames[0][1], frames[0][0]))
    assert state == 1 and set(pose) == {"position", "orientation"}

    class Recorder:
        def __init__(self):
            self.calls = []

        def _rec(self, *a, **kw):
            self.calls.append((a, kw))
            return 2, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)

        track_monocular = track_stereo = _rec

    rec = Recorder()
    mb = tros1.MonoInertialBridge(rec)
    sb = tros1.StereoInertialBridge(rec)
    for t in np.arange(0.0, 0.1, 0.005):
        mb.on_imu(float(t), (0, 0, 0.1), (0, 0, 9.81))
        sb.on_imu(float(t), (0, 0, 0.1), (0, 0, 9.81))
    g = np.zeros((4, 4), np.float32)
    mb.on_image(mono8(g, 0.05))
    sb.on_left(mono8(g, 0.05))
    sb.on_right(mono8(g, 0.051))
    for (_, kw) in rec.calls:
        assert [s[0] for s in kw["imu_samples"]] == pytest.approx(
            np.arange(0.0, 0.0501, 0.005))
    assert len(rec.calls) == 2 and len(mb.imu.samples) == 9


def test_system_from_argv_takes_the_device():
    """``--cpu`` builds a CPU System; the default asks for CUDA and raises
    without it; the rospy mains import without ROS."""
    system, args = tnodes._system_from_argv(["--cpu", "--rgb-topic", "x"],
                                            "rgbd")
    assert system.device.type == "cpu" and args.rgb_topic == "x"
    assert system.config.sensor == "rgbd"
    system, _ = tnodes._system_from_argv(["--device", "cpu"], "mono")
    assert system.config.sensor == "mono"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tnodes._system_from_argv([], "stereo")
    assert callable(tros1.main_stereo_inertial)
    assert callable(tnodes.main_rgbd)
