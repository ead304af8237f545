"""ROS 2 SLAM nodes (optional; they need rclpy at run time).

Counterpart of plvs_tpu/ros/nodes.py (the reference's ROS bindings:
rclcpp nodes Examples/ROS2/PLVS/src/{monocular,rgbd,stereo}/*, ROS1 nodes
Examples_old/ROS/PLVS/src/ros_{mono,rgbd,stereo}.cc). Each node wraps one
``plvs_tpu_torch.slam.System`` on ``--device`` (``cuda`` by default;
``--cpu`` is ``--device cpu``, and without CUDA the default raises),
pairs its image topics with an approximate-time queue (the
message_filters ApproximateTime role, ros_rgbd.cc:364-369), feeds
Track* and publishes the camera pose.

rclpy is imported inside ``main_*`` only, so the module imports without
ROS; the pairing and the conversions are plain Python, tested without ROS.
"""

from __future__ import annotations

import numpy as np

from . import conversions as cv


class ApproxTimeSync:
    """Minimal approximate-time synchronizer for two topics
    (the message_filters role in the reference nodes)."""

    def __init__(self, max_dt: float = 0.02, queue: int = 30):
        self.max_dt = max_dt
        self.queue = queue
        self.a: list = []
        self.b: list = []

    def _match(self):
        """Pop and return the best (a, b) pair within max_dt, else None."""
        while self.a and self.b:
            ta = self.a[0][0]
            # best b for the oldest a
            dts = [abs(tb - ta) for tb, _ in self.b]
            j = int(np.argmin(dts))
            if dts[j] <= self.max_dt:
                _, ma = self.a.pop(0)
                tb, mb = self.b.pop(j)
                del self.b[:j]
                return ma, mb
            # the oldest a can never match (all b too far) -> drop the older
            if self.b[0][0] < ta - self.max_dt:
                self.b.pop(0)
            else:
                self.a.pop(0)
        return None

    def push_a(self, stamp: float, msg):
        self.a.append((stamp, msg))
        del self.a[:-self.queue]
        return self._match()

    def push_b(self, stamp: float, msg):
        self.b.append((stamp, msg))
        del self.b[:-self.queue]
        return self._match()


class RgbdSlamBridge:
    """ROS-free core of the RGB-D node: sync two image streams and feed
    the SLAM system (reference: rgbd-slam-node.cpp GrabRGBD)."""

    def __init__(self, system, depth_scale: float = 1.0, max_dt: float = 0.02):
        self.system = system
        self.depth_scale = depth_scale
        self.sync = ApproxTimeSync(max_dt=max_dt)
        self.poses: list = []

    def _track(self, rgb_msg, depth_msg):
        ts = cv.stamp_to_sec(rgb_msg.header.stamp)
        gray = cv.image_to_gray(rgb_msg)
        depth = cv.image_to_depth(depth_msg, self.depth_scale)
        state, R, t = self.system.track_rgbd(gray, depth, ts)
        pose = cv.pose_to_msg_dict(R, t)
        self.poses.append((ts, state, pose))
        return state, pose

    def on_rgb(self, msg):
        pair = self.sync.push_a(cv.stamp_to_sec(msg.header.stamp), msg)
        return self._track(*pair) if pair else None

    def on_depth(self, msg):
        pair = self.sync.push_b(cv.stamp_to_sec(msg.header.stamp), msg)
        return self._track(pair[0], pair[1]) if pair else None


class StereoSlamBridge:
    """ROS-free core of the stereo node (reference: stereo-slam-node.cpp)."""

    def __init__(self, system, max_dt: float = 0.005):
        self.system = system
        self.sync = ApproxTimeSync(max_dt=max_dt)
        self.poses: list = []

    def _track(self, left_msg, right_msg):
        ts = cv.stamp_to_sec(left_msg.header.stamp)
        state, R, t = self.system.track_stereo(
            cv.image_to_gray(left_msg), cv.image_to_gray(right_msg), ts)
        pose = cv.pose_to_msg_dict(R, t)
        self.poses.append((ts, state, pose))
        return state, pose

    def on_left(self, msg):
        pair = self.sync.push_a(cv.stamp_to_sec(msg.header.stamp), msg)
        return self._track(*pair) if pair else None

    def on_right(self, msg):
        pair = self.sync.push_b(cv.stamp_to_sec(msg.header.stamp), msg)
        return self._track(pair[0], pair[1]) if pair else None


class MonoSlamBridge:
    """ROS-free core of the monocular node (reference: monocular-slam-node.cpp)."""

    def __init__(self, system):
        self.system = system
        self.poses: list = []

    def on_image(self, msg):
        ts = cv.stamp_to_sec(msg.header.stamp)
        state, R, t = self.system.track_monocular(cv.image_to_gray(msg), ts)
        pose = cv.pose_to_msg_dict(R, t)
        self.poses.append((ts, state, pose))
        return state, pose


def _make_node(node_name: str, bridge_topics):
    """Build and spin an rclpy node wiring topics to a bridge. Only called
    from the mains below; requires rclpy + sensor_msgs installed."""
    import rclpy
    from geometry_msgs.msg import PoseStamped
    from rclpy.node import Node
    from sensor_msgs.msg import Image

    class SlamNode(Node):
        def __init__(self, bridge, topics):
            super().__init__(node_name)
            self.bridge = bridge
            self.pose_pub = self.create_publisher(PoseStamped, "slam/pose", 10)
            for topic, cb_name in topics:
                cb = getattr(bridge, cb_name)
                self.create_subscription(
                    Image, topic,
                    lambda msg, cb=cb: self._on(msg, cb), 10)

        def _on(self, msg, cb):
            out = cb(msg)
            if out is None:
                return
            state, pose = out
            ps = PoseStamped()
            ps.header = msg.header
            ps.header.frame_id = "map"
            ps.pose.position.x = pose["position"]["x"]
            ps.pose.position.y = pose["position"]["y"]
            ps.pose.position.z = pose["position"]["z"]
            ps.pose.orientation.x = pose["orientation"]["x"]
            ps.pose.orientation.y = pose["orientation"]["y"]
            ps.pose.orientation.z = pose["orientation"]["z"]
            ps.pose.orientation.w = pose["orientation"]["w"]
            self.pose_pub.publish(ps)

    rclpy.init()
    bridge, topics = bridge_topics()
    node = SlamNode(bridge, topics)
    try:
        rclpy.spin(node)
    finally:
        node.destroy_node()
        rclpy.shutdown()


def _system_from_argv(argv, sensor: str, use_imu: bool = False):
    import argparse

    from ..geometry import cameras
    from ..slam import System, SystemConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", type=str, default=None)
    ap.add_argument("--rgb-topic", type=str, default="camera/rgb")
    ap.add_argument("--depth-topic", type=str, default="camera/depth")
    ap.add_argument("--left-topic", type=str, default="camera/left")
    ap.add_argument("--right-topic", type=str, default="camera/right")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the System (cuda by default)")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args, _ = ap.parse_known_args(argv)
    if args.settings:
        from ..slam.settings import Settings

        st = Settings.from_yaml(args.settings)
        cam, cfg = st.camera, st.config
    else:
        cam = cameras.pinhole(525.0, 525.0, 319.5, 239.5, width=640,
                              height=480, bf=40.0)
        cfg = SystemConfig()
    cfg.sensor = sensor
    if use_imu:
        cfg.use_imu = True
    return System(cam, cfg, device="cpu" if args.cpu else args.device), args


def main_rgbd(argv=None):
    """ros2 run equivalent of the reference's rgbd node."""
    system, args = _system_from_argv(argv, "rgbd")
    _make_node("plvs_tpu_torch_rgbd", lambda: (
        RgbdSlamBridge(system),
        [(args.rgb_topic, "on_rgb"), (args.depth_topic, "on_depth")]))


def main_stereo(argv=None):
    system, args = _system_from_argv(argv, "stereo")
    _make_node("plvs_tpu_torch_stereo", lambda: (
        StereoSlamBridge(system),
        [(args.left_topic, "on_left"), (args.right_topic, "on_right")]))


def main_mono(argv=None):
    system, args = _system_from_argv(argv, "mono")
    _make_node("plvs_tpu_torch_mono", lambda: (
        MonoSlamBridge(system), [(args.rgb_topic, "on_image")]))
