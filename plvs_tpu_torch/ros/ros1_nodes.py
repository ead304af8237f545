"""ROS 1 SLAM nodes (optional; they need rospy at run time).

Counterpart of plvs_tpu/ros/ros1_nodes.py (the reference's ROS1 bindings,
Examples_old/ROS/PLVS/src/ros_{mono,mono_inertial,rgbd,stereo,
stereo_inertial}.cc). The pairing and conversion cores are the ROS 2
layer's bridges (``ros.nodes``); only the rospy wiring lives here,
imported inside ``_spin_node``. The inertial bridges hand each image the
IMU samples up to its stamp (``track_*(..., imu_samples=...)``). As in the
reference nodes (ros_rgbd.cc:236), the dense cloud is assembled and
published only while someone subscribes to it; it is read under the dense
mapper's lock.
"""

from __future__ import annotations

import numpy as np

from . import conversions as cv
from .nodes import (ApproxTimeSync, MonoSlamBridge, RgbdSlamBridge,
                    StereoSlamBridge, _system_from_argv)


class ImuQueue:
    """Accumulate IMU samples between frames and hand the batch preceding
    each image timestamp to Track* (reference: ros_stereo_inertial.cc
    GrabImu + SyncWithImu drain loop)."""

    def __init__(self):
        self.samples: list = []  # (t, gyro[3], acc[3])

    def push(self, t: float, gyro, acc):
        self.samples.append((t, np.asarray(gyro, np.float32),
                             np.asarray(acc, np.float32)))

    def drain_until(self, t_img: float):
        """Pop and return all samples with t <= t_img as a list of
        (t, gyro, acc) tuples (the Tracking::GrabImuData batch format), or
        None if empty."""
        take = [s for s in self.samples if s[0] <= t_img]
        self.samples = [s for s in self.samples if s[0] > t_img]
        return take or None


class InertialBridgeMixin:
    """Adds an IMU queue to an image bridge: images are tracked with the
    IMU batch since the previous frame."""

    def init_imu(self):
        self.imu = ImuQueue()

    def on_imu(self, t, gyro, acc):
        self.imu.push(t, gyro, acc)

    def imu_batch(self, t_img):
        return self.imu.drain_until(t_img)


class MonoInertialBridge(MonoSlamBridge, InertialBridgeMixin):
    """reference: ros_mono_inertial.cc"""

    def __init__(self, system):
        super().__init__(system)
        self.init_imu()

    def on_image(self, msg):
        ts = cv.stamp_to_sec(msg.header.stamp)
        state, R, t = self.system.track_monocular(
            cv.image_to_gray(msg), ts, imu_samples=self.imu_batch(ts))
        pose = cv.pose_to_msg_dict(R, t)
        self.poses.append((ts, state, pose))
        return state, pose


class StereoInertialBridge(StereoSlamBridge, InertialBridgeMixin):
    """reference: ros_stereo_inertial.cc"""

    def __init__(self, system, max_dt: float = 0.005):
        super().__init__(system, max_dt=max_dt)
        self.init_imu()

    def _track(self, left_msg, right_msg):
        ts = cv.stamp_to_sec(left_msg.header.stamp)
        state, R, t = self.system.track_stereo(
            cv.image_to_gray(left_msg), cv.image_to_gray(right_msg), ts,
            imu_samples=self.imu_batch(ts))
        pose = cv.pose_to_msg_dict(R, t)
        self.poses.append((ts, state, pose))
        return state, pose


def _spin_node(node_name: str, bridge, image_topics, imu_topic=None,
               cloud_source=None):
    """Wire a bridge into rospy subscriptions and spin. Requires rospy +
    sensor_msgs (ROS1). image_topics: [(topic, bridge_callback_name)]."""
    import rospy
    from geometry_msgs.msg import PoseStamped
    from sensor_msgs.msg import Image, Imu, PointCloud2

    rospy.init_node(node_name)
    pose_pub = rospy.Publisher("slam/pose", PoseStamped, queue_size=10)
    cloud_pub = (rospy.Publisher("slam/cloud", PointCloud2, queue_size=2)
                 if cloud_source is not None else None)

    def publish(msg, out):
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
        pose_pub.publish(ps)
        # dense cloud only when subscribed (reference: ros_rgbd.cc:236)
        if cloud_pub is not None and cloud_pub.get_num_connections() > 0:
            pts, cols = cloud_source()
            if len(pts):
                cloud_pub.publish(
                    cv.cloud_to_msg(pts, cols, frame_id="map",
                                    stamp=msg.header.stamp))

    for topic, cb_name in image_topics:
        cb = getattr(bridge, cb_name)
        rospy.Subscriber(topic, Image,
                         lambda msg, cb=cb: publish(msg, cb(msg)),
                         queue_size=5, buff_size=2 ** 24)
    if imu_topic is not None:
        def imu_cb(m):
            bridge.on_imu(
                cv.stamp_to_sec(m.header.stamp),
                (m.angular_velocity.x, m.angular_velocity.y,
                 m.angular_velocity.z),
                (m.linear_acceleration.x, m.linear_acceleration.y,
                 m.linear_acceleration.z))
        rospy.Subscriber(imu_topic, Imu, imu_cb, queue_size=200)
    rospy.spin()


def _cloud_source(system):
    mapper = getattr(system, "dense_mapper", None)
    if mapper is None:
        return None
    def cloud():
        with mapper.lock:
            return mapper.volume.occupied_cloud()

    return cloud


def main_rgbd(argv=None):
    """rosrun equivalent of the reference's ros_rgbd node."""
    system, args = _system_from_argv(argv, "rgbd")
    bridge = RgbdSlamBridge(system)
    _spin_node("plvs_tpu_torch_rgbd", bridge,
               [(args.rgb_topic, "on_rgb"), (args.depth_topic, "on_depth")],
               cloud_source=_cloud_source(system))


def main_stereo(argv=None):
    system, args = _system_from_argv(argv, "stereo")
    bridge = StereoSlamBridge(system)
    _spin_node("plvs_tpu_torch_stereo", bridge,
               [(args.left_topic, "on_left"), (args.right_topic, "on_right")])


def main_mono(argv=None):
    system, args = _system_from_argv(argv, "mono")
    _spin_node("plvs_tpu_torch_mono", MonoSlamBridge(system),
               [(args.rgb_topic, "on_image")])


def main_mono_inertial(argv=None):
    system, args = _system_from_argv(argv, "mono", use_imu=True)
    _spin_node("plvs_tpu_torch_mono_inertial", MonoInertialBridge(system),
               [(args.rgb_topic, "on_image")], imu_topic="imu")


def main_stereo_inertial(argv=None):
    system, args = _system_from_argv(argv, "stereo", use_imu=True)
    _spin_node("plvs_tpu_torch_stereo_inertial", StereoInertialBridge(system),
               [(args.left_topic, "on_left"), (args.right_topic, "on_right")],
               imu_topic="imu")
