"""ROS message <-> numpy conversions (no rclpy dependency).

Counterpart of plvs_tpu/ros/conversions.py (the reference's cv_bridge use
in its ROS nodes, Examples_old/ROS/PLVS/src/ros_rgbd.cc:364-465). Pure
functions over duck-typed message objects, so they are tested without a
ROS installation. ``pose_to_msg_dict`` turns the 3x3 into a quaternion on
the host with the port's ``geometry.lie.rotmat_to_quat``: message packing,
not a device stage.
"""

from __future__ import annotations

import numpy as np
import torch

from ..geometry import cameras, lie


def stamp_to_sec(stamp) -> float:
    """builtin_interfaces/Time (sec, nanosec) -> float seconds."""
    return float(stamp.sec) + float(stamp.nanosec) * 1e-9


def image_to_gray(msg) -> np.ndarray:
    """sensor_msgs/Image -> float32 grayscale [H, W].

    Supports mono8, mono16, rgb8, bgr8, rgba8, bgra8 (the encodings the
    reference nodes accept through cv_bridge).
    """
    h, w = int(msg.height), int(msg.width)
    enc = msg.encoding.lower()
    buf = np.frombuffer(bytes(msg.data), np.uint8)
    if enc == "mono8":
        img = buf.reshape(h, msg.step)[:, :w].astype(np.float32)
    elif enc == "mono16":
        img = buf.view(np.uint16).reshape(h, msg.step // 2)[:, :w]
        img = (img.astype(np.float32) / 257.0)
    elif enc in ("rgb8", "bgr8", "rgba8", "bgra8"):
        c = 4 if enc.endswith("a8") else 3
        img = buf.reshape(h, msg.step)[:, : w * c].reshape(h, w, c)
        if enc.startswith("bgr"):
            r, g, b = img[..., 2], img[..., 1], img[..., 0]
        else:
            r, g, b = img[..., 0], img[..., 1], img[..., 2]
        img = (0.299 * r + 0.587 * g + 0.114 * b).astype(np.float32)
    else:
        raise ValueError(f"unsupported image encoding: {msg.encoding}")
    return img


def image_to_depth(msg, depth_scale: float = 1.0) -> np.ndarray:
    """sensor_msgs/Image depth -> float32 metres [H, W] (<=0 invalid).

    16UC1 is interpreted as millimetres (the common RealSense/Kinect
    convention the reference's RGB-D yaml DepthMapFactor handles); 32FC1 as
    metres. NaNs map to 0 (invalid).
    """
    h, w = int(msg.height), int(msg.width)
    enc = msg.encoding.lower()
    buf = np.frombuffer(bytes(msg.data), np.uint8)
    if enc in ("16uc1", "mono16"):
        d = buf.view(np.uint16).reshape(h, msg.step // 2)[:, :w]
        depth = d.astype(np.float32) / 1000.0
    elif enc == "32fc1":
        d = buf.view(np.float32).reshape(h, msg.step // 4)[:, :w]
        depth = np.nan_to_num(d, nan=0.0, posinf=0.0, neginf=0.0)
    else:
        raise ValueError(f"unsupported depth encoding: {msg.encoding}")
    return depth * depth_scale


def camera_from_info(msg, bf: float = 0.0):
    """sensor_msgs/CameraInfo -> Camera (reference: the ROS nodes'
    camera-info driven calibration)."""
    k = np.asarray(msg.k, np.float64).reshape(3, 3)
    d = list(msg.d) + [0.0] * max(0, 5 - len(msg.d))
    model = (msg.distortion_model or "").lower()
    if "equidistant" in model or "kannala" in model:
        return cameras.kannala_brandt8(
            k[0, 0], k[1, 1], k[0, 2], k[1, 2], *d[:4],
            width=int(msg.width), height=int(msg.height), bf=bf)
    return cameras.pinhole(k[0, 0], k[1, 1], k[0, 2], k[1, 2], d[:5],
                           width=int(msg.width), height=int(msg.height), bf=bf)


def pose_to_msg_dict(R_cw: np.ndarray, t_cw: np.ndarray) -> dict:
    """Camera pose (world->cam) -> dict with camera-in-world position +
    quaternion (x, y, z, w) — the payload of the PoseStamped the nodes
    publish. Returned as a plain dict so it is testable without ROS."""
    Rwc = np.asarray(R_cw).T
    twc = -Rwc @ np.asarray(t_cw)
    q = lie.rotmat_to_quat(torch.from_numpy(
        np.ascontiguousarray(Rwc, np.float32))).numpy()  # (w, x, y, z)
    return {
        "position": {"x": float(twc[0]), "y": float(twc[1]),
                     "z": float(twc[2])},
        "orientation": {"x": float(q[1]), "y": float(q[2]),
                        "z": float(q[3]), "w": float(q[0])},
    }


def cloud_to_xyz_rgb_bytes(pts: np.ndarray, cols: np.ndarray) -> bytes:
    """Pack points+colors as the PointCloud2 xyzrgb layout (float32 x,y,z +
    packed float rgb; the format the reference's ros_rgbd node publishes
    when subscribed, ros_rgbd.cc:236)."""
    n = len(pts)
    out = np.zeros((n, 4), np.float32)
    out[:, :3] = pts
    rgb = (cols[:, 0].astype(np.uint32) << 16) | \
        (cols[:, 1].astype(np.uint32) << 8) | cols[:, 2].astype(np.uint32)
    out[:, 3] = rgb.view(np.float32)
    return out.tobytes()


def cloud_to_msg(pts: np.ndarray, cols: np.ndarray, frame_id: str = "map",
                 stamp=None):
    """Build a sensor_msgs/PointCloud2 (ROS1 or ROS2 — same field API) from
    points + uint8 colors. Lazy-imports sensor_msgs; only call from a ROS
    environment."""
    from sensor_msgs.msg import PointCloud2, PointField

    msg = PointCloud2()
    msg.header.frame_id = frame_id
    if stamp is not None:
        msg.header.stamp = stamp
    msg.height = 1
    msg.width = len(pts)
    msg.fields = [
        PointField(name=n, offset=o, datatype=PointField.FLOAT32, count=1)
        for n, o in (("x", 0), ("y", 4), ("z", 8), ("rgb", 12))
    ]
    msg.is_bigendian = False
    msg.point_step = 16
    msg.row_step = 16 * len(pts)
    msg.is_dense = True
    msg.data = cloud_to_xyz_rgb_bytes(pts, np.asarray(cols, np.uint8))
    return msg
