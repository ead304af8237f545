"""Optional ROS bindings (counterpart of plvs_tpu/ros/: the reference's
Examples/ROS2/PLVS rclcpp nodes and Examples_old/ROS ROS1 nodes). The
conversions and the topic-pairing bridges need no ROS and always import;
the node mains need a ROS environment."""

from . import conversions  # noqa: F401
from .nodes import (  # noqa: F401
    ApproxTimeSync,
    MonoSlamBridge,
    RgbdSlamBridge,
    StereoSlamBridge,
)
