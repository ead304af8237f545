"""YAML settings: PLVS / ORB-SLAM3 keys -> Camera + SystemConfig.

Counterpart of plvs_tpu/slam/settings.py, built on the port's cameras,
``SystemConfig`` and ``ImuCalib``. It reads the reference's key names
(Camera1.fx / Camera.fx, ORBextractor.*, Line.*, PointCloudMapping.*,
SparseMapping.*, IMU.*, Stereo.T_c1_c2) from flat OpenCV FileStorage YAML
("%YAML:1.0" and tagged values are normalized first); other keys are kept
in ``raw`` and ignored. A setting the port does not run still parses: it
raises where the System is built, never here.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any

import numpy as np

from ..geometry import cameras as cam_mod
from ..imu.preintegration import ImuCalib
from .system import SystemConfig


def _parse_scalar(v: str) -> Any:
    v = v.strip().strip('"')
    if re.fullmatch(r"-?\d+", v):
        return int(v)
    try:
        return float(v)
    except ValueError:
        pass
    if v.lower() in ("true", "on", "yes"):
        return True
    if v.lower() in ("false", "off", "no"):
        return False
    return v


def load_yaml_flat(path: str) -> dict:
    """Minimal flat 'Key.Sub: value' YAML reader for OpenCV FileStorage
    documents (nested blocks become dotted keys; no yaml dependency)."""
    out: dict[str, Any] = {}
    stack: list[tuple[int, str]] = []
    with open(path) as f:
        raw_lines = f.readlines()
    # merge multi-line bracketed lists (cv matrices split `data:` across
    # lines)
    merged: list[str] = []
    buf: str | None = None
    for raw in raw_lines:
        s = raw.split("#", 1)[0].rstrip()
        if buf is not None:
            buf += " " + s.strip()
            if "]" in s:
                merged.append(buf)
                buf = None
            continue
        if "[" in s and "]" not in s:
            buf = s
            continue
        merged.append(s)
    if buf is not None:
        merged.append(buf)
    for line in merged:
        if not line or line.startswith("%YAML") or line.strip() == "---":
            continue
        m = re.match(r"(\s*)([A-Za-z0-9_.]+)\s*:\s*(.*)$", line)
        if not m:
            continue
        indent, key, val = len(m.group(1)), m.group(2), m.group(3)
        while stack and stack[-1][0] >= indent:
            stack.pop()
        full = ".".join([s[1] for s in stack] + [key])
        val = re.sub(r"!![a-zA-Z-]+", "", val).strip()
        if val in ("", "|", ">"):
            stack.append((indent, key))
            continue
        if val.startswith("["):
            items = [x for x in re.split(r"[\[\],]", val) if x.strip()]
            out[full] = [_parse_scalar(x) for x in items]
        else:
            out[full] = _parse_scalar(val)
    return out


def _get(d: dict, *names, default=None):
    for n in names:
        if n in d:
            return d[n]
    return default


@dataclasses.dataclass
class Settings:
    camera: cam_mod.Camera
    config: SystemConfig
    fps: float = 30.0
    depth_map_factor: float = 1.0
    th_depth: float = 40.0
    # reference: Depth.sigmaZfactor — depth-noise multiplier feeding the
    # sigma_Z model (utils.depth_model)
    sigma_z_factor: float = 6.0
    # reference: Settings::readIMU (IMU.NoiseGyro/NoiseAcc/GyroWalk/AccWalk)
    imu: Any = None               # ImuCalib when IMU.* keys are present
    imu_frequency: float = 200.0
    # reference: IMU.T_b_c1 / legacy Tbc — camera pose in the body (IMU)
    # frame, X_b = T X_c (Settings::readIMU, src/Settings.cc)
    imu_T_b_c: Any = None
    # reference: IMU.InsertKFsWhenLost (include/Tracking.h mInsertKFsLost)
    imu_insert_kfs_when_lost: bool = True
    # reference: Settings::readCamera2 + Stereo.T_c1_c2 for non-rectified
    # stereo rigs (src/Settings.cc:325,404-409) — camera2 is the right
    # camera, T_c1_c2 the 4x4 right-to-left transform
    camera2: Any = None
    T_c1_c2: Any = None
    # reference: SparseMapping.* atlas-reuse flow (src/System.cc:201-205,
    # Settings/old/RGB-D-TUM1.yaml:137-145)
    map_filename: str = ""
    reuse_map: bool = False
    freeze_map: bool = False
    save_map: bool = False
    force_relocalization: bool = True
    raw: dict | None = None

    @staticmethod
    def from_yaml(path: str) -> "Settings":
        d = load_yaml_flat(path)
        return Settings.from_dict(d)

    @staticmethod
    def from_dict(d: dict) -> "Settings":
        # -- camera (reference: Settings::readCamera1 / legacy Camera.*) ----
        fx = _get(d, "Camera1.fx", "Camera.fx", default=500.0)
        fy = _get(d, "Camera1.fy", "Camera.fy", default=fx)
        cx = _get(d, "Camera1.cx", "Camera.cx", default=320.0)
        cy = _get(d, "Camera1.cy", "Camera.cy", default=240.0)
        width = int(_get(d, "Camera.width", "Camera1.width", default=640))
        height = int(_get(d, "Camera.height", "Camera1.height", default=480))
        bf = float(_get(d, "Camera.bf", "Camera1.bf", default=0.0))
        cam_type = str(_get(d, "Camera.type", "Camera1.type", default="PinHole"))
        if cam_type.lower() in ("kannalabrandt8", "fisheye"):
            cam = cam_mod.kannala_brandt8(
                fx, fy, cx, cy,
                _get(d, "Camera1.k1", "Camera.k1", default=0.0),
                _get(d, "Camera1.k2", "Camera.k2", default=0.0),
                _get(d, "Camera1.k3", "Camera.k3", default=0.0),
                _get(d, "Camera1.k4", "Camera.k4", default=0.0),
                width=width, height=height, bf=bf,
            )
        else:
            dist = [
                _get(d, "Camera1.k1", "Camera.k1", default=0.0),
                _get(d, "Camera1.k2", "Camera.k2", default=0.0),
                _get(d, "Camera1.p1", "Camera.p1", default=0.0),
                _get(d, "Camera1.p2", "Camera.p2", default=0.0),
                _get(d, "Camera1.k3", "Camera.k3", default=0.0),
            ]
            cam = cam_mod.pinhole(fx, fy, cx, cy, dist, width=width,
                                  height=height, bf=bf)

        # -- second camera of a non-rectified rig ---------------------------
        cam2 = None
        T12 = None
        if any(k.startswith("Camera2.") for k in d):
            fx2 = float(_get(d, "Camera2.fx", default=fx))
            fy2 = float(_get(d, "Camera2.fy", default=fx2))
            cx2 = float(_get(d, "Camera2.cx", default=cx))
            cy2 = float(_get(d, "Camera2.cy", default=cy))
            if cam_type.lower() in ("kannalabrandt8", "fisheye"):
                cam2 = cam_mod.kannala_brandt8(
                    fx2, fy2, cx2, cy2,
                    _get(d, "Camera2.k1", default=0.0),
                    _get(d, "Camera2.k2", default=0.0),
                    _get(d, "Camera2.k3", default=0.0),
                    _get(d, "Camera2.k4", default=0.0),
                    width=width, height=height, bf=bf,
                )
            else:
                dist2 = [
                    _get(d, "Camera2.k1", default=0.0),
                    _get(d, "Camera2.k2", default=0.0),
                    _get(d, "Camera2.p1", default=0.0),
                    _get(d, "Camera2.p2", default=0.0),
                    _get(d, "Camera2.k3", default=0.0),
                ]
                cam2 = cam_mod.pinhole(fx2, fy2, cx2, cy2, dist2,
                                       width=width, height=height, bf=bf)
            tdata = _get(d, "Stereo.T_c1_c2.data", "Stereo.T_c1_c2",
                         default=None)
            if tdata is not None and len(tdata) in (12, 16):
                T12 = np.eye(4, dtype=np.float32)
                T12[: len(tdata) // 4] = np.asarray(
                    tdata, np.float32).reshape(-1, 4)

        # -- pipeline config ------------------------------------------------
        cfg = SystemConfig(
            num_features=int(_get(d, "ORBextractor.nFeatures", default=1024)),
            n_levels=int(_get(d, "ORBextractor.nLevels", default=8)),
            scale=float(_get(d, "ORBextractor.scaleFactor", default=1.2)),
            use_lines=bool(_get(d, "Line.on", default=False)),
            max_lines=int(_get(d, "Line.nLineFeatures", default=128)),
            dense_mapping=bool(_get(d, "PointCloudMapping.on", default=False)),
            dense_voxel_size=float(
                _get(d, "PointCloudMapping.resolution", default=0.02)),
            dense_segmentation=bool(_get(d, "Segmentation.on", default=False)),
            loop_closing=bool(_get(d, "LoopClosing.on", default=True)),
            image_scale=float(_get(d, "Camera.imageScale", default=1.0)),
            fov_centers_kf=bool(_get(
                d, "KeyFrame.fovCentersBasedGeneration.on", default=False)),
            max_fov_centers_distance=float(_get(
                d, "KeyFrame.maxFovCentersDistance", default=0.4)),
            vocabulary_path=_get(d, "Vocabulary.path", default=None),
            # async mapper actor (reference: the always-on thread fabric;
            # here opt-in for deterministic offline runs)
            async_mapping=bool(_get(d, "System.asyncMapping",
                                    default=False)),
        )
        imu = None
        imu_T_b_c = None
        if any(k.startswith("IMU.") for k in d):
            imu = ImuCalib(
                gyro_noise=float(_get(d, "IMU.NoiseGyro", default=1.7e-4)),
                acc_noise=float(_get(d, "IMU.NoiseAcc", default=2.0e-3)),
                gyro_walk=float(_get(d, "IMU.GyroWalk", default=1.9e-5)),
                acc_walk=float(_get(d, "IMU.AccWalk", default=3.0e-3)),
            )
            tbc = _get(d, "IMU.T_b_c1.data", "IMU.T_b_c1", "Tbc.data", "Tbc",
                       default=None)
            if tbc is not None and len(tbc) in (12, 16):
                imu_T_b_c = np.eye(4, dtype=np.float32)
                imu_T_b_c[: len(tbc) // 4] = np.asarray(
                    tbc, np.float32).reshape(-1, 4)
        return Settings(
            camera=cam,
            config=cfg,
            imu=imu,
            imu_frequency=float(_get(d, "IMU.Frequency", default=200.0)),
            imu_T_b_c=imu_T_b_c,
            imu_insert_kfs_when_lost=bool(_get(
                d, "IMU.InsertKFsWhenLost", default=True)),
            fps=float(_get(d, "Camera.fps", default=30.0)),
            depth_map_factor=float(_get(d, "DepthMapFactor",
                                        "RGBD.DepthMapFactor", default=1.0)),
            th_depth=float(_get(d, "ThDepth", "Stereo.ThDepth",
                                "RGBD.ThDepth", default=40.0)),
            sigma_z_factor=float(_get(d, "Depth.sigmaZfactor", default=6.0)),
            camera2=cam2,
            T_c1_c2=T12,
            map_filename=str(_get(d, "SparseMapping.filename", default="")),
            reuse_map=bool(_get(d, "SparseMapping.reuseMap", default=False)),
            freeze_map=bool(_get(d, "SparseMapping.freezeMap",
                                 default=False)),
            save_map=bool(_get(d, "SparseMapping.saveMap", default=False)),
            force_relocalization=bool(_get(
                d, "SparseMapping.forceRelocalization", default=True)),
            raw=d,
        )
