"""The port's YAML settings against the JAX package's: tests/test_io.py's
TestSettings, TestSettingsParityKeys and TestShippedPresets cases, each
file parsed by both packages to equal fields (cameras, SystemConfig, IMU
calibration, extrinsics, SparseMapping flags). All comparisons are exact:
both parsers read the same text into the same Python values."""

import dataclasses
import glob
import os

import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.slam import settings as jset
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.slam import System, SystemConfig
from plvs_tpu_torch.slam import settings as tset

ROOT = os.path.join(os.path.dirname(__file__), "..")
PRESETS = sorted(glob.glob(os.path.join(ROOT, "Settings", "*.yaml")))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cam_fields(cam):
    return (cam.kind, tuple(float(p) for p in cam.params), cam.width,
            cam.height, float(cam.bf))


def _value(v):
    """A comparable form of a Settings field."""
    if v is None or isinstance(v, (bool, int, float, str, dict)):
        return v
    if isinstance(v, np.ndarray):
        return (v.dtype.str, v.shape, v.tobytes())
    if hasattr(v, "params"):                 # a camera
        return _cam_fields(v)
    if hasattr(v, "_asdict"):                # ImuCalib
        return tuple(v._asdict().items())
    return dataclasses.asdict(v)             # SystemConfig


def _assert_same_settings(js, ts):
    names = [f.name for f in dataclasses.fields(jset.Settings)]
    assert names == [f.name for f in dataclasses.fields(tset.Settings)]
    for name in names:
        assert _value(getattr(ts, name)) == _value(getattr(js, name)), name
    assert type(ts.camera) is tcam.Camera
    assert type(ts.config) is SystemConfig


def _both(path):
    return jset.Settings.from_yaml(path), tset.Settings.from_yaml(path)


def test_reference_style_yaml(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("""%YAML:1.0
# reference-style settings file
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: 520.9
Camera1.fy: 521.0
Camera1.cx: 325.1
Camera1.cy: 249.7
Camera1.k1: 0.2624
Camera1.k2: -0.9531
Camera.width: 640
Camera.height: 480
Camera.fps: 30
Camera.bf: 40.0
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
Line.on: 1
Line.nLineFeatures: 100
PointCloudMapping.on: 1
PointCloudMapping.resolution: 0.03
RGBD.DepthMapFactor: 5000.0
""")
    js, st = _both(str(p))
    _assert_same_settings(js, st)
    assert st.camera.kind == tcam.PINHOLE
    assert abs(st.camera.fx - 520.9) < 1e-6 and st.camera.bf == 40.0
    assert st.config.num_features == 1000 and st.config.use_lines
    assert st.config.max_lines == 100 and st.config.dense_mapping
    assert abs(st.config.dense_voxel_size - 0.03) < 1e-9
    assert st.depth_map_factor == 5000.0 and st.fps == 30
    assert tset.load_yaml_flat(str(p)) == jset.load_yaml_flat(str(p))


def test_sparse_mapping_keys(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text("""%YAML:1.0
Camera.fx: 500.0
SparseMapping.filename: "m.atlas"
SparseMapping.reuseMap: 1
SparseMapping.freezeMap: 1
SparseMapping.saveMap: 1
SparseMapping.forceRelocalization: 0
""")
    js, st = _both(str(p))
    _assert_same_settings(js, st)
    assert st.map_filename == "m.atlas"
    assert st.reuse_map and st.freeze_map and st.save_map
    assert not st.force_relocalization
    d = {"Camera.fx": 500.0}
    st2 = tset.Settings.from_dict(d)
    _assert_same_settings(jset.Settings.from_dict(d), st2)
    assert not (st2.reuse_map or st2.freeze_map or st2.save_map)
    assert st2.force_relocalization


def test_fisheye_and_rig_yaml(tmp_path):
    p = tmp_path / "fe.yaml"
    p.write_text("""Camera.type: "KannalaBrandt8"
Camera1.fx: 190.9
Camera1.fy: 190.9
Camera1.cx: 254.9
Camera1.cy: 256.8
Camera1.k1: 0.0034
Camera2.fx: 190.4
Camera2.k2: -0.002
Camera.width: 512
Camera.height: 512
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [1.0, 0.0, 0.0, 0.101,
         0.0, 1.0, 0.0, 0.0,
         0.0, 0.0, 1.0, 0.0,
         0.0, 0.0, 0.0, 1.0]
""")
    js, st = _both(str(p))
    _assert_same_settings(js, st)
    assert st.camera.kind == tcam.KANNALA_BRANDT8
    assert st.camera2.kind == tcam.KANNALA_BRANDT8
    assert st.T_c1_c2.dtype == np.float32 and st.T_c1_c2[0, 3] == \
        np.float32(0.101)


def test_new_keys_parsed(tmp_path):
    y = tmp_path / "s.yaml"
    y.write_text("""%YAML:1.0
Camera.fx: 250.0
Camera.fy: 250.0
Camera.cx: 160.0
Camera.cy: 120.0
Camera.width: 320
Camera.height: 240
Camera.imageScale: 0.5
KeyFrame.fovCentersBasedGeneration.on: 1
KeyFrame.maxFovCentersDistance: 0.3
Depth.sigmaZfactor: 9.0
System.asyncMapping: on
""")
    js, s = _both(str(y))
    _assert_same_settings(js, s)
    assert s.config.image_scale == 0.5 and s.config.fov_centers_kf is True
    assert s.config.max_fov_centers_distance == 0.3
    assert s.sigma_z_factor == 9.0 and s.config.async_mapping


def test_imu_extrinsic_parsed_and_wired():
    preset = os.path.join(ROOT, "Settings", "RGBD-Inertial-D435i.yaml")
    js, s = _both(preset)
    _assert_same_settings(js, s)
    assert s.imu is not None and s.imu_insert_kfs_when_lost is False
    T = s.imu_T_b_c
    assert T is not None and T.shape == (4, 4)
    np.testing.assert_allclose(T[:3, :3] @ T[:3, :3].T, np.eye(3), atol=1e-4)
    sys_ = System(s.camera, SystemConfig(use_imu=True, max_kf=8,
                                         max_pts=1024),
                  device="cpu", imu_calib=s.imu, imu_T_b_c=T)
    rt = sys_.inertial
    np.testing.assert_allclose(rt.R_cb, T[:3, :3].T, atol=1e-6)
    np.testing.assert_allclose(rt.t_cb, -T[:3, :3].T @ T[:3, 3], atol=1e-6)
    assert rt.calib.gyro_noise == pytest.approx(1e-2)


def test_camera_scaling_helper():
    for mod in (jcam, tcam):
        cam = mod.pinhole(300.0, 300.0, 160.0, 120.0, width=320,
                          height=240, bf=24.0)
        half = mod.scale_camera(cam, 0.5)
        assert half.width == 160 and half.height == 120
        assert half.fx == 150.0 and half.bf == 12.0


def test_a_setting_outside_the_port_parses_and_raises_at_the_system(tmp_path):
    """A file with ``System.shardedBackend: 1`` parses to equal settings in
    both packages (neither parser maps that key), and with
    ``sharded_backend`` set the parsed settings build a System: on the CPU
    with no mesh, as the JAX package's on one device."""
    p = tmp_path / "s.yaml"
    p.write_text("Camera.fx: 300.0\nSystem.shardedBackend: 1\n")
    js, s = _both(str(p))
    _assert_same_settings(js, s)
    s.config.sharded_backend = True
    system = System(s.camera, s.config, device="cpu")
    assert system.config.sharded_backend and system.mesh is None


def test_thirteen_presets_ship():
    assert len(PRESETS) == 13


@pytest.mark.parametrize("path", PRESETS, ids=os.path.basename)
def test_shipped_preset_parses_to_equal_fields(path):
    js, st = _both(path)
    _assert_same_settings(js, st)
    assert st.camera.width > 0 and st.fps > 0
    if "TUM-VI" in path:
        assert st.camera.kind == tcam.KANNALA_BRANDT8
        assert st.imu is not None
    if "Inertial" in path:
        assert st.imu is not None and st.imu.gyro_noise > 0
    if "KITTI" in path:
        assert st.camera.bf > 100
