"""The JAX package's figures for the viewer, AR, ROS-bridge and demo phase of
the port's chip smoke (``chip_smoke.py`` phase 16).

Parts (``--part``, default ``all``, each one JSON line):

* ``ar``: ``plvs_tpu.demo_ar.main(["--synthetic", "--frames", N, ...])``:
  the frame at which the plane locks, its inliers and origin, and the
  frames composited;
* ``inseg``: ``plvs_tpu.demo_inseg.main`` the same way: frames tracked,
  surface voxels, segments and their sizes;
* ``bridge``: the ROS bridges on fake messages of frames 0-19 of phase 2's
  sweep (bench.py's structured wall at 640x480, the sweep in 40 frames) as
  mono8 images and 16UC1 depth in millimetres: ``RgbdSlamBridge`` with
  phase 2's flags (states, ATE) and ``MonoSlamBridge`` on a fresh System
  with phase 13's monocular flags without loop closing (states);
* ``plane``: phase 2's 40-frame run, then ``viz.ar.detect_plane`` on its
  live map points: the normal, its angle to the wall's normal, d, and the
  inliers and their share.

    JAX_PLATFORMS=cpu python scripts/reference_demos.py [--part ar|inseg|bridge|plane|all]
        [--ar-frames 60] [--inseg-frames 40]

On an 8-core x86 CPU (jax 0.9.0) the parts took about 45, 50, 150 and
230 s; several run side by side.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import re
import sys
import tempfile
import time

import numpy as np

N_SWEEP = 40          # phase 2's sweep
N_BRIDGE = 20         # the bridges' frames 0-19 of it


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
    header: Header


def _stamp(ts: float) -> Stamp:
    ns = int(round(ts * 1e9))
    return Stamp(ns // 10 ** 9, ns % 10 ** 9)


def mono8_msg(gray: np.ndarray, ts: float) -> Image:
    """A camera's mono8 image of a float render (rounded to u8)."""
    h, w = gray.shape
    u8 = np.clip(np.round(gray), 0, 255).astype(np.uint8)
    return Image(h, w, "mono8", w, u8.tobytes(), Header(_stamp(ts)))


def depth16_msg(depth: np.ndarray, ts: float) -> Image:
    """A depth camera's 16UC1 image in millimetres (rounded)."""
    h, w = depth.shape
    mm = np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16)
    return Image(h, w, "16UC1", 2 * w, mm.tobytes(), Header(_stamp(ts)))


def _bench_cam(cameras):
    return cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640,
                           height=480, bf=40.0)


def _sweep(cam, synthetic):
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=420.0)
    return list(scene.sequence(n_frames=N_SWEEP))


def _phase2_config(SystemConfig):
    return SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                        max_pts=65536, use_lines=True, max_lines=160,
                        local_ba=False, loop_closing=False,
                        dense_mapping=False, pipelined=False,
                        depth_upload_decimation=2)


def _mono_config(SystemConfig):
    return SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=64,
                        max_pts=16384, sensor="mono", max_kf_interval=5,
                        min_kf_inliers=25, local_ba=True, loop_closing=False,
                        pipelined=False)


def part_ar(frames: int) -> dict:
    from plvs_tpu import demo_ar

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(buf):
        demo_ar.main(["--synthetic", "--frames", str(frames), "--out", tmp,
                      "--cpu"])
    text = buf.getvalue()
    m = re.search(r"plane locked at frame (\d+): origin=\[([^\]]*)\], "
                  r"inliers=(\d+)", text)
    n = re.search(r"AR demo: (\d+) composited", text)
    return {"frames": frames,
            "lock_frame": int(m.group(1)) if m else None,
            "origin": [float(x) for x in m.group(2).split()] if m else None,
            "inliers": int(m.group(3)) if m else None,
            "composited": int(n.group(1)), "stdout": text}


def part_inseg(frames: int) -> dict:
    from plvs_tpu import demo_inseg

    buf = io.StringIO()
    with tempfile.TemporaryDirectory() as tmp, \
            contextlib.redirect_stdout(buf):
        demo_inseg.main(["--synthetic", "--frames", str(frames), "--out",
                         tmp, "--cpu"])
    text = buf.getvalue()
    m = re.search(r"(\d+) frames tracked, (\d+) surface voxels, (\d+) "
                  r"segments", text)
    sizes = [int(c) for c in re.findall(r"segment \d+: (\d+) voxels", text)]
    return {"frames": frames, "tracked": int(m.group(1)),
            "surface_voxels": int(m.group(2)), "segments": int(m.group(3)),
            "segment_sizes": sizes, "stdout": text}


def part_bridge() -> dict:
    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import evaluation, synthetic
    from plvs_tpu.ros.nodes import MonoSlamBridge, RgbdSlamBridge
    from plvs_tpu.slam import System, SystemConfig

    cam = _bench_cam(cameras)
    frames = _sweep(cam, synthetic)[:N_BRIDGE]
    rgbd = RgbdSlamBridge(System(cam, _phase2_config(SystemConfig)))
    for ts, g, d, _, _ in frames:
        rgbd.on_rgb(mono8_msg(g, ts))
        rgbd.on_depth(depth16_msg(d, ts))
    est = np.stack([[p["position"][k] for k in "xyz"]
                    for _, _, p in rgbd.poses])
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    mono = MonoSlamBridge(System(cam, _mono_config(SystemConfig)))
    for ts, g, _, _, _ in frames:
        mono.on_image(mono8_msg(g, ts))
    return {"frames": N_BRIDGE,
            "rgbd_states": [int(s) for _, s, _ in rgbd.poses],
            "rgbd_ate_m": float(evaluation.ate_rmse(est, gt, align=True)),
            "mono_states": [int(s) for _, s, _ in mono.poses]}


def part_plane() -> dict:
    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import synthetic
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.viz import ar

    cam = _bench_cam(cameras)
    system = System(cam, _phase2_config(SystemConfig))
    for ts, g, d, _, _ in _sweep(cam, synthetic):
        system.track_rgbd(g, d, ts)
    st = system.store
    pts = st.pt_xyz[st.pt_mask]
    plane = ar.detect_plane(pts)
    cos = abs(float(plane.normal[2])) / float(np.linalg.norm(plane.normal))
    return {"points": int(len(pts)), "normal": plane.normal.tolist(),
            "d": plane.d, "angle_deg": float(np.degrees(np.arccos(
                min(cos, 1.0)))),
            "inliers": plane.n_inliers,
            "inlier_share": plane.n_inliers / len(pts),
            "origin": plane.origin.tolist()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", default="all",
                    choices=["ar", "inseg", "bridge", "plane", "all"])
    ap.add_argument("--ar-frames", type=int, default=60)
    ap.add_argument("--inseg-frames", type=int, default=40)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    parts = {"ar": lambda: part_ar(args.ar_frames),
             "inseg": lambda: part_inseg(args.inseg_frames),
             "bridge": part_bridge, "plane": part_plane}
    for name in (parts if args.part == "all" else [args.part]):
        t0 = time.perf_counter()
        out = parts[name]()
        print(json.dumps({"part": name, "device": "cpu (jax "
                          + jax.__version__ + ")", **out,
                          "wall_s": time.perf_counter() - t0}))


if __name__ == "__main__":
    main()
