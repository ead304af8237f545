"""Command-line runner: SLAM on a dataset or the synthetic sequence.

Counterpart of plvs_tpu/run_slam.py with the same options. The System runs
on ``--device`` (``cuda`` by default; ``--cpu`` is ``--device cpu``). It
never falls back to the CPU: without CUDA the default raises.

    python -m plvs_tpu_torch.run_slam --synthetic [--frames 60] [--out traj.txt]
    python -m plvs_tpu_torch.run_slam --tum /path/to/rgbd_dataset --settings cfg.yaml
    python -m plvs_tpu_torch.run_slam --euroc /path/to/MH_01 --settings cfg.yaml
    python -m plvs_tpu_torch.run_slam --kitti /path/to/00 --settings cfg.yaml

A settings file's ``SparseMapping.*`` keys reuse a saved atlas
(``reuseMap``, ``freezeMap``, ``forceRelocalization``) and save the map at
the end (``saveMap``), as ``--save-map`` does. ``main`` ends the session
with ``System.shutdown``, which saves the maps.

``--live-viewer PORT`` serves the map to a browser while the run goes on
(``viz/live_server.py``; its pause verb holds the RGB-D feed), and
``--viz MAP_PNG`` renders the final map, with the dense cloud and the
settings' ``GlObjects`` overlays, to a PNG (nothing without matplotlib).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="plvs_tpu_torch SLAM runner")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--tum", type=str, default=None,
                    help="TUM RGB-D sequence dir (ICL-NUIM's TUM-compatible "
                         "download uses the same layout)")
    ap.add_argument("--euroc", type=str, default=None,
                    help="EuRoC mav0 dir (stereo); TUM-VI uses the same "
                         "layout")
    ap.add_argument("--kitti", type=str, default=None,
                    help="KITTI odometry sequence dir (stereo)")
    ap.add_argument("--inertial", action="store_true",
                    help="feed the dataset's IMU stream (EuRoC layout; needs "
                         "IMU.* keys in --settings)")
    ap.add_argument("--mono", action="store_true",
                    help="monocular mode: use only the left/rgb image")
    ap.add_argument("--localization", action="store_true",
                    help="localization-only mode (frozen map)")
    ap.add_argument("--settings", type=str, default=None)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", type=str, default="trajectory_tum.txt")
    ap.add_argument("--out-format", choices=["tum", "kitti", "euroc"],
                    default="tum")
    ap.add_argument("--save-map", type=str, default=None)
    ap.add_argument("--save-dense", type=str, default=None)
    ap.add_argument("--viz", type=str, default=None, metavar="MAP_PNG",
                    help="render the final map to a PNG")
    ap.add_argument("--dense", action="store_true")
    ap.add_argument("--lines", action="store_true")
    ap.add_argument("--async-mapping", action="store_true",
                    help="run local mapping, loop closing and dense mapping "
                         "on the mapper actor thread")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the System (cuda by default)")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--live-viewer", type=int, default=None, metavar="PORT",
                    help="serve a live map view on 127.0.0.1:PORT (0: any "
                         "free port)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from .geometry import cameras
    from .io import evaluation, synthetic, trajectory
    from .slam import System, SystemConfig
    from .utils.profiling import Stopwatch

    sw = Stopwatch()
    st = None
    if args.settings:
        from .slam.settings import Settings

        st = Settings.from_yaml(args.settings)
        cam, cfg = st.camera, st.config
    else:
        cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320,
                              height=240, bf=24.0)
        cfg = SystemConfig(num_features=512, n_levels=4)
    if args.dense:
        cfg.dense_mapping = True
    if args.lines:
        cfg.use_lines = True
    if args.async_mapping:
        cfg.async_mapping = True
    if args.mono:
        cfg.sensor = "mono"
    elif args.euroc or args.kitti:
        cfg.sensor = "stereo"
    if args.inertial:
        cfg.use_imu = True

    system = System(cam, cfg, device=device,
                    cam2=st.camera2 if st else None,
                    T_c1_c2=st.T_c1_c2 if st else None,
                    imu_calib=st.imu if st else None,
                    imu_T_b_c=st.imu_T_b_c if st else None)
    if st and st.reuse_map and st.map_filename and os.path.exists(
            st.map_filename):
        system.load_map(st.map_filename, freeze=st.freeze_map,
                        force_relocalization=st.force_relocalization)
        print(f"reusing sparse map {st.map_filename}")
    if args.localization:
        system.activate_localization_mode()

    viewer = None
    if args.live_viewer is not None:
        from .viz.live_server import LiveViewer

        viewer = LiveViewer(system, port=args.live_viewer)
        print(f"live viewer: http://127.0.0.1:{viewer.port}/")
        _orig_track = system.track_rgbd

        def _gated(*a, **kw):
            viewer.wait_if_paused()
            return _orig_track(*a, **kw)

        system.track_rgbd = _gated

    if args.synthetic:
        scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, seed=0)
        gt = []
        n = 0
        t0 = time.perf_counter()
        for ts, gray, depth, R_gt, t_gt in scene.sequence(n_frames=args.frames):
            with sw.scope("track"):
                system.track_rgbd(gray, depth, ts)
            gt.append(-R_gt.T @ t_gt)
            n += 1
        dt = time.perf_counter() - t0
        traj = system.trajectory_tum()
        rmse = evaluation.ate_rmse(traj[:, 1:4], np.stack(gt), align=True)
        print(json.dumps({
            "frames": n, "fps": round(n / dt, 2),
            "ate_rmse": round(float(rmse), 5),
            **system.map_statistics(),
        }))
    elif args.tum:
        from .io.datasets import TumRGBD

        ds = TumRGBD(args.tum)
        n = 0
        t0 = time.perf_counter()
        for ts, gray, depth in ds.frames():
            with sw.scope("track"):
                if args.mono:
                    system.track_monocular(gray, ts)
                else:
                    system.track_rgbd(gray, depth, ts)
            n += 1
        dt = time.perf_counter() - t0
        print(json.dumps({"frames": n, "fps": round(n / dt, 2),
                          **system.map_statistics()}))
    elif args.euroc or args.kitti:
        from .io.datasets import EurocStereo, KittiStereo

        ds = EurocStereo(args.euroc) if args.euroc else KittiStereo(args.kitti)
        imu_rows = None
        imu_pos = 0
        if args.inertial:
            if not hasattr(ds, "imu"):
                ap.error("--inertial requires an IMU stream (EuRoC layout)")
            imu_rows = ds.imu()
        n = 0
        t0 = time.perf_counter()
        for ts, left, right in ds.frames():
            samples = None
            if imu_rows is not None:
                # the samples in (previous frame, this frame]
                end = imu_pos
                while end < len(imu_rows) and imu_rows[end, 0] <= ts:
                    end += 1
                samples = [(r[0], r[1:4], r[4:7])
                           for r in imu_rows[imu_pos:end]]
                imu_pos = end
            with sw.scope("track"):
                if args.mono:
                    system.track_monocular(left, ts)
                else:
                    system.track_stereo(left, right, ts,
                                        imu_samples=samples)
            n += 1
        dt = time.perf_counter() - t0
        print(json.dumps({"frames": n, "fps": round(n / dt, 2),
                          **system.map_statistics()}))
    else:
        ap.error("choose --synthetic, --tum, --euroc or --kitti")

    system.flush()
    writer = {"tum": trajectory.write_tum, "kitti": trajectory.write_kitti,
              "euroc": trajectory.write_euroc}[args.out_format]
    writer(args.out, system.trajectory)
    print(f"trajectory written to {args.out}")

    save_map_path = args.save_map
    if not save_map_path and st and st.save_map and st.map_filename:
        save_map_path = st.map_filename
    save_dense_path = args.save_dense if system.dense_mapper else None
    # settles the session, stops its threads, then saves
    system.shutdown(save_map_path=save_map_path,
                    save_dense_path=save_dense_path)
    if save_map_path:
        print(f"map saved to {save_map_path}")
    if save_dense_path:
        print(f"dense map saved to {save_dense_path}")
    if args.viz:
        from .viz import map_drawer

        dense = None
        if system.dense_mapper is not None:
            dense = system.dense_mapper.cloud()[0]
        if args.settings:
            # static PLY overlays declared in the settings file (reference:
            # GlObjects.* block, drawn by the viewer src/Viewer.cc:813)
            from .viz.gl_objects import GlObjectList

            gl = GlObjectList()
            if gl.load(args.settings):
                overlay = gl.all_world_points()[0]
                dense = (overlay if dense is None
                         else np.concatenate([dense, overlay], 0))
        if map_drawer.render_map_png(args.viz, system.store,
                                     dense_cloud=dense,
                                     traj=system.trajectory_tum()[:, 1:4]):
            print(f"map rendered to {args.viz}")
    if viewer is not None:
        viewer.close()
    if args.timing:
        print(sw.report())

if __name__ == "__main__":
    main()
