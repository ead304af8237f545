"""AR demo app: SLAM + plane detection + virtual-object overlay.

Counterpart of plvs_tpu/demo_ar.py (the reference's
Examples_old/RGB-D/rgbd_tum_ar + ViewerAR.cc: plane detection over the
tracked map points, a virtual cube anchored on the plane, optional static
PLY overlay objects). The System and the plane RANSAC run on ``--device``
(``cuda`` by default; ``--cpu`` is ``--device cpu``); without CUDA the
default raises.

    python -m plvs_tpu_torch.demo_ar --synthetic --frames 60 --out ar_frames/
    python -m plvs_tpu_torch.demo_ar --tum <sequence_dir> --out ar_frames/

Writes one composited PNG every ``--every`` frames plus a summary line.
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description="plvs_tpu_torch AR demo")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--tum", type=str, default=None,
                    help="TUM RGB-D sequence dir")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", type=str, default="ar_frames")
    ap.add_argument("--cube-size", type=float, default=0.12)
    ap.add_argument("--object-ply", type=str, default=None,
                    help="static PLY overlay anchored on the detected "
                         "plane (reference: GlObjects.* yaml)")
    ap.add_argument("--every", type=int, default=5,
                    help="write every Nth frame")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the System (cuda by default)")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from .geometry import cameras
    from .io import synthetic
    from .slam import System, SystemConfig
    from .slam.tracking import OK
    from .viz import ar, frame_drawer

    if args.tum:
        from .io import datasets

        seq = datasets.TumRGBD(args.tum)
        # TUM freiburg-class intrinsics (reference: Settings/TUM*.yaml)
        cam = cameras.pinhole(525.0, 525.0, 319.5, 239.5, width=640,
                              height=480, bf=40.0)
        frames = itertools.islice(seq.frames(), args.frames)
    else:
        cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320,
                              height=240, bf=24.0)
        scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, seed=4)
        frames = ((ts, gray, depth) for ts, gray, depth, _R, _t in
                  scene.sequence(n_frames=args.frames))

    cfg = SystemConfig(num_features=512, n_levels=4, max_kf=64,
                       max_pts=16384)
    system = System(cam, cfg, device=device)
    os.makedirs(args.out, exist_ok=True)

    plane = None
    objects = []
    n_drawn = 0
    for i, (ts, gray, depth) in enumerate(frames):
        state, Rcw, tcw = system.track_rgbd(
            np.asarray(gray, np.float32), np.asarray(depth, np.float32), ts)
        if state != OK:
            continue
        st = system.store
        pts = st.pt_xyz[st.pt_mask]
        if plane is None and len(pts) >= 50:
            plane = ar.detect_plane(pts, device=system.device)
            if plane is not None:
                print(f"plane locked at frame {i}: origin={plane.origin}, "
                      f"inliers={plane.n_inliers}")
                if args.object_ply:
                    verts = ar.load_ply_vertices(args.object_ply,
                                                 max_points=3000)
                    objects.append(ar.GlObject(
                        verts=verts, Rwo=plane.Rwp,
                        two=plane.origin.astype(np.float32)))
        if i % args.every == 0:
            img = ar.render_ar_frame(np.asarray(gray, np.float32), cam,
                                     Rcw, tcw, pts_world=None, plane=plane,
                                     cube_size=args.cube_size,
                                     objects=objects, device=system.device)
            frame_drawer.save_png(
                os.path.join(args.out, f"ar_{i:05d}.png"), img)
            n_drawn += 1
    system.shutdown()
    print(f"AR demo: {n_drawn} composited frames in {args.out}/ "
          f"({'plane locked' if plane is not None else 'no plane found'})")


if __name__ == "__main__":
    main()
