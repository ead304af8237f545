"""Incremental-segmentation demo app: SLAM + dense mapping + 3D labels.

Counterpart of plvs_tpu/demo_inseg.py (the reference's
Examples_old/RGB-D/rgbd_inseg.cc: RGB-D SLAM with the dense backend in
segmentation mode: per-keyframe geometric segmentation, local-to-global
label association, per-voxel label confidence). The System runs on
``--device`` (``cuda`` by default; ``--cpu`` is ``--device cpu``); without
CUDA the default raises.

    python -m plvs_tpu_torch.demo_inseg --synthetic --frames 40 --out seg/
    python -m plvs_tpu_torch.demo_inseg --tum <sequence_dir> --out seg/

Writes the labelled surface cloud (PLY, coloured by label) and a label
census.
"""

from __future__ import annotations

import argparse
import itertools
import os

import numpy as np


def _label_colors(labels):
    rng = np.random.default_rng(3)
    n = int(labels.max()) + 1 if len(labels) else 1
    lut = rng.integers(40, 255, (max(n, 1), 3)).astype(np.uint8)
    lut[0] = (90, 90, 90)  # unlabeled
    return lut[labels]


def main(argv=None):
    ap = argparse.ArgumentParser(description="plvs_tpu_torch segmentation "
                                             "demo")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--tum", type=str, default=None)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", type=str, default="seg")
    ap.add_argument("--voxel", type=float, default=0.03)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the System (cuda by default)")
    ap.add_argument("--cpu", action="store_true", help="--device cpu")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else args.device

    from .geometry import cameras
    from .io import synthetic
    from .slam import System, SystemConfig
    from .slam.tracking import OK

    if args.tum:
        from .io import datasets

        seq = datasets.TumRGBD(args.tum)
        cam = cameras.pinhole(525.0, 525.0, 319.5, 239.5, width=640,
                              height=480, bf=40.0)
        frames = itertools.islice(seq.frames(), args.frames)
    else:
        cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320,
                              height=240, bf=24.0)
        room = synthetic.SyntheticRoom(cam)
        poses = synthetic.orbit_loop_trajectory(n_frames=args.frames,
                                                radius=0.6, laps=0.5)
        frames = ((ts, gray, depth) for ts, gray, depth, _R, _t in
                  room.sequence(poses))

    cfg = SystemConfig(num_features=512, n_levels=4, max_kf=64,
                       max_pts=16384, dense_mapping=True,
                       dense_segmentation=True,
                       dense_voxel_size=args.voxel)
    system = System(cam, cfg, device=device)
    os.makedirs(args.out, exist_ok=True)

    n_tracked = 0
    for ts, gray, depth in frames:
        state, _R, _t = system.track_rgbd(
            np.asarray(gray, np.float32), np.asarray(depth, np.float32), ts)
        n_tracked += int(state == OK)
    system.shutdown()

    pts, labels = system.dense_mapper.segment_cloud()
    cols = _label_colors(labels)
    ply = os.path.join(args.out, "segments.ply")
    with open(ply, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, c in zip(pts, cols):
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                    f"{c[0]} {c[1]} {c[2]}\n")
    uniq, counts = np.unique(labels[labels > 0], return_counts=True)
    print(f"segmentation demo: {n_tracked} frames tracked, "
          f"{len(pts)} surface voxels, {len(uniq)} segments -> {ply}")
    for u, c in sorted(zip(uniq.tolist(), counts.tolist()),
                       key=lambda x: -x[1])[:10]:
        print(f"  segment {u}: {c} voxels")


if __name__ == "__main__":
    main()
