"""The JAX package's figures for map reuse on the port's chip-smoke scene.

Runs ``plvs_tpu``'s synchronous RGB-D tracker with points and lines over
bench.py's structured-wall scene (``chip_smoke.py`` phase 2's scene and
flags) for ``--frames`` frames, saves the atlas with
``shutdown(save_map_path=...)``, loads it into a fresh System with the same
configuration (``load_map(freeze=True, force_relocalization=True)``) and
replays frames ``--replay A B`` of the same sweep. Prints one JSON line
with the state before the first replayed frame, the state per replayed
frame, the first OK frame, the camera-centre error of every OK frame
against ground truth and their median, the map count, and whether every
loaded keyframe pose stayed bit-equal. ``chip_smoke.py`` phase 15 holds the
port to these figures.

    JAX_PLATFORMS=cpu python scripts/reference_map_reuse.py --frames 40
        [--replay 18 30]

On an 8-core x86 CPU (jax 0.9.0, a parallel test run beside it)
``--frames 40`` took 164 s.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--replay", type=int, nargs=2, default=(18, 30))
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")

    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import synthetic
    from plvs_tpu.slam import System, SystemConfig
    from plvs_tpu.slam.tracking import OK

    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)

    def config():
        return SystemConfig(num_features=1024, n_levels=8, scale=1.2,
                            max_kf=256, max_pts=65536, use_lines=True,
                            max_lines=160, local_ba=False,
                            loop_closing=False, dense_mapping=False,
                            pipelined=False, depth_upload_decimation=2)

    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=420.0)
    t0 = time.perf_counter()
    frames = list(scene.sequence(n_frames=args.frames))
    system = System(cam, config())
    for ts, gray, depth, _, _ in frames:
        system.track_rgbd(gray, depth, ts)
    saved = system.map_statistics()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "atlas.npz")
        system.shutdown(save_map_path=path)
        reuse = System(cam, config())
        reuse.load_map(path, freeze=True, force_relocalization=True)
    st = reuse.store
    frozen = np.nonzero(st.kf_fixed)[0]
    R0, t0_ = st.kf_R[frozen].copy(), st.kf_t[frozen].copy()
    state_before = int(reuse.tracker.state)
    a, b = args.replay
    states, errs = [], []
    for i in range(a, b):
        ts, gray, depth, R_gt, t_gt = frames[i]
        state, R, t = reuse.track_rgbd(gray, depth, ts)
        states.append(int(state))
        if state == OK:
            errs.append(float(np.linalg.norm(-R.T @ t - (-R_gt.T @ t_gt))))
    wall = time.perf_counter() - t0
    first_ok = next((a + k for k, s in enumerate(states) if s == OK), None)
    out = {
        "device": "cpu (jax " + jax.__version__ + ")",
        "frames": args.frames,
        "replay": [a, b],
        "saved_map": saved,
        "loaded_keyframes": int(len(frozen)),
        "state_before": state_before,
        "states": states,
        "first_ok": first_ok,
        "centre_errs_m": errs,
        "median_centre_err_m": float(np.median(errs)) if errs else None,
        "n_maps": int(st.n_maps),
        "frozen_unchanged": bool(np.array_equal(st.kf_R[frozen], R0)
                                 and np.array_equal(st.kf_t[frozen], t0_)),
        "wall_s": wall,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
