"""Chip smoke test of plvs_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 prints the card's name and power limit and builds every CUDA
kernel of the port from ``plvs_tpu_torch/csrc`` (one nvcc per source, all
started together). Phase 1 holds each kernel against its plain PyTorch
version on the card (exact equality: K1 and K2 are integer functions, and
K3 rounds its few float steps once each in the same order as its plain
version) at the shapes the main paths give it plus ragged and adversarial
inputs (K1 also at fragment and tile edges, on words with the high bit set
and on strided views; K2's grids also at KITTI's 188x620 and 1280x720's
360x640, K3 also at r = 1 and at 376x1241). It times each kernel with one
CUDA-event pair around 100 back-to-back calls queued behind a spin kernel
(device time only; K1 at each of phase 2's shapes), the plain versions per
call, and K1's library yardsticks (the +-1 GEMM that the JAX package runs
for big products, as ``torch._int_mm`` and as ``torch.mm`` in bf16, each
checked equal to K1); checks with torch.profiler that one call of each
kernel runs exactly one device kernel; and measures the device memory one
K3 call adds. Phase 2 drives slice 1's path —
``System.track_rgbd``, synchronous RGB-D tracking with points and lines at
640x480, 1024 ORB features, 8 levels, 160 keylines, keyframe backend off —
over bench.py's structured-wall scene (its sweep in N_FRAMES = 40 frames;
phases 3-4 and 6-7 run the same 40), with every launch counter set to 0
just before and read just after, checks that every frame is tracked and
the trajectory's ATE is within the bound below, and prints K1's launches
by shape and their device time beside its bound. A phase's K1 device
time is measured over that phase's own run: each launch the run makes is
bracketed by a CUDA-event pair queued behind a short spin kernel, so the
pair holds the kernel and no host gap, and the pairs are summed (phase 1
prints what a bracket around no kernel reads). Phase 3 drives slice 2's
path the same way —
``System.track_stereo`` on rectified pairs of the same scene (the right
image one baseline to the right) with dense TSDF mapping and per-keyframe
incremental meshing — and checks tracking, ATE, one K3 launch per
keyframe, and the dense map against the JAX package's. Phase 4 drives
slice 5's path — ``System.track_rgbd`` as in phase 2 but with the
synchronous keyframe backend on (``local_ba=True`` with bench.py's fixed
BA shapes: culling, line triangulation and neighbour fuse through K1,
landmark maintenance, the windowed local bundle adjustment, keyframe
culling) — and checks tracking, the ATE and the live map against the JAX
package's run of the same configuration, and one finite, non-increasing
local BA per keyframe whose window gave a problem; it prints the backend's
stage times per keyframe (synchronised scopes), the LM and CG iterations
per solve, and K1's launches by shape with their device time beside the
bound (phase 1 holds K1 exact at the backend's shapes too). Phase 5
drives slice 6's loop-closure path — ``System.track_rgbd`` with local BA,
loop closing and dense mapping, points only, over the four-wall room orbit
(1.375 laps, 132 frames, depth noise) at 640x480 / 1024 features / 8
levels — and holds it to the JAX package's run of the same configuration:
every frame tracked, a loop closed against one of the first keyframes at
about JAX's keyframe with a falling pose-graph cost, the global BA finite
and non-increasing, the ATE, the live map, and the dense map after the
rebuild; it prints the loop stages' ms (synchronised scopes) per keyframe
and per closure. Phase 6 drives the relocalization path — phase 2's scene
and flags with a blackout of blank frames, the RECENTLY_LOST grace
granted from 3 keyframes — and holds the state sequence (RECENTLY_LOST,
then OK) to JAX's and the final camera centre to ground
truth. Phase 7 drives slice 7's path — ``System.track_rgbd`` in bench.py's
configuration (lines, local BA, loop closing, dense mapping, fixed BA
shapes, pipelined at depth 4 with the overlap thread and the interleaved
backend) over phase 2's scene, then ``flush()`` — and holds it to the JAX
package's run of it: every frame resolved and OK, every queue empty, the
ATE, the live map and the dense map, and K2 launched once per line frame
built; it prints what ``track_rgbd`` costs the tracking thread (p50, p90),
the resolves, the backend's ``_stage_stats`` and largest backlog. Phase 8
is the same with the mapper actor (``async_mapping``, bench.py's
PLVS_BENCH_ASYNC=1 path) over the same 40 frames, held to the median of
five JAX runs (every frame OK, the ATE bound, the live and dense maps),
with the actor error-free and joined by ``shutdown()``; it prints keyframe
and other frames' p50 and p90 and the
frames during which a loop closed. Phase 9 drives slice 8's inertial path
in bench.py's RGB-D-inertial scenario (``_vi_throughput_scenario``:
640x480, 1024 features, 8 levels, no lines, local BA, ``use_imu``,
pipelined at depth 2 with the overlap thread, fixed BA shapes, a keyframe
at least every 4 frames) over the first 66 frames of its timed pass with
a 300 Hz IMU, then ``flush()``, and holds it to the JAX package's run: every
frame resolved and OK, the IMU initialized at JAX's keyframe +-2, the
gravity's cosine to the truth over 0.98, the gyro bias within 5e-3 of the
truth, the ATE bound, the live keyframes and points within +-25%, and one
finite VI BA per keyframe after initialization; it prints track_rgbd's
p50 and p90 beside bench.py's vi_fps measure, the frame-gap
preintegration's ms and dispatched operations, and the VI BA's ms with its
LM and CG iterations. Phase 10 drives slice 9's rig path —
``System.track_stereo`` with ``cam2`` / ``T_c1_c2``: tests/test_stereo_rig.py's
KB8 fisheye pair scaled to 640x480 over the first 45 of 120 poses of
phase 2's sweep, local BA with fixed BA shapes, no lines — and holds it to
the JAX package's run (``scripts/reference_rig.py``): every frame OK, the ATE, the
live keyframes and points, the first frame's triangulated depths against
the rendered depth (the JAX test's gates), and K1 at 1024x1024 every
frame, exact on the first frame's descriptors. Phase 11 runs the same rig
with ``rectify=True`` and 2 cm dense mapping over 40 frames (every frame
OK, the ATE, K3 once per keyframe, the dense map) and then
``disparity(method="sgm")`` on the first rectified pair (its valid share
and median depth error against JAX's, its ms and dispatched operations,
no K3 launch). Phase 12 drives RGB-D with ``dense_segmentation``
(demo_inseg.py's configuration at bench width over the room orbit,
``scripts/reference_inseg.py``): every frame OK, the ATE, the segmented
voxels and segments, ``segment_depth``'s ms and operations a keyframe;
then the dense library on the stored keyframes at their final poses
(``DenseMapper(multi_res=True, carve_every=3, fixed_shapes=True)`` through
``insert_keyframe_rgbd``): the fine and coarse occupied voxels, triangles
and carved voxels against JAX's, the ESDF at 1000 wall points and the mesh
normals against the room's walls. Phase 13 drives slice 10's monocular
path — ``System.track_monocular`` at bench width (two-view
initialization, map growth by ``create_new_points``, local BA, loop
closing) over tests/test_slam_e2e.py TestMonocular's scene and
trajectory, frames 28-30 blank — and holds it to the JAX package's run
(``scripts/reference_mono.py --phase 13``): frame 0 NOT_INITIALIZED, OK
within two frames of JAX's init frame, lost on the blank frames, OK again
within three frames of JAX's relocalizing frame after a PnP RANSAC, the
Sim3-aligned ATE over the OK frames, the live map, and points added by
``create_new_points``; it prints the init and relocalizing frames' ms and
``create_new_points``' ms and dispatched operations. Phase 14 drives
RGB-D at ``image_scale=0.5`` (640x480 in, 320x240 at 1024 features and 8
levels: ORB's per-level path) with local BA, loop closing and one planar
map object (``add_map_object``), held to ``reference_mono.py --phase
14``: every frame OK, the ATE, the map, the object's detections and its
corners on the wall (tests/test_objects_e2e.py's gates); it prints the
per-level extraction's ms at 320x240 and for the template. After each of
phases 2-14, K1 is held exact against its plain version at every shape
that phase launched and no earlier phase had checked. Each phase prints
its wall seconds (``phase N: wall``); the run keeps well inside its
1,200 s limit only because phases 2-4 and 6-11 run fewer frames than
their scenes allow (the constants below say how many).

It prints one ``{"kernels": [...]}`` line and ends with one
``{"ok": true, "device": {...}}`` line. Any failed phase exits non-zero; so
does a machine without CUDA, or a directory without the port beside this
file. Imports nothing of jax or plvs_tpu.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# JAX package's ATE-RMSE on this scene and configuration (CPU run of
# scripts/reference_ate_rgbd_lines.py --frames 40, 217 s: all OK, 4
# keyframes, 2486 points, 121 lines); the port is held to max(1.5 x it,
# it + 1 cm)
REF_ATE_M = 0.002905134946910159
ATE_BOUND_M = max(1.5 * REF_ATE_M, REF_ATE_M + 0.01)

# JAX package's figures on phase 3's stereo dense-mapping run (CPU run of
# scripts/reference_ate_stereo_dense.py --frames 40, 220 s: all OK, 5
# keyframes, 1949 points, 23 lines, 2532 blocks). The port is held to the
# ATE bound below, the occupied-voxel and mesh-triangle counts within +-25%, and the
# median |z - 3 m| of the occupied centroids within the JAX value + 2 cm.
# (The JAX package's CPU path computes disparity with its jnp volume, whose
# border semantics differ from the TPU kernel's, which K3 follows.)
REF_STEREO_ATE_M = 0.017282789188066944
STEREO_ATE_BOUND_M = max(1.5 * REF_STEREO_ATE_M, REF_STEREO_ATE_M + 0.01)
REF_OCCUPIED_VOXELS = 150988
REF_MEDIAN_ABS_DZ_M = 0.029999971389770508
REF_MESH_TRIANGLES_FULL = 231690
REF_MESH_TRIANGLES_INCREMENTAL = 70264
WALL_Z = 3.0

# JAX package's figures on phase 4's run (CPU run of
# JAX_PLATFORMS=cpu python scripts/reference_ate_rgbd_lines.py --local-ba
# --frames 40, 175 s: all OK, 5 keyframes made, none culled). The port is
# held to the ATE bound below and its live keyframes, points and lines
# within +-25% of these.
REF_LBA_ATE_M = 0.004323713450164359
LBA_ATE_BOUND_M = max(1.5 * REF_LBA_ATE_M, REF_LBA_ATE_M + 0.01)
REF_LBA_MAP = {"keyframes": 5, "points": 1554, "lines": 103}

# JAX package's figures on phase 5's loop-closure run (CPU run of
# JAX_PLATFORMS=cpu python scripts/reference_loop_room.py, 132 frames, 154
# s: all OK; one loop, keyframe 29 against candidate 0, 198 inliers,
# pose-graph cost 3.620 -> 0.01038; global BA cost 101997 -> 10263; 34
# live keyframes, 8016 points; after the rebuild 616668 occupied voxels,
# 1588332 mesh triangles). The port is held to: every frame after the
# first OK; >= 1 loop, the first against a keyframe among 0-2 at a keyframe
# within +-3 of JAX's; a falling pose-graph cost; a finite, non-increasing
# global BA; the ATE bound below; live keyframes / points and the dense
# counts after the first rebuild within +-25%.
REF_LOOP_KF = 29
REF_LOOP_ATE_M = 0.0567200505056132
LOOP_ATE_BOUND_M = max(1.5 * REF_LOOP_ATE_M, REF_LOOP_ATE_M + 0.01)
REF_LOOP_MAP = {"keyframes": 34, "points": 8016}
REF_LOOP_DENSE = {"occupied": 616668, "triangles": 1588332}
N_LOOP_FRAMES = 132

# JAX package's states on phase 6's relocalization run (CPU run of
# JAX_PLATFORMS=cpu python scripts/reference_reloc.py --frames 40
# --blackout 30 33 --recently-lost-keyframes 3, 141 s: OK, then
# RECENTLY_LOST on frames 30-32, OK from frame 33 on; final camera centre
# 0.0036 m from ground truth). Both trackers grant the RECENTLY_LOST grace
# from 3 keyframes (min_kf_recently_lost, 10 by default): the 40-frame map
# holds 4, and with fewer than the minimum a blackout goes LOST instead.
# The port is held to the same first lost frame and state within +-1
# frame, OK from the same frame on, and a final centre within 0.1 m of
# ground truth.
RELOC_BLACKOUT = (30, 33)
RELOC_RECENTLY_LOST_KFS = 3
REF_RELOC_FIRST_LOST = 30
REF_RELOC_LOST_STATE = 5       # RECENTLY_LOST
REF_RELOC_OK_FROM = 33

# JAX package's figures on bench.py's configuration (bench.py:60-90 with
# its environment defaults: lines, local BA, loop closing, dense mapping,
# fixed BA shapes, pipelined at depth 4 with the overlap thread, the
# interleaved backend) over phase 2's scene, with the two timing decisions
# taken out (CPU run of JAX_PLATFORMS=cpu python
# scripts/reference_bench_config.py --inline --frames 40, 135 s: all OK,
# no loop, 4 keyframes made, _stage_stats ready 20 / deadline 0 / forced
# 0, largest backlog 1 — the schedule the port's run on the card takes,
# where every fetch is done by the next poll; free-running CPU runs resume
# some stages on their deadline or by force). Phase 7 holds the port to
# the ATE bound below and its live keyframes, points and lines, occupied
# voxels and mesh triangles within +-25% of these.
REF_BENCH_ATE_M = 0.005082445125080849
BENCH_ATE_BOUND_M = max(1.5 * REF_BENCH_ATE_M, REF_BENCH_ATE_M + 0.01)
REF_BENCH_MAP = {"keyframes": 4, "points": 1552, "lines": 91}
REF_BENCH_DENSE = {"occupied": 122097, "triangles": 216268}

# JAX package's figures on phase 8's run: phase 7's configuration with
# async_mapping=True (bench.py's PLVS_BENCH_ASYNC=1 path) over phase 2's
# scene in 40 frames (CPU runs of JAX_PLATFORMS=cpu python
# scripts/reference_bench_config.py --async --frames 40, ~185 s each).
# With the actor's helper thread a run is one sample, so five were made:
# all resolved every frame OK and closed no loop, with 4 live keyframes (5
# in one), 1603-1628 points, 94 lines (106), 123001-128259 occupied voxels
# and 216112-235104 mesh triangles, ATE 0.00425-0.00518 m; a --settled run
# gave the same (4, 1627, 93, 122260, 216264). Phase 8 holds the port to
# every frame resolved OK, the ATE bound below and its live keyframes,
# points and lines, occupied voxels and mesh triangles within +-25% of
# the five runs' medians, here.
REF_ASYNC_ATE_M = 0.004743626946600431
ASYNC_ATE_BOUND_M = max(1.5 * REF_ASYNC_ATE_M, REF_ASYNC_ATE_M + 0.01)
REF_ASYNC_MAP = {"keyframes": 4, "points": 1610, "lines": 94}
REF_ASYNC_DENSE = {"occupied": 123605, "triangles": 216120}

# JAX package's figures on phase 9's run: bench.py's RGB-D-inertial
# scenario (bench.py:376-384) over the first 66 of the timed pass's 90
# frames (seed 1), with the overlap thread off (JAX_PLATFORMS=cpu python
# scripts/reference_vi.py --inline --frames 66, CPU run, 81 s): every
# frame resolved OK, the IMU initialized when the 13th keyframe was made,
# gravity cosine 0.99879 to the truth, gyro bias 1.43e-3 from it, 17
# keyframes made and 11 live, 5 VI BA solves, all finite (over 60 frames
# the init comes as late, leaving 3 solves). Phase 9 holds the port to its ATE
# bound below, its initialization keyframe +-2 and its live keyframes and
# points within +-25%; the gravity and bias gates are
# tests/test_slam_e2e.py's (cosine > 0.98, bias within 5e-3).
REF_VI = {"init_keyframe": 13, "gravity_cos": 0.9987934432984156,
          "bias_gyro_err": 0.0014336607067095,
          "ate_rmse_m": 0.004861690667277721,
          "map": {"keyframes": 11, "points": 1804}, "vi_ba_ok": 5}
VI_ATE_BOUND_M = max(1.5 * REF_VI["ate_rmse_m"], REF_VI["ate_rmse_m"] + 0.01)
N_VI_FRAMES = 66

# JAX package's figures on phase 10's run: the KB8 fisheye rig over the
# first 45 of 120 poses of phase 2's sweep (CPU run of JAX_PLATFORMS=cpu
# python scripts/reference_rig.py --phase 10 --frames 45, 67 s: all
# OK). The port is held to the ATE bound below, its live keyframes and
# points within +-25% of these, and on the first frame to
# tests/test_stereo_rig.py's gates (>= 100 triangulated, |median relative
# depth error| < 0.02, median |error| < 0.08).
REF_RIG = {"ate_rmse_m": 0.012289456903161126,
           "map": {"keyframes": 8, "points": 1098}, "keyframes_made": 9,
           "first_frame": {"triangulated": 542,
                           "median_rel_err": 0.002783536911010742,
                           "median_abs_rel_err": 0.0468568429350853}}
RIG_ATE_BOUND_M = max(1.5 * REF_RIG["ate_rmse_m"], REF_RIG["ate_rmse_m"] + 0.01)
N_RIG_FRAMES = 45
RIG_PATH_POSES = 120
# JAX package's figures on phase 11's run: the same rig with rectify=True
# and 2 cm dense mapping (CPU run of JAX_PLATFORMS=cpu python
# scripts/reference_rig.py --phase 11 --frames 40, 77 s: all OK, 8
# keyframes made; the fine volume fills its 8192 blocks). The port is held
# to the ATE bound below, one K3 launch per keyframe made, the occupied
# voxels and mesh triangles within +-25% of these (the JAX package's CPU
# path computes disparity with its jnp volume, K3 has the TPU kernel's
# border semantics), the median |z - 3 m| within the JAX value + 2 cm (phase
# 3's limit), and SGM on the first rectified pair to JAX's valid share
# +-0.01 and median |depth - 3 m| + 5 mm (JAX on the CPU: 8.2 s).
REF_RECT = {"ate_rmse_m": 0.0055807473845559275,
            "map": {"keyframes": 8, "points": 986}, "keyframes_made": 8,
            "occupied_voxels": 160715, "mesh_triangles_full": 143652,
            "median_abs_dz_m": 0.06999993324279785,
            "sgm_first_pair": {"valid_share": 0.6937890625,
                               "median_abs_depth_err_m": 0.15798723697662354}}
RECT_ATE_BOUND_M = max(1.5 * REF_RECT["ate_rmse_m"],
                       REF_RECT["ate_rmse_m"] + 0.01)
N_RECT_FRAMES = 40
# JAX package's figures on phase 12's run: demo_inseg.py's configuration
# at bench width over phase 5's room (no depth noise) on
# orbit_loop_trajectory(60, radius=0.6, laps=0.5) (CPU run of
# JAX_PLATFORMS=cpu python scripts/reference_inseg.py, 72 s: all OK, 14
# keyframes, no loop; the segmentation links the room's inside corners, so
# one segment holds confidence >= 2), then the library check on the stored
# keyframes at their final poses (61 s). The port is held to the ATE bound
# below, the segmented surface voxels and the segments at confidence >= 2
# within +-25% of these, one segmentation per dense keyframe; the
# library's fine and coarse occupied voxels, triangles and carved voxels
# within +-25%, the ESDF's median at 1000 wall points within one voxel and
# the mesh normals' median cosine to the walls over 0.9.
REF_SEG = {"ate_rmse_m": 0.01740683263875813, "first_ok": 1,
           "map": {"keyframes": 14, "points": 3584}, "loops": 0,
           "segmented_voxels": 325471, "labelled_voxels": 299653,
           "segments_conf2": 1, "next_global": 7,
           "library": {"fine_occupied": 197837, "coarse_occupied": 4623,
                       "triangles": 369874, "carved_voxels": 287402,
                       "esdf_grid": [223, 157, 317], "esdf_median_m": 0.0,
                       "normals_median_cos": 0.9999128580093384}}
SEG_ATE_BOUND_M = max(1.5 * REF_SEG["ate_rmse_m"],
                      REF_SEG["ate_rmse_m"] + 0.01)
N_SEG_FRAMES = 60

# JAX package's figures on phase 13's run: System(sensor="mono") at
# bench.py's camera and widths over tests/test_slam_e2e.py TestMonocular's
# scene (seed 9) and 40-pose trajectory, loop closing and local BA on,
# frames 28-30 blanked (CPU runs of JAX_PLATFORMS=cpu python
# scripts/reference_mono.py --phase 13, 107 s for the first key): NOT_
# INITIALIZED on frame 0, OK from frame 1, LOST on 28-30, OK again from 31
# through the PnP branch (406 matches and 4 inliers at the first
# candidate, 364 and 28 at the second), 8 live keyframes and 1383 points;
# Sim3-aligned ATE over the OK frames 0.014281 m. Over five relocalization
# / two-view keys (7, 1, 2, 3, 4) the init frame was 1 and the relocalizing
# frame 31 every time, the ATE 0.01422-0.01572 m and the map the same. The
# port's generator cannot replay jax.random's stream, so phase 13 holds it
# to: frame 0 NOT_INITIALIZED, OK by frame 1 + 2, not OK on 28-30, OK again
# by frame 31 + 3 after at least one PnP RANSAC, every later frame OK, the
# ATE bound below, live keyframes and points within +-25%, and at least
# one create_new_points stage that adds points.
REF_MONO = {"ate_sim3_ok_m": 0.014281059602864443, "init_frame": 1,
            "reloc_frame": 31, "map": {"keyframes": 8, "points": 1383}}
MONO_BLACKOUT = (28, 31)
MONO_ATE_BOUND_M = max(1.5 * REF_MONO["ate_sim3_ok_m"],
                       REF_MONO["ate_sim3_ok_m"] + 0.01)
# JAX package's figures on phase 14's run: RGB-D at 640x480 with
# image_scale=0.5 (320x240 at 1024 features / 8 levels: the per-level ORB
# path), local BA and loop closing on, no lines, 40 frames of seed 1's
# wall, one map object (tests/test_objects_e2e.py's template: a 256 px
# crop at offset 20 of the wall texture, 256 / tex_scale m wide, 345
# template features) (CPU run of JAX_PLATFORMS=cpu python
# scripts/reference_mono.py --phase 14, 79 s): all OK, 5 keyframes, 1125
# points, the object detected at all 5 keyframes (13 inliers at the last),
# its corners within 5 mm of the crop rectangle in x and y at z
# 2.977-3.030. Phase 14 holds the port to: every frame OK, the ATE bound
# below, keyframes and points within +-25%, the object detected at >= 4
# keyframes, and tests/test_objects_e2e.py's corner gates.
REF_SCALED = {"ate_rmse_m": 0.008550482888938568,
              "map": {"keyframes": 5, "points": 1125},
              "detected_keyframes": 5, "n_inliers_last": 13,
              "template_features": 345}
SCALED_ATE_BOUND_M = max(1.5 * REF_SCALED["ate_rmse_m"],
                         REF_SCALED["ate_rmse_m"] + 0.01)
N_MONO_FRAMES = 40

# phases 2-4 and 6-7: bench.py's sweep (default_trajectory) in 40 frames,
# three times the step of a 120-frame run, to keep the script well inside
# its time limit
N_FRAMES = 40
# K1's (Q, K) shapes on phase 2's path
K1_MIX_SHAPES = ((4096, 1024), (2048, 1024), (1024, 1024), (512, 160),
                 (256, 160), (128, 160))
# K1's shapes on phase 4's keyframe backend: line matches of a keyframe's
# 128 keyline rows against 1-4 neighbours' (stacked), fuse of its points
# against 1-5 neighbours' 1024 keypoints (stacked)
K1_BACKEND_SHAPES = ((128, 128), (128, 512), (1024, 5120))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
CUDA_CORE_OPS_PER_S = 67e12   # H100 SXM non-tensor peak (float32 figure)
# ~0.1 s of spin at the H100's clocks: longer than the host takes to
# enqueue _time_ms's calls, so they queue up behind it
SPIN_CYCLES = 200_000_000
# shortest of _device_ops_per_call's spin markers (~25 us at the H100's
# clocks); call i's marker is 4^i times as long
MARK_CYCLES = 50_000
# spin queued before each bracketed K1 launch of a phase's run (~1 ms at
# the H100's clocks): far longer than the host takes from the spin's
# launch to K1's (each phase prints that host time beside the spin's), so
# the start event fires with the kernel already queued
BRACKET_CYCLES = 2_000_000


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


_LAP = [time.perf_counter()]


def _lap(phase: int) -> None:
    """Print the wall seconds since the previous lap (the script start for
    phase 0): what each phase costs of the script's time limit."""
    now = time.perf_counter()
    print(f"phase {phase}: wall {now - _LAP[0]:.1f} s")
    _LAP[0] = now


def _time_ms(torch, fn, reps: int = 100, warmup: int = 5) -> float:
    """Device time of one kernel call: one event pair around ``reps``
    back-to-back calls, divided by ``reps``. The stream is first held by a
    spin kernel (``torch.cuda._sleep``) while the host enqueues every call,
    so the window holds device time only, not the wrappers' host work."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class _K1Brackets:
    """Device time of the K1 launches that a phase's run makes. Inside
    ``run()``, each launch is bracketed by a CUDA-event pair queued behind
    a spin kernel, so the pair holds the kernel (and the pair's own
    events), not the host's launch work, as long as the host time from
    the spin's launch to K1's (``host_s``, kept per launch) is shorter than
    the spin. Launches outside a run (the checks against the plain
    version, the timing loops) go unbracketed."""

    def __init__(self, torch, hamming):
        self.torch, self.on = torch, False
        self.pairs, self.host_s = [], []
        launch = hamming._lib().plvs_hamming
        brackets = self

        class Bracketed:
            @staticmethod
            def plvs_hamming(d1, d2, out, q, k, stream):
                if not brackets.on:
                    return launch(d1, d2, out, q, k, stream)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                # a first record creates the events before the spin starts
                start.record()
                end.record()
                t0 = time.perf_counter()
                torch.cuda._sleep(BRACKET_CYCLES)
                start.record()
                err = launch(d1, d2, out, q, k, stream)
                brackets.host_s.append(time.perf_counter() - t0)
                end.record()
                brackets.pairs.append(((q, k), start, end))
                return err

        hamming._lib = Bracketed
        self.spin_ms = self._spin_ms()

    def _spin_ms(self, reps: int = 5) -> float:
        """Median device time of one bracket spin."""
        times = []
        for _ in range(reps):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            self.torch.cuda._sleep(BRACKET_CYCLES)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    @contextlib.contextmanager
    def run(self):
        self.pairs.clear()
        self.host_s.clear()
        self.on = True
        try:
            yield
        finally:
            self.on = False

    def ms_by_shape(self, idx=None) -> dict:
        """{(Q, K): [device ms of each bracketed launch]} over the last run
        (or over the launches at indices ``idx`` of it)."""
        self.torch.cuda.synchronize()
        pairs = self.pairs if idx is None else [self.pairs[i] for i in idx]
        out = {}
        for shape, start, end in pairs:
            out.setdefault(shape, []).append(start.elapsed_time(end))
        return out

    def empty_ms(self, reps: int = 20) -> float:
        """Median reading of a bracket around no kernel."""
        times = []
        for _ in range(reps):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            end.record()
            self.torch.cuda._sleep(BRACKET_CYCLES)
            start.record()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def host_summary(self) -> str:
        """The last run's host time from a spin's launch to K1's."""
        if not self.host_s:
            return "no bracketed launch"
        ms = np.asarray(self.host_s) * 1e3
        return (f"host time from the spin's launch to K1's median "
                f"{np.median(ms):.6f} ms, max {ms.max():.6f} ms, longer than "
                f"the spin ({self.spin_ms:.6f} ms) in "
                f"{int((ms >= self.spin_ms).sum())} of {len(ms)} launches")


def _k1_report(phase: int, label: str, by_shape: dict, k1_ms_at: dict,
               brackets=None):
    """Print K1's bracketed device ms over a phase's run by shape, beside
    phase 1's back-to-back time at that shape and the bound (and, given
    ``brackets``, the run's host time inside the spins); returns the run's
    (device ms, bound ms)."""
    dev = sum(sum(v) for v in by_shape.values())
    bound = sum(len(v) * _k1_bound(*s_)[0] for s_, v in by_shape.items())
    print(f"phase {phase}: K1 {label}: "
          f"{sum(len(v) for v in by_shape.values())} launches, device ms "
          f"{dev:.6f} (bracketed launches), bound {bound:.6f}; by Q x K "
          "(launches, median bracket ms, back-to-back ms): " + ", ".join(
              f"{q}x{k} ({len(v)}, {np.median(v):.6f}, "
              f"{k1_ms_at[(q, k)]:.6f})"
              for (q, k), v in sorted(by_shape.items()))
          + (f"; {brackets.host_summary()}" if brackets else ""))
    return dev, bound


def _time_ms_per_call(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Median of one event pair around each call (host work included):
    the plain versions' form, where tens of launches per call make the
    host share small."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _short(kernel_name: str) -> str:
    name = kernel_name.replace("(anonymous namespace)::", "")
    return name.split("(")[0][:60]


def _marker_index(us: float, us_per_cycle: float) -> int:
    """Index i of a spin marker of MARK_CYCLES x 4^i cycles, from its
    device duration; -1 when it lies off the ladder."""
    ratio = us / (MARK_CYCLES * us_per_cycle)
    i = round(math.log(ratio, 4)) if ratio > 0 else -1
    return i if i >= 0 and abs(math.log(ratio, 4) - i) < 0.25 else -1


def _clean_segments(events, n: int, us_per_cycle: float) -> list:
    """Split time-sorted (name, device us) events at the spin markers and
    keep the ops of call i only where the marker before them reads i and
    the next reads i + 1 (n closes a round): a segment whose bounding
    marker was dropped would merge two calls. Returns n lists of op lists."""
    segments = []
    for name, us in events:
        if "spin_kernel" in name:
            segments.append((_marker_index(us, us_per_cycle), []))
        elif segments:
            segments[-1][1].append((name, us))
    clean = [[] for _ in range(n)]
    for (i, ops), (j, _) in zip(segments, segments[1:]):
        if 0 <= i < n and j == i + 1:
            clean[i].append(ops)
    return clean


def _device_ops_per_call(torch, calls: dict, rounds: int = 4) -> dict:
    """Trace warm calls of each function of ``calls`` with torch.profiler
    and print the device operations one call ran (name and device us);
    returns, by label, the op lists of every cleanly bounded call.

    All calls share one profiler session (a second session in the process
    saw no device events once cuBLAS had started after the first). Call i
    follows a spin kernel of MARK_CYCLES x 4^i cycles and a longer one
    closes each round, so a marker's duration names the call after it.
    CUPTI now and then drops an event from a trace (one card run saw 3 of
    4 markers in a single round), so the calls run ``rounds`` times and
    only segments with both bounding markers present are read; each call
    needs at least one."""
    from torch.profiler import ProfilerActivity, profile

    labels = list(calls)
    n = len(labels)
    # cycles -> us at this run's clocks, from the closing marker's length;
    # a first long spin loads the spin kernel (lazy module loading would
    # otherwise fall inside the timed pair) and raises the clocks
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for fn in calls.values():
        fn()
    torch.cuda._sleep(SPIN_CYCLES)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(MARK_CYCLES * 4 ** n)
    end.record()
    end.synchronize()
    us_per_cycle = start.elapsed_time(end) * 1e3 / (MARK_CYCLES * 4 ** n)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for i, fn in enumerate(calls.values()):
                torch.cuda._sleep(MARK_CYCLES * 4 ** i)
                fn()
            torch.cuda._sleep(MARK_CYCLES * 4 ** n)
            torch.cuda.synchronize()
    events = [(name, us) for _, name, us in sorted(
        (e.time_range.start, e.name, e.time_range.elapsed_us())
        for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)]
    clean = _clean_segments(events, n, us_per_cycle)
    for label, segs in zip(labels, clean):
        if not segs:
            marks = [round(us, 3) for nm, us in events if "spin_kernel" in nm]
            _fail(f"torch.profiler traced no call of {label} with both of "
                  f"its markers in {rounds} rounds (markers, us: {marks}; "
                  f"{us_per_cycle * 1e3:.4f} ns a cycle)")
        ops = segs[0]
        print(f"phase 1: {label}: one call ran {len(ops)} device op(s): "
              + "; ".join(f"{_short(nm)} {us:.3f} us" for nm, us in ops)
              + f" ({len(segs)} of {rounds} rounds cleanly bounded, op "
              f"counts {[len(s) for s in segs]})")
    return dict(zip(labels, clean))


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _scene(cam, synthetic):
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    return synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                   tex_scale=420.0)


def _phase3(torch, cam, scene, brackets, k1_ms_at: dict, words) -> dict:
    """Slice 2's main path: rectified stereo tracking with dense TSDF
    mapping and per-keyframe incremental meshing; returns the launches and
    K1's device ms over the run."""
    from plvs_tpu_torch.io import evaluation
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import OK
    from plvs_tpu_torch.utils.profiling import Stopwatch

    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=True, max_lines=160,
                       sensor="stereo", local_ba=False, loop_closing=False,
                       dense_mapping=True, dense_voxel_size=0.02,
                       dense_mesh_every=1, pipelined=False)
    system = System(cam, cfg, device="cuda")
    watch = Stopwatch(sync_device=torch.device("cuda"))
    system.set_stopwatch(watch)
    shift = np.array([cam.bf / float(cam.params[0]), 0.0, 0.0], np.float32)
    frames = [(ts, g, scene.render(R, t - shift)[0], R, t)
              for ts, g, _, R, t in scene.sequence(n_frames=N_FRAMES)]
    hamming.launches = cc_labels.launches = stereo.launches = 0
    states, ms = [], []
    with brackets.run():
        for ts, gl, gr, _, _ in frames:
            t1 = time.perf_counter()
            state, _, _ = system.track_stereo(gl, gr, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    by_shape = brackets.ms_by_shape()
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(est, gt, align=True)
    stats = system.map_statistics()
    n_kf = stats["keyframes"]
    dm = system.dense_mapper
    pts, _ = dm.cloud()
    med_dz = float(np.median(np.abs(pts[:, 2] - WALL_Z))) if len(pts) else 1e9
    _, faces = dm.mesh()
    n_full, n_inc = len(faces), dm.mesher.n_triangles
    steady = np.asarray(ms[1:])
    per_kf = {k: sum(v) * 1e3 / max(n_kf, 1)
              for k, v in sorted(watch.samples.items())
              if k.startswith("dense")}
    print(f"phase 3: {N_FRAMES} stereo frames 640x480, per-frame ms p50 "
          f"{np.percentile(steady, 50):.2f} p90 {np.percentile(steady, 90):.2f} "
          f"(first frame {ms[0]:.1f}; keyframe frames include the "
          f"synchronised dense stage); map {stats}; ATE-RMSE {ate:.6f} m "
          f"(JAX {REF_STEREO_ATE_M:.6f} m, bound {STEREO_ATE_BOUND_M:.6f} m); "
          f"launches {launches}")
    print("phase 3: dense stage ms per keyframe "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_kf.items())
          + f"; remeshed blocks {dm.remesh_counts}")
    print(f"phase 3: dense map: {dm.volume.n_blocks} blocks, {len(pts)} "
          f"occupied voxels (JAX {REF_OCCUPIED_VOXELS}), median |z - "
          f"{WALL_Z}| {med_dz:.6f} m (JAX {REF_MEDIAN_ABS_DZ_M:.6f}), mesh "
          f"triangles full {n_full} (JAX {REF_MESH_TRIANGLES_FULL}) "
          f"incremental cache {n_inc} (JAX {REF_MESH_TRIANGLES_INCREMENTAL})")
    if not all(s == OK for s in states[1:]):
        _fail(f"phase 3 tracking states {states}")
    if not np.isfinite(est).all() or ate > STEREO_ATE_BOUND_M:
        _fail(f"phase 3 ATE {ate} m exceeds the bound {STEREO_ATE_BOUND_M} m")
    if launches["stereo_wta"] != n_kf:
        _fail(f"K3 launched {launches['stereo_wta']} times for {n_kf} "
              "keyframes")
    if (launches["hamming"] < 2 * N_FRAMES
            or launches["cc_labels"] < 2 * N_FRAMES):
        _fail(f"K1 / K2 launched {launches} times in {N_FRAMES} frames")
    for name, got, ref in (
            ("occupied voxels", len(pts), REF_OCCUPIED_VOXELS),
            ("full mesh triangles", n_full, REF_MESH_TRIANGLES_FULL),
            ("incremental mesh triangles", n_inc,
             REF_MESH_TRIANGLES_INCREMENTAL)):
        if abs(got - ref) > 0.25 * ref:
            _fail(f"phase 3 {name} {got} not within 25% of JAX's {ref}")
    if med_dz > REF_MEDIAN_ABS_DZ_M + 0.02:
        _fail(f"phase 3 median |z - {WALL_Z}| {med_dz} m: the wall is off")
    launches["k1_err"] = _hold_k1(torch, hamming, words, k1_ms_at, by_shape,
                                  3)
    launches["k1_device_ms"] = _k1_report(3, "over the run", by_shape,
                                          k1_ms_at, brackets)[0]
    return launches


def _k1_bound(q: int, k: int):
    return _bound_ms((q + k) * 32 + q * k * 4, q * k * 24)


def _phase4(torch, cam, scene, brackets, k1_ms_at: dict, words) -> dict:
    """Slice 5's main path: RGB-D tracking with the synchronous keyframe
    backend; returns the launches."""
    from plvs_tpu_torch.io import evaluation
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import OK
    from plvs_tpu_torch.utils.profiling import Stopwatch

    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=True, max_lines=160,
                       local_ba=True, loop_closing=False, dense_mapping=False,
                       pipelined=False, depth_upload_decimation=2,
                       backend_fixed_shapes=True)
    system = System(cam, cfg, device="cuda")
    watch = Stopwatch(sync_device=torch.device("cuda"))
    system.set_stopwatch(watch)
    lm = system.local_mapper
    # count the windows that gave a BA problem: each must get one solve
    gathered = []
    gather = lm._gather_ba

    def counting_gather(window):
        packed = gather(window)
        gathered.append(packed is not None)
        return packed

    lm._gather_ba = counting_gather
    frames = list(scene.sequence(n_frames=N_FRAMES))
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states, ms = [], []
    with brackets.run():
        for ts, g, d, _, _ in frames:
            t1 = time.perf_counter()
            state, _, _ = system.track_rgbd(g, d, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    by_shape = brackets.ms_by_shape()
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(est, gt, align=True)
    stats = system.map_statistics()
    n_made = system.store._next_kf_uid
    steady = np.asarray(ms[1:])
    stages = ("lm.cull", "lm.tri_lines", "lm.fuse", "lm.maint", "lm.ba",
              "lm.cull_kf", "local_mapping")
    per_kf = {k: sum(watch.samples.get(k, [])) * 1e3 / max(n_made, 1)
              for k in stages}
    frame_ms = float(np.sum(ms))
    log = lm.ba_log
    print(f"phase 4: {N_FRAMES} frames 640x480 with the keyframe backend, "
          f"per-frame ms p50 {np.percentile(steady, 50):.2f} p90 "
          f"{np.percentile(steady, 90):.2f} (first frame {ms[0]:.1f}; "
          f"keyframe frames include the synchronised backend); map {stats} "
          f"(JAX {REF_LBA_MAP}); keyframes made {n_made}, culled "
          f"{lm.n_culled}; ATE-RMSE {ate:.6f} m (JAX {REF_LBA_ATE_M:.6f} m, "
          f"bound {LBA_ATE_BOUND_M:.6f} m); launches {launches}")
    print("phase 4: backend ms per keyframe (synchronised scopes, "
          f"{n_made} keyframes): "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_kf.items())
          + f"; backend share of the run "
          f"{per_kf['local_mapping'] * n_made / frame_ms:.4f}")
    print(f"phase 4: {len(log)} local BA solves for {sum(gathered)} windows "
          f"with a problem ({len(gathered)} windows): LM iterations "
          f"{[b['lm_iters'] for b in log]}, CG iterations "
          f"{[b['cg_iters'] for b in log]}, cameras "
          f"{[len(b['window']) for b in log]}, cost0 -> cost "
          + ", ".join(f"{b['cost0']:.1f} -> {b['cost']:.1f}" for b in log))
    print("phase 4: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    launches["k1_err"] = _hold_k1(torch, hamming, words, k1_ms_at, mix, 4)
    launches["k1_device_ms"] = _k1_report(4, "over the run", by_shape,
                                          k1_ms_at, brackets)[0]
    backend = {s_: n for s_, n in mix.items()
               if s_ not in K1_MIX_SHAPES}
    _k1_report(4, "at the backend's shapes", {
        s_: v for s_, v in by_shape.items() if s_ in backend}, k1_ms_at)
    if not all(s_ == OK for s_ in states[1:]):
        _fail(f"phase 4 tracking states {states}")
    if not np.isfinite(est).all() or ate > LBA_ATE_BOUND_M:
        _fail(f"phase 4 ATE {ate} m exceeds the bound {LBA_ATE_BOUND_M} m")
    for key, ref in REF_LBA_MAP.items():
        if abs(stats[key] - ref) > 0.25 * ref:
            _fail(f"phase 4 live {key} {stats[key]} not within 25% of "
                  f"JAX's {ref}")
    if len(log) != sum(gathered) or not log:
        _fail(f"phase 4: {len(log)} solves for {sum(gathered)} problems")
    for b in log:
        if not (np.isfinite(b["cost"]) and b["cost"] <= b["cost0"]):
            _fail(f"phase 4 local BA diverged: {b}")
    if launches["hamming"] < 2 * (N_FRAMES - 1) or not backend:
        _fail(f"K1 launched {launches['hamming']} times in phase 4, "
              f"{sum(backend.values())} at the backend's shapes")
    if launches["cc_labels"] < N_FRAMES:
        _fail(f"K2 launched {launches['cc_labels']} times in phase 4")
    return launches


def _hold_k1(torch, hamming, words, k1_ms_at: dict, shapes, phase: int):
    """K1 against its plain version, and its device time, at each (Q, K)
    of ``shapes`` not held yet (random words); returns the largest error."""
    err = 0
    for q, k in sorted(set(shapes) - k1_ms_at.keys()):
        a, b = words(q), words(k)
        got = hamming.hamming_matrix(a, b)
        ref = hamming.hamming_plain(a, b)
        torch.cuda.synchronize()
        e = int((got - ref).abs().max()) if got.numel() else 0
        err = max(err, e)
        k1_ms_at[(q, k)] = ms = _time_ms(
            torch, lambda: hamming.hamming_matrix(a, b))
        print(f"phase {phase}: K1 at {q}x{k} (a phase-{phase} shape): "
              f"max_abs_err {e}, kernel {ms:.6f} ms (bound "
              f"{_k1_bound(q, k)[0]:.6f} ms)")
        if e:
            _fail(f"K1 disagrees with its plain version at {q}x{k}")
    return err


def _k1_inside(brackets, obj, name: str) -> list:
    """Wrap method ``name`` of ``obj`` so the indices, in the run's
    brackets, of the K1 launches made inside it accumulate in the returned
    list."""
    inside = []
    fn = getattr(obj, name)

    def counting(*a, **kw):
        first = len(brackets.pairs)
        try:
            return fn(*a, **kw)
        finally:
            inside.extend(range(first, len(brackets.pairs)))

    setattr(obj, name, counting)
    return inside


def _phase5(torch, cam, brackets, k1_ms_at: dict, words) -> dict:
    """Slice 6's loop-closure path: RGB-D tracking with local BA, loop
    closing and dense mapping over the room orbit; returns the launches,
    K1's launches by shape and the largest K1 error at new shapes."""
    from plvs_tpu_torch.dense import meshing
    from plvs_tpu_torch.io import evaluation, synthetic
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import OK
    from plvs_tpu_torch.utils.profiling import Stopwatch

    cfg = SystemConfig(num_features=1024, n_levels=8, max_kf=128,
                       max_pts=65536, use_lines=False, local_ba=True,
                       loop_closing=True, dense_mapping=True,
                       dense_voxel_size=0.02)
    system = System(cam, cfg, device="cuda")
    watch = Stopwatch(sync_device=torch.device("cuda"))
    system.set_stopwatch(watch)
    dm = system.dense_mapper
    after_rebuild = []
    lc_idx = _k1_inside(brackets, system.loop_closer, "process_keyframe")
    frames = _room_frames(cam, synthetic)
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states, ms = [], []
    with brackets.run():
        for ts, g, d, _, _ in frames:
            t1 = time.perf_counter()
            state, _, _ = system.track_rgbd(g, d, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
            # the dense map right after a frame that closed a loop (and so
            # rebuilt it), counted outside the frame's timed scopes
            if len(after_rebuild) < len(system.loops_closed):
                _, faces = meshing.marching_tetrahedra(dm.volume)
                after_rebuild.append({"occupied": len(dm.cloud()[0]),
                                      "triangles": len(faces),
                                      "keyframes": len(dm.keyframes)})
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    by_shape = brackets.ms_by_shape()
    lc_by_shape = brackets.ms_by_shape(lc_idx)
    n_rebuilds = len(watch.samples.get("dense.rebuild", []))
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(est, gt, align=True)
    stats = system.map_statistics()
    n_made = system.store._next_kf_uid
    loops = system.loops_closed
    steady = np.asarray(ms[1:])
    print(f"phase 5: {N_LOOP_FRAMES} frames 640x480 of the room orbit with "
          f"local BA, loop closing and dense mapping, per-frame ms p50 "
          f"{np.percentile(steady, 50):.2f} p90 "
          f"{np.percentile(steady, 90):.2f} max {steady.max():.2f} (first "
          f"frame {ms[0]:.1f}); map {stats} (JAX {REF_LOOP_MAP}); keyframes "
          f"made {n_made}; ATE-RMSE {ate:.6f} m (JAX {REF_LOOP_ATE_M:.6f} m, "
          f"bound {LOOP_ATE_BOUND_M:.6f} m); launches {launches}")
    for kf, info in loops:
        gba = info.get("global_ba") or {}
        print(f"phase 5: loop at keyframe {kf} (JAX {REF_LOOP_KF}) against "
              f"{info['candidate']}: {info['inliers']} inliers, "
              f"{info['n_fused']} points fused, pose graph over "
              f"{info['n_kf']} keyframes cost {info['cost0']:.6f} -> "
              f"{info['cost']:.6f} ({info['lm_iters']} LM, "
              f"{info['cg_iters']} CG iterations); global BA cost "
              f"{gba.get('cost0', float('nan')):.3f} -> "
              f"{gba.get('cost', float('nan')):.3f} "
              f"({gba.get('lm_iters')} LM, {gba.get('cg_iters')} CG)")
    per_kf = {k: sum(watch.samples.get(k, [])) * 1e3 / max(n_made, 1)
              for k in ("lc.bow_add", "lc.detect", "lc.verify",
                        "loop_closing", "local_mapping", "dense_mapping")}
    print("phase 5: stage ms per keyframe (synchronised scopes, "
          f"{n_made} keyframes): "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_kf.items()))
    print("phase 5: stage ms per closure (synchronised scopes): "
          + ", ".join(f"{k} {[round(v * 1e3, 2) for v in watch.samples.get(k, [])]}"
                      for k in ("lc.correct", "global_ba", "dense.rebuild")))
    print(f"phase 5: dense map after each rebuild {after_rebuild} (JAX "
          f"{REF_LOOP_DENSE}); at the end {len(dm.cloud()[0])} occupied "
          f"voxels")
    print("phase 5: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 5)
    dev_ms = _k1_report(5, "over the run", by_shape, k1_ms_at, brackets)[0]
    _k1_report(5, "inside the loop closer", lc_by_shape, k1_ms_at)
    if not all(s_ == OK for s_ in states[1:]):
        _fail(f"phase 5 tracking states {states}")
    if not loops:
        _fail("phase 5 closed no loop")
    kf, info = loops[0]
    if info["candidate"] > 2 or abs(kf - REF_LOOP_KF) > 3:
        _fail(f"phase 5 first loop at keyframe {kf} against "
              f"{info['candidate']}; JAX closes {REF_LOOP_KF} against 0")
    for kf, info in loops:
        gba = info.get("global_ba")
        if not info["cost"] < info["cost0"]:
            _fail(f"phase 5 pose graph did not lower its cost: {info}")
        if gba is None or not (np.isfinite(gba["cost"])
                               and gba["cost"] <= gba["cost0"]):
            _fail(f"phase 5 global BA diverged or did not run: {gba}")
    if not np.isfinite(est).all() or ate > LOOP_ATE_BOUND_M:
        _fail(f"phase 5 ATE {ate} m exceeds the bound {LOOP_ATE_BOUND_M} m")
    for key, ref in REF_LOOP_MAP.items():
        if abs(stats[key] - ref) > 0.25 * ref:
            _fail(f"phase 5 live {key} {stats[key]} not within 25% of "
                  f"JAX's {ref}")
    if n_rebuilds != len(loops):
        _fail(f"phase 5: {n_rebuilds} rebuilds for {len(loops)} loops")
    for key, ref in REF_LOOP_DENSE.items():
        got = after_rebuild[0][key]
        if abs(got - ref) > 0.25 * ref:
            _fail(f"phase 5 dense {key} after the rebuild {got} not within "
                  f"25% of JAX's {ref}")
    if launches["hamming"] < 2 * (N_LOOP_FRAMES - 1):
        _fail(f"K1 launched {launches['hamming']} times in phase 5")
    return {"launches": launches, "mix": mix, "k1_err": err,
            "k1_device_ms": dev_ms}


def _phase6(torch, cam, scene, brackets, k1_ms_at: dict, words) -> dict:
    """The relocalization path: phase 2's run with a blackout; returns the
    launches, K1's launches by shape and the largest K1 error at new
    shapes."""
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import OK

    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=True, max_lines=160,
                       local_ba=False, loop_closing=False,
                       dense_mapping=False, pipelined=False,
                       depth_upload_decimation=2)
    system = System(cam, cfg, device="cuda")
    system.tracker.min_kf_recently_lost = RELOC_RECENTLY_LOST_KFS
    reloc_idx = _k1_inside(brackets, system.tracker, "_relocalize")
    frames = list(scene.sequence(n_frames=N_FRAMES))
    a, b = RELOC_BLACKOUT
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states, ms = [], []
    with brackets.run():
        for i, (ts, g, d, _, _) in enumerate(frames):
            if a <= i < b:
                g, d = np.zeros_like(g), np.zeros_like(d)
            t1 = time.perf_counter()
            state, _, _ = system.track_rgbd(g, d, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    by_shape = brackets.ms_by_shape()
    reloc_by_shape = brackets.ms_by_shape(reloc_idx)
    _, R_end, t_end = system.trajectory[-1]
    _, _, _, R_gt, t_gt = frames[-1]
    c_err = float(np.linalg.norm(-R_end.T @ t_end + R_gt.T @ t_gt))
    lost = [i for i, s_ in enumerate(states) if s_ != OK]
    ok_from = next(i for i in range(len(states) + 1)
                   if all(s_ == OK for s_ in states[i:]))
    print(f"phase 6: {N_FRAMES} frames 640x480 with frames {a}-{b - 1} "
          f"blank: states {states[a - 2:ok_from + 2]} from frame {a - 2}; "
          f"not OK on frames {lost} (JAX: state {REF_RELOC_LOST_STATE} on "
          f"{REF_RELOC_FIRST_LOST}-{REF_RELOC_OK_FROM - 1}), OK from "
          f"{ok_from} (JAX {REF_RELOC_OK_FROM}); relocalizing frame "
          f"{ms[ok_from]:.1f} ms, blank frames "
          f"{np.median(ms[a:b]):.1f} ms median; final camera centre "
          f"{c_err:.6f} m from ground truth; map {system.map_statistics()}; "
          f"launches {launches}")
    print("phase 6: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 6)
    dev_ms = _k1_report(6, "over the run", by_shape, k1_ms_at, brackets)[0]
    _k1_report(6, "inside relocalization", reloc_by_shape, k1_ms_at)
    if not lost or abs(lost[0] - REF_RELOC_FIRST_LOST) > 1:
        _fail(f"phase 6 lost on frames {lost}; JAX from "
              f"{REF_RELOC_FIRST_LOST}")
    if any(states[i] != REF_RELOC_LOST_STATE for i in lost):
        _fail(f"phase 6 lost states {[states[i] for i in lost]}; JAX's are "
              f"all {REF_RELOC_LOST_STATE}")
    if ok_from != REF_RELOC_OK_FROM:
        _fail(f"phase 6 OK from frame {ok_from}; JAX {REF_RELOC_OK_FROM}")
    if c_err > 0.1:
        _fail(f"phase 6 final camera centre {c_err} m from ground truth")
    if launches["cc_labels"] < N_FRAMES - (b - a):
        _fail(f"K2 launched {launches['cc_labels']} times in phase 6")
    return {"launches": launches, "mix": mix, "k1_err": err,
            "k1_device_ms": dev_ms}


def _bench_flags(**kw) -> dict:
    """bench.py's SystemConfig (bench.py:60-90, environment defaults)."""
    return dict(dict(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                     max_pts=65536, use_lines=True, max_lines=160,
                     local_ba=True, loop_closing=True, dense_mapping=True,
                     dense_voxel_size=0.02, backend_fixed_shapes=True,
                     pipelined=True, pipeline_depth=4,
                     pipeline_overlap=True, interleaved_backend=True), **kw)


def _room_frames(cam, synthetic):
    """Phase 5's room orbit with its depth noise."""
    room = synthetic.SyntheticRoom(cam, half=3.0, tex_size=2048, seed=3)
    poses = synthetic.orbit_loop_trajectory(N_LOOP_FRAMES, radius=1.0,
                                            laps=1.375)
    frames = []
    for i, (ts, g, d, R, t) in enumerate(room.sequence(poses)):
        rng = np.random.default_rng(1000 + i)
        d = d + rng.normal(0, 0.01, d.shape).astype(np.float32) * d ** 2
        frames.append((ts, g, d, R, t))
    return frames


def _drive_pipelined(torch, system, frames, samples=None) -> dict:
    """Track ``frames`` through ``system.track_rgbd`` on this thread, timing
    each call's return (no device synchronisation: the frame's own host
    reads are all it waits for), then flush. Records the resolved states,
    the frames during which a keyframe was made or a loop closed, and the
    largest backlog of the interleaved backend (counted as the reference
    script counts it). ``samples``: each frame's IMU samples."""
    resolved, backlog = [], [0]
    post, enqueue = system._post_track, system._enqueue_backend

    def recording_post(res, ts, payload=None):
        resolved.append(int(res.state))
        return post(res, ts, payload)

    def recording_enqueue(kf_id, payload=None):
        backlog[0] = max(backlog[0], len(system._backend_q) + 1)
        return enqueue(kf_id, payload)

    system._post_track, system._enqueue_backend = (recording_post,
                                                   recording_enqueue)
    ms, kf_frame, loop_frame = [], [], []
    n_kf, n_loops = system.store._next_kf_uid, len(system.loops_closed)
    init_kf = None
    for i, (ts, g, d, _, _) in enumerate(frames):
        imu = None if samples is None else samples[i]
        t1 = time.perf_counter()
        system.track_rgbd(g, d, ts, imu_samples=imu)
        ms.append((time.perf_counter() - t1) * 1e3)
        if (init_kf is None and system.inertial is not None
                and system.inertial.initialized):
            init_kf = system.store._next_kf_uid
        kf_frame.append(system.store._next_kf_uid > n_kf)
        loop_frame.append(len(system.loops_closed) > n_loops)
        n_kf, n_loops = system.store._next_kf_uid, len(system.loops_closed)
    t1 = time.perf_counter()
    system.flush()
    torch.cuda.synchronize()
    flush_ms = (time.perf_counter() - t1) * 1e3
    if (init_kf is None and system.inertial is not None
            and system.inertial.initialized):
        init_kf = system.store._next_kf_uid
    return {"ms": np.asarray(ms), "kf_frame": np.asarray(kf_frame),
            "loop_frame": np.asarray(loop_frame), "resolved": resolved,
            "max_backlog": backlog[0], "flush_ms": flush_ms,
            "init_kf": init_kf}


def _hold_run(phase: int, system, frames, ref_ate, ate_bound) -> dict:
    """The pipelined phases' shared checks: every frame resolved, every
    queue empty after the flush, the ATE bound; returns the ATE, the live
    map and the dense map."""
    from plvs_tpu_torch.io import evaluation

    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(est, gt, align=True)
    stats = system.map_statistics()
    dm = system.dense_mapper
    dense = ({} if dm is None else
             {"occupied": len(dm.cloud()[0]), "triangles": len(dm.mesh()[1])})
    queues = {"pending": len(system.tracker._pending),
              "inflight": len(system.tracker._inflight),
              "backend": len(system._backend_q)}
    print(f"phase {phase}: resolved {len(system.trajectory)} of "
          f"{len(frames)} frames; map {stats}; keyframes made "
          f"{system.store._next_kf_uid}; ATE-RMSE {ate:.6f} m (JAX "
          f"{ref_ate:.6f} m, bound {ate_bound:.6f} m); dense {dense}; queues "
          f"after flush {queues}")
    if len(system.trajectory) != len(frames):
        _fail(f"phase {phase} resolved {len(system.trajectory)} of "
              f"{len(frames)} frames")
    if any(queues.values()):
        _fail(f"phase {phase} queues not empty after flush: {queues}")
    if not np.isfinite(est).all() or ate > ate_bound:
        _fail(f"phase {phase} ATE {ate} m exceeds the bound {ate_bound} m")
    return {"ate": ate, "map": stats, "dense": dense}


def _phase7(torch, cam, scene, brackets, k1_ms_at: dict, words) -> dict:
    """Item 4's main path: bench.py's configuration (pipelined at depth 4
    with the overlap thread and the interleaved backend) over phase 2's
    scene; returns the launches, K1's device ms over the run and the
    largest K1 error at new shapes."""
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam import frame as frame_mod

    system = System(cam, SystemConfig(**_bench_flags()), device="cuda")
    system.tracker.timing = []     # (fetch wait s, finish s, frames) a group
    frames = list(scene.sequence(n_frames=N_FRAMES))
    line_frames = []
    build_lines = frame_mod.build_frame_lines

    def counting_build_lines(*a, **kw):
        line_frames.append(1)
        return build_lines(*a, **kw)

    frame_mod.build_frame_lines = counting_build_lines
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    try:
        with brackets.run():
            run = _drive_pipelined(torch, system, frames)
    finally:
        frame_mod.build_frame_lines = build_lines
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    by_shape = brackets.ms_by_shape()
    ms = run["ms"][1:]
    resolve = np.asarray(system.stopwatch.samples.get("resolve", [])) * 1e3
    groups = np.asarray(system.tracker.timing).reshape(-1, 3)
    print(f"phase 7: bench.py's configuration, {N_FRAMES} frames 640x480 "
          f"(pipelined, depth 4, overlap thread, interleaved backend): "
          f"track_rgbd's return on the tracking thread p50 "
          f"{np.percentile(ms, 50):.2f} ms p90 {np.percentile(ms, 90):.2f} "
          f"max {ms.max():.2f} (first frame {run['ms'][0]:.1f}); resolve "
          f"{resolve.sum():.2f} ms in {len(resolve)} calls (median "
          f"{np.median(resolve) if len(resolve) else 0.0:.3f}; "
          f"{len(groups)} groups of {groups[:, 2].mean():.2f} frames, fetch "
          f"waits {groups[:, 0].sum() * 1e3:.2f} ms, finishes "
          f"{groups[:, 1].sum() * 1e3:.2f} ms); flush "
          f"{run['flush_ms']:.2f} ms; _stage_stats {system._stage_stats}; "
          f"largest backlog {run['max_backlog']}; launches {launches}, "
          f"{len(line_frames)} line frames built (K1 brackets' spins inside "
          "the run)")
    out = _hold_run(7, system, frames, REF_BENCH_ATE_M, BENCH_ATE_BOUND_M)
    print(f"phase 7: JAX: map {REF_BENCH_MAP}, dense {REF_BENCH_DENSE}")
    lost = [i for i, s_ in enumerate(run["resolved"]) if i and s_ != 2]
    if lost:
        _fail(f"phase 7: frames {lost} not OK at resolution")
    got = {**out["map"], **out["dense"]}
    for key, ref in {**REF_BENCH_MAP, **REF_BENCH_DENSE}.items():
        if abs(got[key] - ref) > 0.25 * ref:
            _fail(f"phase 7 {key} {got[key]} not within 25% of JAX's {ref}")
    print("phase 7: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 7)
    dev_ms = _k1_report(7, "over the run", by_shape, k1_ms_at, brackets)[0]
    if launches["cc_labels"] != len(line_frames):
        _fail(f"K2 launched {launches['cc_labels']} times for "
              f"{len(line_frames)} line frames in phase 7")
    if launches["hamming"] < 2 * (N_FRAMES - 1):
        _fail(f"K1 launched {launches['hamming']} times in phase 7")
    system.shutdown()
    return {"launches": launches, "mix": mix, "k1_err": err,
            "k1_device_ms": dev_ms, **out}


def _phase8(torch, cam, scene, k1_ms_at: dict, words) -> dict:
    """bench.py's PLVS_BENCH_ASYNC=1 path: phase 7's configuration with the
    mapper actor over phase 2's scene; returns the launches and the largest
    K1 error at new shapes. K1 launches go unbracketed: the actor launches
    on the same stream from its own thread, so a bracket could hold its
    kernels."""
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig

    system = System(cam, SystemConfig(**_bench_flags(async_mapping=True)),
                    device="cuda")
    frames = list(scene.sequence(n_frames=N_FRAMES))
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    run = _drive_pipelined(torch, system, frames)
    idle = system.actor.wait_idle(300.0)
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    ms, kf = run["ms"][1:], run["kf_frame"][1:]
    loops = system.loops_closed
    closing = [float(m) for m, c in zip(run["ms"], run["loop_frame"]) if c]
    print(f"phase 8: bench.py's configuration with async_mapping, "
          f"{len(frames)} frames 640x480: "
          f"track_rgbd's return on the tracking thread, keyframe frames "
          f"({int(kf.sum())}) p50 {np.percentile(ms[kf], 50):.2f} ms p90 "
          f"{np.percentile(ms[kf], 90):.2f}, other frames p50 "
          f"{np.percentile(ms[~kf], 50):.2f} p90 "
          f"{np.percentile(ms[~kf], 90):.2f}, max {ms.max():.2f} (first "
          f"frame {run['ms'][0]:.1f}); frames during which a loop closed "
          f"(ms): {closing}; flush {run['flush_ms']:.2f} ms; launches "
          f"{launches}")
    for kf_id, info in loops:
        gba = info.get("global_ba") or {}
        print(f"phase 8: loop at keyframe {kf_id} against "
              f"{info['candidate']}: {info['inliers']} inliers, pose graph "
              f"cost {info['cost0']:.6f} -> {info['cost']:.6f}; global BA "
              f"{gba.get('cost0', float('nan')):.3f} -> "
              f"{gba.get('cost', float('nan')):.3f}")
    out = _hold_run(8, system, frames, REF_ASYNC_ATE_M, ASYNC_ATE_BOUND_M)
    print(f"phase 8: JAX's medians: map {REF_ASYNC_MAP}, dense "
          f"{REF_ASYNC_DENSE}")
    lost = [i for i, s_ in enumerate(run["resolved"]) if i and s_ != 2]
    if lost:
        _fail(f"phase 8: frames {lost} not OK at resolution")
    got = {**out["map"], **out["dense"]}
    for key, ref in {**REF_ASYNC_MAP, **REF_ASYNC_DENSE}.items():
        if abs(got[key] - ref) > 0.25 * ref:
            _fail(f"phase 8 {key} {got[key]} not within 25% of JAX's {ref}")
    print("phase 8: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 8)
    if not idle:
        _fail("phase 8: the mapper actor did not go idle")
    actor = system.actor
    error = actor._error
    system.shutdown()
    if error is not None:
        _fail(f"phase 8: the mapper actor failed: {error!r}")
    if actor.thread.is_alive():
        _fail("phase 8: shutdown() did not join the actor's thread")
    if launches["hamming"] < 2 * (len(frames) - 1):
        _fail(f"K1 launched {launches['hamming']} times in phase 8")
    return {"launches": launches, "mix": mix, "k1_err": err, **out}


def _synced(torch, obj, name: str, log: list):
    """Wrap method ``name`` of ``obj``: each call's wall ms between two
    device synchronisations is appended to ``log`` with its result."""
    fn = getattr(obj, name)

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        log.append(((time.perf_counter() - t1) * 1e3, out))
        return out

    setattr(obj, name, timed)


def _count_ops(torch, fn) -> int:
    """Non-view PyTorch operations ``fn`` dispatches (about one kernel
    launch each on the card)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.is_view
            return func(*args, **(kwargs or {}))

    c = Count()
    with c:
        fn()
    return c.n


def _phase9(torch, cam, k1_ms_at: dict, words) -> dict:
    """Slice 8's path: bench.py's RGB-D-inertial scenario — 640x480, 1024
    features, 8 levels, no lines, local BA, use_imu, pipelined at depth 2
    with the overlap thread, fixed BA shapes, a keyframe at least every 4
    frames — over the first N_VI_FRAMES of bench.py's timed pass (seed 1),
    then flush(); returns the launches and the largest K1 error at new shapes.
    K1 launches go unbracketed, so track_rgbd's times are the run's own."""
    from plvs_tpu_torch.io import synthetic
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig

    system = System(cam, SystemConfig(
        num_features=1024, n_levels=8, scale=1.2, max_kf=128,
        max_pts=65536, use_lines=False, local_ba=True, loop_closing=False,
        use_imu=True, pipelined=True, pipeline_depth=2,
        pipeline_overlap=True, backend_fixed_shapes=True,
        max_kf_interval=4), device="cuda")
    scene = synthetic.inertial_scene(cam, 1)
    seq = synthetic.inertial_sequence(n_frames=N_VI_FRAMES, seed=1)
    frames = [(ts, *scene.render(R, t), R, t) for ts, R, t, _ in seq]
    samples = [s for *_, s in seq]
    iner = system.inertial
    gaps, inits, vis = [], [], []
    _synced(torch, iner, "preintegrate_frame_gap", gaps)
    _synced(torch, iner, "_try_initialize", inits)
    _synced(torch, iner, "vi_local_ba", vis)
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    t0 = time.perf_counter()
    run = _drive_pipelined(torch, system, frames, samples)
    wall = time.perf_counter() - t0
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    ms = run["ms"][1:]
    gap_ms = np.asarray([m for m, p in gaps if p is not None])
    # one frame gap's preintegration counted on the card, after the run
    t_a, t_b = seq[-2][0], seq[-1][0]
    iner.samples = [x for f in seq[-2:] for x in f[3]]
    gap_ops = _count_ops(torch, lambda: iner.preintegrate_frame_gap(t_a, t_b))
    g_true = np.array([0.3, 9.7, -0.4])
    g_true = g_true / np.linalg.norm(g_true)
    g = iner.gravity
    cos = (float(np.dot(g, g_true) / np.linalg.norm(g)) if g is not None
           else float("nan"))
    bg_err = float(np.linalg.norm(iner.bias_gyro
                                  - np.array([0.002, -0.001, 0.001])))
    log = iner.vi_ba_log
    vi_ms = np.asarray([m for m, _ in vis])
    print(f"phase 9: bench.py's RGB-D-inertial configuration, "
          f"{N_VI_FRAMES} frames 640x480 with a 300 Hz IMU (pipelined, depth "
          f"2, overlap thread, local BA, no lines): track_rgbd's return on "
          f"the tracking thread p50 {np.percentile(ms, 50):.2f} ms p90 "
          f"{np.percentile(ms, 90):.2f} max {ms.max():.2f} (first frame "
          f"{run['ms'][0]:.1f}), i.e. {1e3 / np.percentile(ms, 50):.2f} "
          f"frames/s at p50 and {1e3 / np.percentile(ms, 90):.2f} at p90; "
          f"the pass {len(frames) / wall:.2f} frames/s ({wall:.2f} s with "
          f"the flush, bench.py's vi_fps measure); flush "
          f"{run['flush_ms']:.2f} ms; launches {launches}")
    print(f"phase 9: frame-gap preintegration (synchronised) median "
          f"{np.median(gap_ms):.3f} ms p90 {np.percentile(gap_ms, 90):.3f} "
          f"over {len(gap_ms)} gaps, {gap_ops} dispatched non-view "
          f"operations for one 10-sample gap; inertial-only init / refine "
          f"solves {[round(m, 2) for m, _ in inits]} ms")
    print(f"phase 9: VI BA per keyframe (synchronised) median "
          f"{np.median(vi_ms) if len(vi_ms) else float('nan'):.2f} ms over "
          f"{len(vi_ms)} calls, {len(log)} solves; LM / CG iterations "
          f"{[(e['lm_iters'], e['cg_iters']) for e in log]}; cost "
          f"{[(round(e['cost0'], 1), round(e['cost'], 1)) for e in log]}")
    print(f"phase 9: IMU initialized at keyframe {run['init_kf']} (JAX "
          f"{REF_VI['init_keyframe']}); gravity {np.round(g, 4).tolist() if g is not None else None} "
          f"cosine to the truth {cos:.5f} (JAX {REF_VI['gravity_cos']:.5f}); "
          f"gyro bias {np.round(iner.bias_gyro, 6).tolist()}, "
          f"{bg_err:.6f} from the truth (JAX {REF_VI['bias_gyro_err']:.6f})")
    out = _hold_run(9, system, frames, REF_VI["ate_rmse_m"], VI_ATE_BOUND_M)
    print(f"phase 9: JAX: map {REF_VI['map']}, {REF_VI['vi_ba_ok']} VI BA "
          f"solves, ATE {REF_VI['ate_rmse_m']:.6f} m")
    lost = [i for i, s_ in enumerate(run["resolved"]) if i and s_ != 2]
    if lost:
        _fail(f"phase 9: frames {lost} not OK at resolution")
    if run["init_kf"] is None or abs(run["init_kf"]
                                     - REF_VI["init_keyframe"]) > 2:
        _fail(f"phase 9: the IMU initialized at keyframe {run['init_kf']}; "
              f"JAX at {REF_VI['init_keyframe']}")
    if not cos > 0.98:
        _fail(f"phase 9: gravity cosine {cos} to the truth")
    if not bg_err < 5e-3:
        _fail(f"phase 9: gyro bias {bg_err} from the truth")
    for key in ("keyframes", "points"):
        ref = REF_VI["map"][key]
        if abs(out["map"][key] - ref) > 0.25 * ref:
            _fail(f"phase 9 {key} {out['map'][key]} not within 25% of "
                  f"JAX's {ref}")
    if not vis or len(log) != len(vis) or not all(
            ok and np.isfinite(e["cost"]) for (_, ok), e in zip(vis, log)):
        _fail(f"phase 9: VI BA calls {[ok for _, ok in vis]}, solves {log}")
    print("phase 9: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 9)
    if launches["hamming"] < 2 * (len(frames) - 1):
        _fail(f"K1 launched {launches['hamming']} times in phase 9")
    system.shutdown()
    return {"launches": launches, "mix": mix, "k1_err": err,
            "init_kf": run["init_kf"], **out}


def _rig_frames(synthetic, cameras, n: int):
    """Phases 10-11's scene: phase 2's wall, and the first n of its path's
    poses spread over RIG_PATH_POSES frames, seen through the KB8 fisheye
    pair at 640x480; returns (cam_l, cam_r, T_c1_c2, rig, frames
    [(ts, left, right, R, t)])."""
    size = dict(width=640, height=480)
    cam_l = cameras.kannala_brandt8(*synthetic.RIG_KB8_LEFT, **size)
    cam_r = cameras.kannala_brandt8(*synthetic.RIG_KB8_RIGHT, **size)
    T = synthetic.rig_extrinsic()
    rig = synthetic.SyntheticRig(
        cam_l, cam_r, T, wall_z=WALL_Z, texture=synthetic.make_structured_texture(
            2048, rng=np.random.default_rng(7)), tex_scale=420.0)
    poses = synthetic.default_trajectory(RIG_PATH_POSES)[:n]
    return cam_l, cam_r, T, rig, list(rig.sequence(poses))


def _rig_flags(**kw) -> dict:
    """Phases 10-11's SystemConfig: stereo, local BA with fixed BA shapes,
    no loop closing, no lines, synchronous."""
    return dict(dict(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                     max_pts=65536, use_lines=False, sensor="stereo",
                     local_ba=True, loop_closing=False,
                     backend_fixed_shapes=True, max_kf_interval=5,
                     pipelined=False), **kw)


def _track_stereo_run(torch, system, frames, brackets) -> dict:
    """Track ``frames`` synchronously with K1 bracketed; returns the states,
    the per-frame ms (synchronised), the launches, K1's launches by shape
    and their bracketed device ms by shape."""
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo

    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states, ms = [], []
    with brackets.run():
        for ts, gl, gr, _, _ in frames:
            t1 = time.perf_counter()
            state, _, _ = system.track_stereo(gl, gr, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
    return {"states": states, "ms": np.asarray(ms),
            "launches": {"hamming": hamming.launches,
                         "cc_labels": cc_labels.launches,
                         "stereo_wta": stereo.launches},
            "mix": dict(hamming.shapes), "by_shape": brackets.ms_by_shape()}


def _phase10(torch, brackets, k1_ms_at: dict, words) -> dict:
    """Slice 9's rig path: the non-rectified KB8 fisheye pair through
    ``System.track_stereo`` (``cam2`` / ``T_c1_c2``); returns the launches,
    K1's device ms over the run and the largest K1 error."""
    from plvs_tpu_torch.features import orb
    from plvs_tpu_torch.geometry import cameras
    from plvs_tpu_torch.io import evaluation, synthetic
    from plvs_tpu_torch.ops import hamming
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam import frame as frame_mod
    from plvs_tpu_torch.slam.tracking import OK

    dev = torch.device("cuda")
    cam_l, cam_r, T, rig, frames = _rig_frames(synthetic, cameras,
                                               N_RIG_FRAMES)
    R_lr = torch.from_numpy(T[:3, :3].copy()).to(dev)
    t_lr = torch.from_numpy(T[:3, 3].copy()).to(dev)
    # the first frame against the rendered depth (tests/test_stereo_rig.py's
    # gates), and K1 exact on its left x right descriptors
    gl0, gr0, depth0 = rig.render(frames[0][3], frames[0][4])
    gl_d, gr_d = torch.from_numpy(gl0).to(dev), torch.from_numpy(gr0).to(dev)
    fr = frame_mod.build_frame_stereo_rig(gl_d, gr_d, cam_l, cam_r, R_lr,
                                          t_lr, 1024, 8, 1.2)
    d = fr.depth.cpu().numpy()
    xy = fr.kp.xy.cpu().numpy()
    ok = d > 0
    xi = np.clip(np.round(xy[ok, 0]).astype(int), 0, 639)
    yi = np.clip(np.round(xy[ok, 1]).astype(int), 0, 479)
    rel = (d[ok] - depth0[yi, xi]) / depth0[yi, xi]
    kp_l = orb.extract(gl_d, 1024, 8, 1.2)
    kp_r = orb.extract(gr_d, 1024, 8, 1.2)
    got = hamming.hamming_matrix(kp_l.desc, kp_r.desc)
    ref = hamming.hamming_plain(kp_l.desc, kp_r.desc)
    torch.cuda.synchronize()
    desc_err = int((got - ref).abs().max())
    print(f"phase 10: first frame: {int(ok.sum())} triangulated matches, "
          f"median relative depth error {np.median(rel):.6f}, median |error| "
          f"{np.median(np.abs(rel)):.6f} (JAX {REF_RIG['first_frame']}); K1 "
          f"on its {tuple(got.shape)} left x right descriptors: max_abs_err "
          f"{desc_err}")

    system = System(cam_l, SystemConfig(**_rig_flags()), device="cuda",
                    cam2=cam_r, T_c1_c2=T)
    run = _track_stereo_run(torch, system, frames, brackets)
    launches, mix = run["launches"], run["mix"]
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(est, gt, align=True)
    stats = system.map_statistics()
    steady = run["ms"][1:]
    print(f"phase 10: {N_RIG_FRAMES} KB8 rig pairs 640x480 (local BA, fixed "
          f"BA shapes), per-frame ms p50 {np.percentile(steady, 50):.2f} p90 "
          f"{np.percentile(steady, 90):.2f} (first frame {run['ms'][0]:.1f}; "
          f"keyframe frames include the synchronised backend); map {stats}, "
          f"keyframes made {system.store._next_kf_uid} (JAX {REF_RIG['map']}, "
          f"{REF_RIG['keyframes_made']} made); ATE-RMSE {ate:.6f} m (JAX "
          f"{REF_RIG['ate_rmse_m']:.6f} m, bound {RIG_ATE_BOUND_M:.6f} m); "
          f"launches {launches}")
    print("phase 10: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    err = max(desc_err, _hold_k1(torch, hamming, words, k1_ms_at, mix, 10))
    dev_ms = _k1_report(10, "over the run", run["by_shape"], k1_ms_at,
                        brackets)[0]
    if not all(s_ == OK for s_ in run["states"][1:]):
        _fail(f"phase 10 tracking states {run['states']}")
    if not np.isfinite(est).all() or ate > RIG_ATE_BOUND_M:
        _fail(f"phase 10 ATE {ate} m exceeds the bound {RIG_ATE_BOUND_M} m")
    for key in ("keyframes", "points"):
        if abs(stats[key] - REF_RIG["map"][key]) > 0.25 * REF_RIG["map"][key]:
            _fail(f"phase 10 live {key} {stats[key]} not within 25% of "
                  f"JAX's {REF_RIG['map'][key]}")
    if not (ok.sum() >= 100 and abs(np.median(rel)) < 0.02
            and np.median(np.abs(rel)) < 0.08):
        _fail(f"phase 10 first frame: {ok.sum()} matches, median relative "
              f"error {np.median(rel)}, median |error| "
              f"{np.median(np.abs(rel))}")
    if mix.get((1024, 1024), 0) < len(frames) or desc_err:
        _fail(f"phase 10: K1 at 1024x1024 launched {mix.get((1024, 1024))} "
              f"times in {len(frames)} frames, error {desc_err}")
    return {"launches": launches, "mix": mix, "k1_err": err,
            "k1_device_ms": dev_ms}


def _phase11(torch, brackets, k1_ms_at: dict, words) -> dict:
    """Slice 9's rectified path: the same rig with ``rectify=True`` and 2 cm
    dense mapping, then SGM on the first rectified pair; returns the
    launches, K1's device ms and the SGM figures."""
    from plvs_tpu_torch.dense import stereo_depth
    from plvs_tpu_torch.geometry import cameras
    from plvs_tpu_torch.io import evaluation, synthetic
    from plvs_tpu_torch.ops import hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import OK
    from plvs_tpu_torch.utils.profiling import Stopwatch

    cam_l, cam_r, T, rig, frames = _rig_frames(synthetic, cameras,
                                               N_RECT_FRAMES)
    system = System(cam_l, SystemConfig(**_rig_flags(
        rectify=True, dense_mapping=True, dense_voxel_size=0.02)),
        device="cuda", cam2=cam_r, T_c1_c2=T)
    watch = Stopwatch(sync_device=torch.device("cuda"))
    system.set_stopwatch(watch)
    run = _track_stereo_run(torch, system, frames, brackets)
    launches, mix = run["launches"], run["mix"]
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(est, gt, align=True)
    stats = system.map_statistics()
    n_made = system.store._next_kf_uid
    dm = system.dense_mapper
    pts, _ = dm.cloud()
    med_dz = float(np.median(np.abs(pts[:, 2] - WALL_Z))) if len(pts) else 1e9
    n_tri = len(dm.mesh()[1])
    steady = run["ms"][1:]
    per_kf = {k: sum(v) * 1e3 / max(n_made, 1)
              for k, v in sorted(watch.samples.items())
              if k.startswith("dense")}
    print(f"phase 11: {N_RECT_FRAMES} rig pairs rectified to a {system.cam.fx}"
          f" px pinhole (bf {system.cam.bf:.4f}) with 2 cm dense mapping, "
          f"per-frame ms p50 {np.percentile(steady, 50):.2f} p90 "
          f"{np.percentile(steady, 90):.2f} (first frame {run['ms'][0]:.1f});"
          f" map {stats}, keyframes made {n_made} (JAX {REF_RECT['map']}); "
          f"ATE-RMSE {ate:.6f} m (JAX {REF_RECT['ate_rmse_m']:.6f} m, bound "
          f"{RECT_ATE_BOUND_M:.6f} m); launches {launches}")
    print("phase 11: dense stage ms per keyframe "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_kf.items())
          + f"; {len(pts)} occupied voxels (JAX {REF_RECT['occupied_voxels']}),"
          f" {n_tri} mesh triangles (JAX {REF_RECT['mesh_triangles_full']}), "
          f"median |z - {WALL_Z}| {med_dz:.6f} m (JAX "
          f"{REF_RECT['median_abs_dz_m']:.6f})")
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 11)
    dev_ms = _k1_report(11, "over the run", run["by_shape"], k1_ms_at,
                        brackets)[0]
    if not all(s_ == OK for s_ in run["states"][1:]):
        _fail(f"phase 11 tracking states {run['states']}")
    if not np.isfinite(est).all() or ate > RECT_ATE_BOUND_M:
        _fail(f"phase 11 ATE {ate} m exceeds the bound {RECT_ATE_BOUND_M} m")
    if launches["stereo_wta"] != n_made:
        _fail(f"K3 launched {launches['stereo_wta']} times for {n_made} "
              "keyframes in phase 11")
    for name, got, ref in (("occupied voxels", len(pts),
                            REF_RECT["occupied_voxels"]),
                           ("mesh triangles", n_tri,
                            REF_RECT["mesh_triangles_full"])):
        if abs(got - ref) > 0.25 * ref:
            _fail(f"phase 11 {name} {got} not within 25% of JAX's {ref}")
    if med_dz > REF_RECT["median_abs_dz_m"] + 0.02:
        _fail(f"phase 11 median |z - {WALL_Z}| {med_dz} m: the wall is off")

    # SGM on the first rectified pair: plain PyTorch on the card, never K3
    rl, rr = system.rectifier(frames[0][1], frames[0][2])
    stereo.launches = 0
    stereo_depth.disparity(rl, rr, max_disp=64, method="sgm")   # warm-up
    torch.cuda.synchronize()
    sgm_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        disp = stereo_depth.disparity(rl, rr, max_disp=64, method="sgm")
        torch.cuda.synchronize()
        sgm_ms.append((time.perf_counter() - t1) * 1e3)
    sgm_ops = _count_ops(torch, lambda: stereo_depth.disparity(
        rl, rr, max_disp=64, method="sgm"))
    valid = (disp > 0).cpu().numpy()
    depth = stereo_depth.disparity_to_depth(disp, system.cam.bf).cpu().numpy()
    share = float(valid.mean())
    dz = float(np.median(np.abs(depth[valid] - WALL_Z)))
    ref_sgm = REF_RECT["sgm_first_pair"]
    print(f"phase 11: SGM (method='sgm', D = 64) on the first rectified "
          f"pair: valid share {share:.6f} (JAX {ref_sgm['valid_share']:.6f}),"
          f" median |depth - {WALL_Z}| {dz:.6f} m (JAX "
          f"{ref_sgm['median_abs_depth_err_m']:.6f}); {np.median(sgm_ms):.2f}"
          f" ms a call (median of 3, synchronised), {sgm_ops} dispatched "
          f"non-view operations; K3 launched {stereo.launches} times by it")
    if stereo.launches:
        _fail("SGM launched K3")
    if abs(share - ref_sgm["valid_share"]) > 0.01:
        _fail(f"phase 11 SGM valid share {share} against JAX's "
              f"{ref_sgm['valid_share']}")
    if dz > ref_sgm["median_abs_depth_err_m"] + 0.005:
        _fail(f"phase 11 SGM median |depth - {WALL_Z}| {dz} m against JAX's "
              f"{ref_sgm['median_abs_depth_err_m']}")
    return {"launches": launches, "mix": mix, "k1_err": err,
            "k1_device_ms": dev_ms, "sgm_ms": float(np.median(sgm_ms)),
            "sgm_ops": sgm_ops}


def _carve_counter(vol, log: list):
    """Wrap ``vol.remove_unstable`` so each call appends the voxels it
    cleared (weights that went to 0) to ``log``."""
    carve = vol.remove_unstable

    def counted(*a, **kw):
        before = int((vol.weight > 0).sum())
        carve(*a, **kw)
        log.append(before - int((vol.weight > 0).sum()))

    vol.remove_unstable = counted


def _phase12(torch, cam, k1_ms_at: dict, words) -> dict:
    """Slice 9's segmentation path: demo_inseg.py's configuration at bench
    width (dense mapping with dense_segmentation, 2 cm voxels, local BA and
    loop closing) over the room orbit, then the dense library on the
    stored keyframes at their final poses: the far field, carving, the
    ESDF and the mesh normals; returns the launches and the new
    operations' figures."""
    from plvs_tpu_torch.dense import esdf, processing
    from plvs_tpu_torch.dense.mapping import DenseMapper
    from plvs_tpu_torch.dense.meshing import marching_tetrahedra
    from plvs_tpu_torch.io import evaluation, synthetic
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import OK

    room = synthetic.SyntheticRoom(cam, half=3.0, tex_size=2048, seed=3)
    poses = synthetic.orbit_loop_trajectory(N_SEG_FRAMES, radius=0.6,
                                            laps=0.5)
    frames = list(room.sequence(poses))
    system = System(cam, SystemConfig(
        num_features=1024, n_levels=8, scale=1.2, max_kf=256, max_pts=65536,
        use_lines=False, local_ba=True, loop_closing=True,
        dense_mapping=True, dense_segmentation=True, dense_voxel_size=0.02,
        pipelined=False), device="cuda")
    seg_log = []
    segment = processing.segment_depth

    def timed_segment(*a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = segment(*a, **kw)
        torch.cuda.synchronize()
        seg_log.append((time.perf_counter() - t1) * 1e3)
        return out

    processing.segment_depth = timed_segment
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states, ms = [], []
    try:
        for ts, g, d, _, _ in frames:
            t1 = time.perf_counter()
            state, _, _ = system.track_rgbd(g, d, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
    finally:
        processing.segment_depth = segment
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(est, gt, align=True)
    stats = system.map_statistics()
    dm = system.dense_mapper
    pts, lab = dm.segment_cloud()
    n_seg = int(len(np.unique(lab[lab > 0])))
    kf0 = dm.keyframes[0]
    seg_ops = _count_ops(torch, lambda: processing.segment_depth(
        cam, processing.filter_depth(kf0.depth)))
    steady = np.asarray(ms[1:])
    print(f"phase 12: {N_SEG_FRAMES} RGB-D frames 640x480 of the room orbit "
          f"with 3D segmentation (local BA, loop closing, 2 cm dense), "
          f"per-frame ms p50 {np.percentile(steady, 50):.2f} p90 "
          f"{np.percentile(steady, 90):.2f} (first frame {ms[0]:.1f}); map "
          f"{stats}, keyframes made {system.store._next_kf_uid}, loops "
          f"{len(system.loops_closed)} (JAX {REF_SEG['map']}, "
          f"{REF_SEG['loops']} loops); ATE-RMSE {ate:.6f} m (JAX "
          f"{REF_SEG['ate_rmse_m']:.6f} m, bound {SEG_ATE_BOUND_M:.6f} m); "
          f"launches {launches}")
    print(f"phase 12: segmentation: {len(pts)} segmented surface voxels "
          f"(JAX {REF_SEG['segmented_voxels']}), {int((lab > 0).sum())} "
          f"labelled at confidence >= 2 (JAX {REF_SEG['labelled_voxels']}), "
          f"{n_seg} segments (JAX {REF_SEG['segments_conf2']}), next global "
          f"id {dm.label_map.next_global} (JAX {REF_SEG['next_global']}); "
          f"segment_depth per keyframe (synchronised) median "
          f"{np.median(seg_log):.2f} ms over {len(seg_log)} keyframes, "
          f"{seg_ops} dispatched non-view operations a call")
    if not all(s_ == OK for s_ in states[REF_SEG["first_ok"]:]):
        _fail(f"phase 12 tracking states {states}")
    if not np.isfinite(est).all() or ate > SEG_ATE_BOUND_M:
        _fail(f"phase 12 ATE {ate} m exceeds the bound {SEG_ATE_BOUND_M} m")
    for name, got, ref in (
            ("segmented voxels", len(pts), REF_SEG["segmented_voxels"]),
            ("segments", n_seg, REF_SEG["segments_conf2"])):
        if abs(got - ref) > 0.25 * ref:
            _fail(f"phase 12 {name} {got} not within 25% of JAX's {ref}")
    if len(seg_log) != len(dm.keyframes):
        _fail(f"phase 12: {len(seg_log)} segmentations for "
              f"{len(dm.keyframes)} dense keyframes")

    # the dense library on the stored keyframes at their final poses
    st = system.store
    final = {k.kf_id: (st.kf_R[k.kf_id].copy(), st.kf_t[k.kf_id].copy())
             for k in dm.keyframes if st.kf_mask[k.kf_id]}
    lib = DenseMapper(cam, voxel_size=0.02, multi_res=True, split_depth=3.0,
                      carve_every=3, fixed_shapes=True, device="cuda")
    carved = []
    _carve_counter(lib.volume, carved)
    _carve_counter(lib.coarse, carved)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for k in dm.keyframes:
        if k.kf_id in final:
            lib.insert_keyframe_rgbd(k.kf_id, k.color, k.depth,
                                     *final[k.kf_id])
    torch.cuda.synchronize()
    lib_ms = (time.perf_counter() - t1) * 1e3
    fine = len(lib.volume.occupied_cloud()[0])
    coarse = len(lib.coarse.occupied_cloud()[0])
    n_tri = len(lib.mesh()[1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    origin, grid, _ = esdf.esdf_from_tsdf(lib.volume)
    torch.cuda.synchronize()
    esdf_ms = (time.perf_counter() - t1) * 1e3
    esdf_ops = _count_ops(torch, lambda: esdf.esdf_from_tsdf(lib.volume))
    q = evaluation.depth_samples(
        [(k.kf_id, k.depth.cpu().numpy()) for k in dm.keyframes], final,
        cam, 1000, 2.9)
    d_q = esdf.query_esdf(origin, grid, lib.volume.voxel_size, q)
    V, _ = marching_tetrahedra(lib.volume)
    V = V[np.random.default_rng(0).choice(len(V), min(len(V), 5000),
                                          replace=False)]
    R0, t0 = poses[0]   # the map is built in the first camera's frame
    cos = np.sum((lib.mesh_normals(V) @ R0)
                 * room.wall_normals((V - t0) @ R0), -1)
    ref_lib = REF_SEG["library"]
    got = {"fine_occupied": fine, "coarse_occupied": coarse,
           "triangles": n_tri, "carved_voxels": int(sum(carved))}
    print(f"phase 12: library on {len(final)} keyframes (multi_res, split "
          f"3 m, carve every 3, fixed shapes): {got} (JAX "
          f"{ {k: ref_lib[k] for k in got} }), inserts {lib_ms:.2f} ms; ESDF "
          f"grid {list(grid.shape)} (JAX {ref_lib['esdf_grid']}) in "
          f"{esdf_ms:.2f} ms (synchronised), {esdf_ops} dispatched non-view "
          f"operations; ESDF at 1000 wall points median {np.median(d_q):.6f}"
          f" m (JAX {ref_lib['esdf_median_m']:.6f}); mesh normals' median "
          f"cosine to the walls {np.median(cos):.6f} (JAX "
          f"{ref_lib['normals_median_cos']:.6f})")
    for key, val in got.items():
        if abs(val - ref_lib[key]) > 0.25 * ref_lib[key]:
            _fail(f"phase 12 library {key} {val} not within 25% of JAX's "
                  f"{ref_lib[key]}")
    if not np.median(d_q) <= lib.volume.voxel_size:
        _fail(f"phase 12 ESDF median {np.median(d_q)} m at wall points")
    if not np.median(cos) > 0.9:
        _fail(f"phase 12 mesh normals' median cosine {np.median(cos)}")
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 12)
    return {"launches": launches, "mix": mix, "k1_err": err,
            "seg_ms": float(np.median(seg_log)), "seg_ops": seg_ops,
            "esdf_ms": esdf_ms, "esdf_ops": esdf_ops}


def _mono_poses(n: int = N_MONO_FRAMES):
    """tests/test_slam_e2e.py TestMonocular's translation-dominant
    trajectory (scripts/reference_mono.py's)."""
    poses = []
    for i in range(n):
        u = i / (n - 1)
        C = np.array([1.6 * u, 0.1 * np.sin(2 * np.pi * u), 0.3 * u],
                     np.float32)
        poses.append((np.eye(3, dtype=np.float32), -C))
    return poses


def _synced_timer(torch, log: list, ops: list | None = None):
    """A wrapper factory: the wrapped call is timed between two device
    synchronisations into ``log``; with ``ops``, the third call is counted
    instead (its dispatched non-view operations into ``ops``)."""
    def wrap(fn):
        def timed(*a, **kw):
            if ops is not None and len(log) == 2 and not ops:
                out = [None]

                def call():
                    out[0] = fn(*a, **kw)

                ops.append(_count_ops(torch, call))
                return out[0]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            log.append((time.perf_counter() - t1) * 1e3)
            return out
        return timed
    return wrap


def _phase13(torch, cam, brackets, k1_ms_at: dict, words) -> dict:
    """Slice 10's monocular path: ``System.track_monocular`` at bench
    width (two-view initialization, map growth by triangulation, local BA,
    loop closing) with a blackout that the PnP branch of relocalization
    recovers from; returns the launches and K1's error at new shapes."""
    from plvs_tpu_torch.io import evaluation, synthetic
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import NOT_INITIALIZED, OK

    scene = synthetic.SyntheticRGBD(cam, wall_z=WALL_Z, seed=9)
    frames = list(scene.sequence(poses=_mono_poses()))
    system = System(cam, SystemConfig(
        num_features=1024, n_levels=8, scale=1.2, max_kf=64, max_pts=16384,
        loop_closing=True, sensor="mono", max_kf_interval=5,
        min_kf_inliers=25, pipelined=False), device="cuda")
    lm, tr = system.local_mapper, system.tracker
    cnp_ms, cnp_ops = [], []
    lm.create_new_points = _synced_timer(torch, cnp_ms, cnp_ops)(
        lm.create_new_points)
    reloc_idx = _k1_inside(brackets, tr, "_relocalize")
    a, b = MONO_BLACKOUT
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states, ms, pnp_at = [], [], []
    with brackets.run():
        for i, (ts, g, _, _, _) in enumerate(frames):
            if a <= i < b:
                g = np.zeros_like(g)
            t1 = time.perf_counter()
            state, _, _ = system.track_monocular(g, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
            pnp_at.append(tr.n_pnp_calls)
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    by_shape = brackets.ms_by_shape()
    reloc_by_shape = brackets.ms_by_shape(reloc_idx)
    ok = [i for i, s_ in enumerate(states) if s_ == OK]
    init = ok[0] if ok else None
    reloc = next((i for i in range(b, len(states)) if states[i] == OK), None)
    traj = system.trajectory_tum()
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = (evaluation.ate_rmse(traj[ok, 1:4], gt[ok], align=True,
                               with_scale=True) if len(ok) > 2 else math.inf)
    stats = system.map_statistics()
    steady = np.asarray([m for i, m in enumerate(ms)
                         if i not in (0, init, reloc) and not a <= i < b])
    added = list(lm.new_points_log)
    print(f"phase 13: {N_MONO_FRAMES} monocular frames 640x480 (1024 "
          f"features, 8 levels, local BA, loop closing) with frames "
          f"{a}-{b - 1} blank: states {states}; init frame {init} (JAX "
          f"{REF_MONO['init_frame']}), relocalized at frame {reloc} (JAX "
          f"{REF_MONO['reloc_frame']}) after {tr.n_pnp_calls} PnP RANSAC "
          f"call(s); per-frame ms p50 {np.percentile(steady, 50):.2f} p90 "
          f"{np.percentile(steady, 90):.2f} (other frames), init frame "
          f"{ms[init] if init is not None else float('nan'):.1f}, "
          f"relocalizing frame "
          f"{ms[reloc] if reloc is not None else float('nan'):.1f}, blank "
          f"frames {np.median(ms[a:b]):.1f} median; map {stats} (JAX "
          f"{REF_MONO['map']}); Sim3 ATE over the OK frames {ate:.6f} m "
          f"(JAX {REF_MONO['ate_sim3_ok_m']:.6f} m, bound "
          f"{MONO_ATE_BOUND_M:.6f} m); launches {launches}")
    print(f"phase 13: create_new_points per keyframe (synchronised): "
          f"median {np.median(cnp_ms):.2f} ms, max {max(cnp_ms):.2f} ms over "
          f"{len(cnp_ms)} timed keyframes; {cnp_ops[0] if cnp_ops else 0} "
          f"dispatched non-view operations in the third call; points added "
          f"{added}")
    print("phase 13: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 13)
    dev_ms = _k1_report(13, "over the run", by_shape, k1_ms_at, brackets)[0]
    _k1_report(13, "inside relocalization", reloc_by_shape, k1_ms_at)
    if states[0] != NOT_INITIALIZED:
        _fail(f"phase 13 frame 0 state {states[0]}")
    if init is None or init > REF_MONO["init_frame"] + 2:
        _fail(f"phase 13 initialized at frame {init}; JAX at "
              f"{REF_MONO['init_frame']}")
    if any(states[i] == OK for i in range(a, b)):
        _fail(f"phase 13 OK on a blank frame: {states[a:b]}")
    if reloc is None or reloc > REF_MONO["reloc_frame"] + 3:
        _fail(f"phase 13 relocalized at frame {reloc}; JAX at "
              f"{REF_MONO['reloc_frame']}")
    if pnp_at[reloc] < 1:
        _fail("phase 13 relocalized without a PnP RANSAC")
    if not all(s_ == OK for s_ in states[reloc:]) or not all(
            s_ == OK for s_ in states[init:a]):
        _fail(f"phase 13 tracking states {states}")
    if not np.isfinite(traj[:, 1:4]).all() or ate > MONO_ATE_BOUND_M:
        _fail(f"phase 13 ATE {ate} m exceeds the bound {MONO_ATE_BOUND_M} m")
    for key, ref in REF_MONO["map"].items():
        if abs(stats[key] - ref) > 0.25 * ref:
            _fail(f"phase 13 {key} {stats[key]} not within 25% of JAX's {ref}")
    if not any(n > 0 for n in added):
        _fail(f"phase 13: no create_new_points stage added points: {added}")
    return {"launches": launches, "mix": mix, "k1_err": err,
            "k1_device_ms": dev_ms}


def _phase14(torch, cam, k1_ms_at: dict, words) -> dict:
    """Slice 10's image scaling and map objects: RGB-D at 640x480 with
    image_scale=0.5 (the per-level ORB path at 320x240), local BA and loop
    closing, one planar map object; returns the launches and K1's error at
    new shapes."""
    from plvs_tpu_torch.features import orb
    from plvs_tpu_torch.io import evaluation, synthetic
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import OK

    scene = synthetic.SyntheticRGBD(cam, wall_z=WALL_Z, seed=1)
    frames = list(scene.sequence(n_frames=N_MONO_FRAMES))
    system = System(cam, SystemConfig(
        num_features=1024, n_levels=8, scale=1.2, max_kf=64, max_pts=16384,
        image_scale=0.5, local_ba=True, loop_closing=True, use_lines=False,
        pipelined=False), device="cuda")
    orb_log = {}
    extract = orb.extract

    def timed_extract(img, num_features=1024, *a, **kw):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = extract(img, num_features, *a, **kw)
        torch.cuda.synchronize()
        key = (tuple(img.shape), num_features)
        orb_log.setdefault(key, []).append((time.perf_counter() - t1) * 1e3)
        return out

    crop, off = 256, 20
    metric_w = crop / scene.tex_scale
    orb.extract = timed_extract
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states, ms = [], []
    try:
        oid = system.add_map_object(scene.tex[off:off + crop,
                                              off:off + crop], metric_w)
        for ts, g, d, _, _ in frames:
            t1 = time.perf_counter()
            state, _, _ = system.track_rgbd(g, d, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
    finally:
        orb.extract = extract
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(est, gt, align=True)
    stats = system.map_statistics()
    rec = system.object_store.objects[oid]
    n_tpl = len(rec.template.desc)
    corners = rec.corners_world()
    steady = np.asarray(ms[1:])
    print(f"phase 14: {N_MONO_FRAMES} RGB-D frames 640x480 at image_scale "
          f"0.5 (working size {system.cam.width}x{system.cam.height}, 1024 "
          f"features, 8 levels, local BA, loop closing, one map object): "
          f"per-frame ms p50 {np.percentile(steady, 50):.2f} p90 "
          f"{np.percentile(steady, 90):.2f} (first frame {ms[0]:.1f}); map "
          f"{stats} (JAX {REF_SCALED['map']}); ATE-RMSE {ate:.6f} m (JAX "
          f"{REF_SCALED['ate_rmse_m']:.6f} m, bound "
          f"{SCALED_ATE_BOUND_M:.6f} m); launches {launches}")
    print(f"phase 14: object: {n_tpl} template features (JAX "
          f"{REF_SCALED['template_features']}), detected at keyframes "
          f"{sorted(rec.obs)} (JAX {REF_SCALED['detected_keyframes']} "
          f"keyframes), {rec.n_inliers} inliers at the last (JAX "
          f"{REF_SCALED['n_inliers_last']}), corners "
          f"{None if corners is None else np.round(corners, 4).tolist()} "
          f"(crop offset {off / scene.tex_scale:.4f} m, width "
          f"{metric_w:.4f} m)")
    print("phase 14: per-level ORB extraction (synchronised), by image and "
          "budget: " + ", ".join(
              f"{w}x{h} at {n}: median {np.median(v):.2f} ms over {len(v)}"
              for ((h, w), n), v in sorted(orb_log.items())))
    print("phase 14: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 14)
    if not all(s_ == OK for s_ in states):
        _fail(f"phase 14 tracking states {states}")
    if not np.isfinite(est).all() or ate > SCALED_ATE_BOUND_M:
        _fail(f"phase 14 ATE {ate} m exceeds the bound {SCALED_ATE_BOUND_M} m")
    for key, ref in REF_SCALED["map"].items():
        if abs(stats[key] - ref) > 0.25 * ref:
            _fail(f"phase 14 {key} {stats[key]} not within 25% of JAX's {ref}")
    if len(rec.obs) < REF_SCALED["detected_keyframes"] - 1:
        _fail(f"phase 14 object detected at {sorted(rec.obs)}")
    if (n_tpl, system.config.num_features) not in mix:
        _fail(f"phase 14: K1 never ran at the template's {n_tpl}x1024")
    if corners is None or not np.allclose(corners[:, 2], WALL_Z, atol=0.25):
        _fail(f"phase 14 object corners {corners} off the wall")
    exp0 = np.array([off, off]) / scene.tex_scale
    if np.linalg.norm(corners[0, :2] - exp0) >= 0.25:
        _fail(f"phase 14 object corner 0 {corners[0]}, expected {exp0}")
    w_est = np.linalg.norm(corners[1] - corners[0])
    if abs(w_est - metric_w) >= 0.2 * metric_w:
        _fail(f"phase 14 object width {w_est} m, expected {metric_w} m")
    return {"launches": launches, "mix": mix, "k1_err": err,
            "orb_ms": {f"{k[0][1]}x{k[0][0]}@{k[1]}": float(np.median(v))
                       for k, v in orb_log.items()}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test runs only on a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "plvs_tpu_torch", "csrc")):
        print("chip_smoke: plvs_tpu_torch/ not found beside chip_smoke.py",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from plvs_tpu_torch.features import lines as lines_mod
    from plvs_tpu_torch.geometry import cameras
    from plvs_tpu_torch.io import evaluation, synthetic
    from plvs_tpu_torch.dense import stereo_depth
    from plvs_tpu_torch.ops import _build, cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.system import _quantize
    from plvs_tpu_torch.slam.tracking import OK

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{torch.cuda.get_device_name(0)}, power limit not read"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- phase 0: build ---------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"phase 0: built {_build.sources()} in "
          f"{time.perf_counter() - t0:.2f} s")
    _lap(0)

    rng = np.random.default_rng(0)
    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    scene = _scene(cam, synthetic)

    # -- phase 1: kernels against their plain versions ------------------------
    def words(n, fill=None):
        if fill is not None:
            a = np.full((n, 8), fill, np.uint32)
        else:
            a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(
                np.uint32)
        return torch.from_numpy(a.view(np.int32)).to(dev)

    # phase 2's shapes (point searches [candidate bucket 512..4096] x [1024
    # keypoints], line matches [line bucket 128..512] x [160]), a stereo row
    # match, fragment and tile edges, extremes, words with the high bit set,
    # and a strided view
    k1_cases = [(f"{q}x{k}", words(q), words(k)) for q, k in K1_MIX_SHAPES]
    k1_cases += [(f"{q}x{k}", words(q), words(k)) for q, k in
                 ((512, 1024), (160, 512), (1, 1), (15, 7), (17, 9),
                  (63, 65), (129, 257), (1000, 999), (4097, 1023))
                 + K1_BACKEND_SHAPES + ((777, 3072),)]
    k1_cases += [("zeros_vs_ones", words(300, 0), words(257, 0xFFFFFFFF)),
                 ("ones_vs_ones", words(65, 0xFFFFFFFF),
                  words(130, 0xFFFFFFFF)),
                 ("high_bit_set", words(100) | -2 ** 31,
                  words(77, 0x80000000)),
                 ("strided_view", words(1100)[::3], words(600)[1::2])]
    k1_err = 0
    for name, a, b in k1_cases:
        got = hamming.hamming_matrix(a, b)
        ref = hamming.hamming_plain(a, b)
        torch.cuda.synchronize()
        err = int((got - ref).abs().max()) if got.numel() else 0
        k1_err = max(k1_err, err)
        print(f"phase 1: K1 hamming {name}: max_abs_err {err}")
        if err:
            _fail(f"K1 disagrees with its plain version on {name}")
    k1_ms_at = {}
    for name, a, b in k1_cases[:len(K1_MIX_SHAPES)]:
        k1_ms_at[(a.shape[0], b.shape[0])] = ms = _time_ms(
            torch, lambda: hamming.hamming_matrix(a, b))
        print(f"phase 1: K1 at {name} (a phase-2 shape): kernel {ms:.6f} ms")
    for q, k in K1_BACKEND_SHAPES:
        a, b = words(q), words(k)
        k1_ms_at[(q, k)] = ms = _time_ms(
            torch, lambda: hamming.hamming_matrix(a, b))
        print(f"phase 1: K1 at {q}x{k} (a phase-4 shape): kernel {ms:.6f} ms, "
              f"{ms * 1e6 / (q * k):.4f} ns per output (bound "
              f"{_k1_bound(q, k)[0]:.6f} ms)")
    q, k = K1_MIX_SHAPES[-1]
    print(f"phase 1: K1 at {q}x{k} (phase 2's smallest): "
          f"{k1_ms_at[(q, k)] * 1e6 / (q * k):.4f} ns per output")
    a, b = k1_cases[0][1], k1_cases[0][2]
    q, k = a.shape[0], b.shape[0]
    k1_ms = k1_ms_at[(q, k)]
    k1_plain_ms = _time_ms_per_call(torch, lambda: hamming.hamming_plain(a, b))
    # the library calls on the unpacked bits (unpacked outside the timed
    # window): the JAX package's big-product route, (256 - <s_q, s_k>) / 2
    # with s = +-1, as one GEMM, and cdist on {0, 1}
    k1_ref = hamming.hamming_matrix(a, b)
    shifts = torch.arange(32, device=dev)
    bq = ((a.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(q, 256)
    bk = ((b.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(k, 256)
    s8q, s8k = (2 * bq - 1).to(torch.int8), (2 * bk - 1).to(torch.int8)
    bfq, bfk = s8q.to(torch.bfloat16), s8k.to(torch.bfloat16)
    fq, fk = bq.float(), bk.float()
    gemms = {"torch._int_mm(int8 -> int32)":
             lambda: torch._int_mm(s8q, s8k.t()),
             "torch.mm(bf16 -> float32)":
             lambda: torch.mm(bfq, bfk.t(), out_dtype=torch.float32)}
    others = {"torch.matmul(bf16 -> bf16)": lambda: torch.matmul(bfq, bfk.t()),
              "torch.cdist(p=0)": lambda: torch.cdist(fq, fk, p=0)}
    lib_ms = {}
    for name, fn in {**gemms, **others}.items():
        r = fn()
        ham = r if "cdist" in name else (256 - r.float()) * 0.5
        if not torch.equal(ham.to(torch.int32), k1_ref):
            _fail(f"the {name} yardstick disagrees with K1")
        lib_ms[name] = _time_ms(torch, fn)
    k1_lib = min(gemms, key=lib_ms.get)
    k1_lib_ms = lib_ms[k1_lib]
    k1_bound, k1_by = _k1_bound(q, k)
    print(f"phase 1: K1 at {q}x{k}: kernel {k1_ms:.6f} ms, plain "
          f"{k1_plain_ms:.4f} ms, bound {k1_bound:.6f} ms ({k1_by}); library "
          "calls, each equal to K1: " + ", ".join(
              f"{n} {v:.6f} ms" for n, v in lib_ms.items())
          + f"; yardstick {k1_lib} (the faster GEMM with a 32-bit output)")

    R0, t0_ = synthetic.default_trajectory(N_FRAMES)[0]
    g0, d0 = scene.render(R0, t0_)
    g8, _ = _quantize(g0, d0)
    gray = torch.from_numpy(g8).to(dev).float()
    _, _, init_r, conn_r = lines_mod.connectivity_grid(gray)
    h2, w2 = init_r.shape
    ref_cap = -(-((h2 + w2) // 3) // 8)
    print(f"phase 1: K2's 8-block cluster at {cc_labels.SMEM_PER_BLOCK} B of "
          f"shared memory a block: {cc_labels.max_active_clusters()} can be "
          "resident at once")
    # the rendered frame's grid, then grids that defeat a bounded sweep count
    # at the main-path shape, KITTI's (188x620) and 1280x720's (360x640)
    k2_cases = [("frame_240x320", init_r, conn_r)]
    for gh, gw in ((h2, w2), (188, 620), (360, 640)):
        for name, init, bits in synthetic.cc_grids(gh, gw, rng):
            k2_cases.append((f"{name}_{gh}x{gw}",
                             torch.from_numpy(init).to(dev),
                             torch.from_numpy(bits).to(dev)))
    k2_err = 0
    for name, init, conn in k2_cases:
        got = cc_labels.cc_min_labels(init, conn)
        ref = cc_labels.cc_min_labels_plain(init, conn, max_chunks=None)
        cap = -(-((init.shape[0] + init.shape[1]) // 3) // 8)
        capped = cc_labels.cc_min_labels_plain(init, conn, max_chunks=cap)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - ref).abs().max())
        k2_err = max(k2_err, err)
        print(f"phase 1: K2 cc_min_labels {name}: max_abs_err {err} vs the "
              f"converged plain version; plain with the reference cap of "
              f"{cap} chunks {'agrees' if torch.equal(got, capped) else 'stops short'}")
        if err:
            _fail(f"K2 disagrees with its plain version on {name}")
    k2_ms = _time_ms(torch, lambda: cc_labels.cc_min_labels(init_r, conn_r))
    k2_plain_ms = _time_ms_per_call(
        torch, lambda: cc_labels.cc_min_labels_plain(init_r, conn_r, ref_cap))
    for name, init, conn in k2_cases[1:]:
        if name.startswith(("spiral", "full_grid")):
            ms = _time_ms(torch, lambda: cc_labels.cc_min_labels(init, conn))
            print(f"phase 1: K2 at {name}: kernel {ms:.6f} ms")
    n_links = int(sum(((conn_r >> ci) & 1).sum() for ci in range(8)))
    k2_bound, k2_by = _bound_ms(12 * h2 * w2, 8 * h2 * w2 + 4 * n_links)
    print(f"phase 1: K2 at {h2}x{w2}: kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain_ms:.4f} ms, bound {k2_bound:.6f} ms ({k2_by}); no "
          "single PyTorch call computes connected components")

    # K3 at the main-path shape (the census of a rendered 480x640 pair,
    # D = 64), random words, a textureless pair, and ragged / wide shapes
    baseline = cam.bf / float(cam.params[0])
    gr0, _ = scene.render(R0, t0_ - np.array([baseline, 0.0, 0.0], np.float32))
    cl0 = stereo_depth.census_transform(torch.from_numpy(g0).to(dev))
    cr0 = stereo_depth.census_transform(torch.from_numpy(gr0).to(dev))

    def census_words(h, w):
        return torch.from_numpy(rng.integers(0, 2 ** 32, (h, w),
                                             dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(dev)

    flat = stereo_depth.census_transform(torch.zeros((480, 640), device=dev))
    k3_cases = [("rendered_480x640_d64", cl0, cr0, 64, 3),
                ("random_480x640_d64", census_words(480, 640),
                 census_words(480, 640), 64, 3),
                ("textureless_480x640_d64", flat, flat, 64, 3),
                ("ragged_37x150_d16", census_words(37, 150),
                 census_words(37, 150), 16, 3),
                ("random_481x641_d64", census_words(481, 641),
                 census_words(481, 641), 64, 3),
                ("rendered_480x640_d128", cl0, cr0, 128, 3),
                ("rendered_480x640_d64_r1", cl0, cr0, 64, 1),
                ("random_376x1241_d64", census_words(376, 1241),
                 census_words(376, 1241), 64, 3)]
    k3_err = 0.0
    for name, cl, cr, d, r in k3_cases:
        got = stereo.disparity_wta(cl, cr, max_disp=d, agg_radius=r)
        ref = stereo.disparity_wta_plain(cl, cr, max_disp=d, agg_radius=r)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        same_invalid = torch.equal(got < 0, ref < 0)
        k3_err = max(k3_err, err)
        print(f"phase 1: K3 disparity_wta {name}: max_abs_err {err}, same "
              f"invalid pixels {same_invalid}, valid share "
              f"{float((got >= 0).float().mean()):.4f}")
        if err or not same_invalid:
            _fail(f"K3 disagrees with its plain version on {name}")
        if name.startswith("textureless") and bool((got >= 0).any()):
            _fail("K3 kept pixels of a textureless pair")
    k3_ms = _time_ms(torch, lambda: stereo.disparity_wta(cl0, cr0))
    k3_plain_ms = _time_ms_per_call(
        torch, lambda: stereo.disparity_wta_plain(cl0, cr0), reps=10)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    stereo.disparity_wta(cl0, cr0)
    torch.cuda.synchronize()
    k3_added = torch.cuda.max_memory_allocated() - before
    print(f"phase 1: K3 at 480x640x64 adds {k3_added} B of device memory per "
          "call (the disparity it returns included)")
    if k3_added >= 4 * 2 ** 20:
        _fail(f"K3 allocates {k3_added} B per call")
    h3, w3 = cl0.shape
    # bytes: census in + disparity out; operations: XOR+popcount, the
    # separable (2r+1) + (2r+1) box additions and ~3 compares per (y, x, d)
    k3_bound, k3_by = _bound_ms(3 * 4 * h3 * w3,
                                h3 * w3 * 64 * (1 + 2 * 7 + 3))
    print(f"phase 1: K3 at {h3}x{w3}x64: kernel {k3_ms:.4f} ms, plain "
          f"{k3_plain_ms:.4f} ms, bound {k3_bound:.6f} ms ({k3_by}); no "
          "single PyTorch call computes census-stereo winner-take-all")

    (_, a1, b1), (_, a2, b2) = k1_cases[0], k1_cases[5]
    ops = _device_ops_per_call(torch, {
        f"K1 at {a1.shape[0]}x{b1.shape[0]}":
            lambda: hamming.hamming_matrix(a1, b1),
        f"K1 at {a2.shape[0]}x{b2.shape[0]}":
            lambda: hamming.hamming_matrix(a2, b2),
        "K2": lambda: cc_labels.cc_min_labels(init_r, conn_r),
        "K3": lambda: stereo.disparity_wta(cl0, cr0)})
    for label, segs in ops.items():
        if any(len(o) != 1 for o in segs):
            _fail(f"one call of {label} did not run exactly one device kernel")

    # -- phase 2: slice 1's main path (RGB-D tracking) ---------------------
    brackets = _K1Brackets(torch, hamming)
    print(f"phase 1: a K1 bracket around no kernel reads "
          f"{brackets.empty_ms():.6f} ms; the spin before it lasts "
          f"{brackets.spin_ms:.6f} ms")
    _lap(1)
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=True, max_lines=160,
                       local_ba=False, loop_closing=False,
                       dense_mapping=False, pipelined=False,
                       depth_upload_decimation=2)
    system = System(cam, cfg, device="cuda")
    frames = list(scene.sequence(n_frames=N_FRAMES))
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states, ms = [], []
    with brackets.run():
        for ts, g, d, _, _ in frames:
            t1 = time.perf_counter()
            state, _, _ = system.track_rgbd(g, d, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    by_shape = brackets.ms_by_shape()
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(est, gt, align=True)
    steady = np.asarray(ms[1:])
    print(f"phase 2: {N_FRAMES} frames 640x480, per-frame ms p50 "
          f"{np.percentile(steady, 50):.2f} p90 {np.percentile(steady, 90):.2f} "
          f"(first frame {ms[0]:.1f}); map {system.map_statistics()}; ATE-RMSE "
          f"{ate:.6f} m (bound {ATE_BOUND_M:.6f} m); launches {launches}")
    mix = dict(hamming.shapes)
    print("phase 2: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    k1_err = max(k1_err, _hold_k1(torch, hamming, words, k1_ms_at, mix, 2))
    k1_sum = _k1_report(2, f"over the run ({N_FRAMES} frames)", by_shape,
                        k1_ms_at, brackets)[0]
    if not all(s == OK for s in states[1:]):
        _fail(f"tracking states {states}")
    if launches["hamming"] < 2 * (N_FRAMES - 1):
        _fail(f"K1 launched {launches['hamming']} times on the main path")
    if launches["cc_labels"] < N_FRAMES:
        _fail(f"K2 launched {launches['cc_labels']} times on the main path")
    if not np.isfinite(est).all() or ate > ATE_BOUND_M:
        _fail(f"ATE {ate} m exceeds the bound {ATE_BOUND_M} m")

    _lap(2)

    def timed(phase, fn, *args):
        out = fn(*args)
        _lap(phase)
        return out

    launches3 = timed(3, _phase3, torch, cam, scene, brackets, k1_ms_at,
                      words)
    launches4 = timed(4, _phase4, torch, cam, scene, brackets, k1_ms_at,
                      words)
    run5 = timed(5, _phase5, torch, cam, brackets, k1_ms_at, words)
    run6 = timed(6, _phase6, torch, cam, scene, brackets, k1_ms_at, words)
    run7 = timed(7, _phase7, torch, cam, scene, brackets, k1_ms_at, words)
    run8 = timed(8, _phase8, torch, cam, scene, k1_ms_at, words)
    run9 = timed(9, _phase9, torch, cam, k1_ms_at, words)
    run10 = timed(10, _phase10, torch, brackets, k1_ms_at, words)
    run11 = timed(11, _phase11, torch, brackets, k1_ms_at, words)
    run12 = timed(12, _phase12, torch, cam, k1_ms_at, words)
    run13 = timed(13, _phase13, torch, cam, brackets, k1_ms_at, words)
    run14 = timed(14, _phase14, torch, cam, k1_ms_at, words)
    launches5, launches6 = run5["launches"], run6["launches"]
    launches7, launches8 = run7["launches"], run8["launches"]
    launches9 = run9["launches"]
    later = {10: run10["launches"], 11: run11["launches"],
             12: run12["launches"], 13: run13["launches"],
             14: run14["launches"]}
    k1_err = max(k1_err, launches3["k1_err"], launches4["k1_err"],
                 run5["k1_err"], run6["k1_err"], run7["k1_err"],
                 run8["k1_err"], run9["k1_err"], run10["k1_err"],
                 run11["k1_err"], run12["k1_err"], run13["k1_err"],
                 run14["k1_err"])

    kernels = [
        {"name": "hamming_matrix", "route": "cuda",
         "source": "plvs_tpu_torch/csrc/hamming.cu",
         "replaces": "plvs_tpu/ops/hamming.py:84",
         "launches": launches["hamming"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib_ms, "library": k1_lib,
         "launches_phase3": launches3["hamming"],
         "launches_phase4": launches4["hamming"],
         "launches_phase5": launches5["hamming"],
         "launches_phase6": launches6["hamming"],
         "launches_phase7": launches7["hamming"],
         "launches_phase8": launches8["hamming"],
         "launches_phase9": launches9["hamming"],
         "device_ms_phase2": k1_sum,
         "device_ms_phase3": launches3["k1_device_ms"],
         "device_ms_phase4": launches4["k1_device_ms"],
         "device_ms_phase5": run5["k1_device_ms"],
         "device_ms_phase6": run6["k1_device_ms"],
         "device_ms_phase7": run7["k1_device_ms"],
         **{f"launches_phase{p}": v["hamming"] for p, v in later.items()},
         "device_ms_phase10": run10["k1_device_ms"],
         "device_ms_phase11": run11["k1_device_ms"],
         "device_ms_phase13": run13["k1_device_ms"]},
        {"name": "cc_min_labels", "route": "cuda",
         "source": "plvs_tpu_torch/csrc/cc_labels.cu",
         "replaces": "plvs_tpu/ops/cc_labels.py:95",
         "launches": launches["cc_labels"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None, "library": None,
         "launches_phase3": launches3["cc_labels"],
         "launches_phase4": launches4["cc_labels"],
         "launches_phase5": launches5["cc_labels"],
         "launches_phase6": launches6["cc_labels"],
         "launches_phase7": launches7["cc_labels"],
         "launches_phase8": launches8["cc_labels"],
         "launches_phase9": launches9["cc_labels"],
         **{f"launches_phase{p}": v["cc_labels"] for p, v in later.items()}},
        {"name": "disparity_wta", "route": "cuda",
         "source": "plvs_tpu_torch/csrc/stereo_wta.cu",
         "replaces": "plvs_tpu/ops/stereo.py:161",
         "launches": launches3["stereo_wta"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound,
         "bound_by": k3_by, "library_ms": None, "library": None,
         "launches_phase4": launches4["stereo_wta"],
         "launches_phase5": launches5["stereo_wta"],
         "launches_phase6": launches6["stereo_wta"],
         "launches_phase7": launches7["stereo_wta"],
         "launches_phase8": launches8["stereo_wta"],
         "launches_phase9": launches9["stereo_wta"],
         **{f"launches_phase{p}": v["stereo_wta"] for p, v in later.items()}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
