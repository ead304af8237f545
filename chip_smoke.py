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
K3 call adds. The pose solve's kernel (``csrc/pose_opt.cu``) is held to
the eager loop (``pose_optimize_plain``) at the tracker's two solve
shapes (1,000 point rows, with and without 100 line rows, 40
iterations): the same iterations, R and t / max(1, |t|) within 1e-5,
in/outlier flags equal but for rows within 0.1% of their chi2
threshold; its device time, and the eager loop's device time (in the
profiled session) and host time a solve beside it. Phase 2 drives slice
1's path —
``System.track_rgbd``, synchronous RGB-D tracking with points and lines at
640x480, 1024 ORB features, 8 levels, 160 keylines, keyframe backend off —
over bench.py's structured-wall scene (its sweep in N_FRAMES = 40 frames;
phase 6 runs the same 40, phases 3-4 and 7-8 its first 20), with every
launch counter set to 0 just before and read just after, checks that every frame is tracked and
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
the resolves (the ``resolve.wait`` and ``resolve.finish`` spans of its
stopwatch: read-back waits, frames per group, finishes) and the backend's
largest backlog. Phase 8
is the same with the mapper actor (``async_mapping``, bench.py's
PLVS_BENCH_ASYNC=1 path) over the same 20 frames, held to the median of
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
KB8 fisheye pair scaled to 640x480 over the first 20 of 120 poses of
phase 2's sweep, local BA with fixed BA shapes, no lines — and holds it to
the JAX package's run (``scripts/reference_rig.py``): every frame OK, the ATE, the
live keyframes and points, the first frame's triangulated depths against
the rendered depth (the JAX test's gates), and K1 at 1024x1024 every
frame, exact on the first frame's descriptors. Phase 11 runs the same rig
with ``rectify=True`` and 2 cm dense mapping over 20 frames (every frame
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
per-level extraction's ms at 320x240 and for the template. Phase 15
drives slice 11's program around the tracker: phase 2's System writes its
TUM, KITTI and EuRoC trajectories (the TUM file read back within 1e-6 m of
``retro_trajectory()``) and its atlas (``shutdown(save_map_path=...)``); a
fresh System on the card loads the atlas (``load_map``: keyframes frozen,
RELOCALIZE_IN_LOADED_MAP) and replays frames 18-29 of the same sweep,
relocalizing in the loaded map (BoW candidates, K1 matches, the SE3
RANSAC), held to ``scripts/reference_map_reuse.py --frames 40``: state 4
before the first frame, OK from JAX's first OK frame, the median
camera-centre error within JAX's + 1 cm, one map, every loaded keyframe
pose bit-equal; then ``run_slam.main(["--synthetic", "--frames", "8",
"--device", "cuda", ...])`` must print its ATE and write a trajectory and
an atlas that ``load_atlas`` reads. Phase 16 drives slice 12's viewers,
AR, ROS bridges and demos: the HTTP ``LiveViewer`` serves phase 2's System
(the page, ``/state.json`` held to the store, ``/mesh.json``, then pause,
resume, save — the atlas loads —, localization and mapping) and phase 3's
dense System (``/mesh.json`` has triangles); ``draw_frame`` on the last
frame, ``keyframe_frusta`` (8 segments a keyframe), ``render_map_png``
(False without matplotlib), ``ar.detect_plane`` on phase 2's live points
(the wall's normal within 1 degree, JAX's inlier share, its ms and
dispatched operations) and ``render_ar_frame``; the ``RgbdSlamBridge`` over
frames 0-19 of phase 2's sweep as mono8 and 16UC1 millimetre messages
(every frame OK, phase 2's ATE bound, pose messages on the camera centres,
the viewer serving it meanwhile) and the ``MonoSlamBridge`` on the same
images (states against JAX's bridge); then ``demo_ar`` and ``demo_inseg``
(30 frames each) on the card, held to the JAX demos of the
same arguments (``scripts/reference_demos.py``). Phase 17 drives slice 13's
multi-device backend on the one card through meshes of shards on cuda:0
(``parallel.sharded_ba.make_mesh(n, device="cuda:0")``), each solve held
to its unsharded counterpart on the card: __graft_entry__.dryrun_multichip's
global BA at its full size (256 keyframes, 49,152 landmarks, 524,288
observations, 2 LM x 8 CG) over 4 shards with the landmarks partitioned
(the cost finite, falling, within 1e-3 of the unsharded ``scatter_free=
False`` solve); a 64-pose ring pose graph over 4 shards (the cost
falling, the drift halved, the poses within 1e-3 of the unsharded
solve); ``ShardedTSDFVolume`` over 4 shards at 640x480 and 2 cm against
``TSDFVolume`` over 3 frames (tsdf and weight within 1e-5); a System with
``sharded_backend=True`` (``System.mesh`` None on one card, as the JAX
package's on one device) given a 2-shard mesh on its local mapper and
loop closer: 10 frames of phase 2's sweep with local BA and loop closing
(K1 launches counted), its global BA sharded against the unsharded
dispatch, and one sharded loop correction pulling a 5 cm drift back;
dryrun_multichip's product-path map (6 keyframes, 512 landmarks) through
``global_ba()`` with and without the mesh; ``distributed_check`` as two
gloo ranks on cuda:0 (both ranks' costs equal and within 1e-3 of the
in-process solve); and ``bundle_adjust(schur_direct=True)`` on a window
of phase 4's size (16 keyframes, 1,536 landmarks, 96 lines: finite,
non-increasing, within 1e-3 of the same solve on the CPU), printing each
solve's CUDA-event ms beside its counterpart's. Phase 18 drives slice 14's
paths, each held to ``scripts/reference_sensor_lines.py``: (a) phase 4's
configuration over phase 2's frames through ``SensorModel(seed=11)``
(``SyntheticRGBD.sequence(sensor=)``: depth holes, quantized depth steps,
axial noise, motion blur, photometric noise), at most 2 non-OK frames and
none that JAX keeps, the ATE, the live map and the local-BA gate; (b)
``System.track_stereo`` with lines and the keyframe backend at bench width
on the bar-dominated wall (``make_line_texture``), JAX's states, the ATE,
the live map, live lines with multi-view observations and the local-BA
gate; (c) tests/test_lines_e2e.py's scene at 320x240 with depth noise,
points only and points + lines, each ATE within its bound and the two in
JAX's order; K2 launched once per line frame built in each run. After each
of phases 2-18, K1 is held exact against its plain version at every shape
that phase launched and no earlier phase had checked. Each phase prints
its wall seconds (``phase N: wall``); the run keeps well inside its
1,200 s limit only because phases 2-4, 6-12 and 16 run fewer frames than
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
import re
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
# scripts/reference_ate_stereo_dense.py --frames 40 --first 20, 156 s: all
# OK, 2 keyframes, 812 points, 9 lines, 1597 blocks; all 40 frames until
# phase 18 was added). The port is held to the ATE bound below, the
# occupied-voxel and mesh-triangle counts within +-25%, and the median
# |z - 3 m| of the occupied centroids within the JAX value + 2 cm.
# (The JAX package's CPU path computes disparity with its jnp volume, whose
# border semantics differ from the TPU kernel's, which K3 follows.)
REF_STEREO_ATE_M = 0.01153702788695688
STEREO_ATE_BOUND_M = max(1.5 * REF_STEREO_ATE_M, REF_STEREO_ATE_M + 0.01)
REF_OCCUPIED_VOXELS = 76149
REF_MEDIAN_ABS_DZ_M = 0.04999995231628418
REF_MESH_TRIANGLES_FULL = 34776
REF_MESH_TRIANGLES_INCREMENTAL = 11506
WALL_Z = 3.0

# JAX package's figures on phase 4's run (CPU run of
# JAX_PLATFORMS=cpu python scripts/reference_ate_rgbd_lines.py --local-ba
# --frames 40 --first 20, 135 s: all OK, 2 keyframes made, none culled;
# all 40 frames until phase 18a took that run over with sensor
# artifacts). The port is held to the ATE bound below and its live
# keyframes, points and lines within +-25% of these.
REF_LBA_ATE_M = 0.00310186382622284
LBA_ATE_BOUND_M = max(1.5 * REF_LBA_ATE_M, REF_LBA_ATE_M + 0.01)
REF_LBA_MAP = {"keyframes": 2, "points": 1179, "lines": 61}

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
# scripts/reference_bench_config.py --inline --frames 40 --first 20, 165
# s: all OK, no loop, 2 keyframes made, _stage_stats ready 10 / deadline 0
# / forced 0, largest backlog 1; all 40 frames until phase 18 was added
# — the schedule the port's run on the card takes,
# where every fetch is done by the next poll; free-running CPU runs resume
# some stages on their deadline or by force). Phase 7 holds the port to
# the ATE bound below and its live keyframes, points and lines, occupied
# voxels and mesh triangles within +-25% of these.
REF_BENCH_ATE_M = 0.0031378925588754236
BENCH_ATE_BOUND_M = max(1.5 * REF_BENCH_ATE_M, REF_BENCH_ATE_M + 0.01)
REF_BENCH_MAP = {"keyframes": 2, "points": 1178, "lines": 61}
REF_BENCH_DENSE = {"occupied": 101069, "triangles": 179096}

# JAX package's figures on phase 8's run: phase 7's configuration with
# async_mapping=True (bench.py's PLVS_BENCH_ASYNC=1 path) over the first
# 20 poses of phase 2's 40-pose sweep (CPU runs of JAX_PLATFORMS=cpu
# python scripts/reference_bench_config.py --async --frames 40 --first 20,
# ~207 s each, five side by side; all 40 frames until phase 18 was
# added). With the actor's helper thread a run is one sample, so five
# were made: all resolved every frame OK and closed no loop, with 2 live
# keyframes, 1179-1191 points, 61 lines, 101066-101068 occupied voxels
# and 179104 mesh triangles, ATE 0.00289-0.00296 m. Phase 8 holds the
# port to every frame resolved OK, the ATE bound below and its live
# keyframes, points and lines, occupied voxels and mesh triangles within
# +-25% of the five runs' medians, here.
REF_ASYNC_ATE_M = 0.0029159711008998794
ASYNC_ATE_BOUND_M = max(1.5 * REF_ASYNC_ATE_M, REF_ASYNC_ATE_M + 0.01)
REF_ASYNC_MAP = {"keyframes": 2, "points": 1191, "lines": 61}
REF_ASYNC_DENSE = {"occupied": 101068, "triangles": 179104}

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
# first 20 of 120 poses of phase 2's sweep (CPU run of JAX_PLATFORMS=cpu
# python scripts/reference_rig.py --phase 10 --frames 20, 82 s: all
# OK; 45 poses until phase 18 was added, 90 before that). The port is
# held to the ATE bound below, its live keyframes and points within +-25%
# of these, and on the first frame to
# tests/test_stereo_rig.py's gates (>= 100 triangulated, |median relative
# depth error| < 0.02, median |error| < 0.08).
REF_RIG = {"ate_rmse_m": 0.010329087872300108,
           "map": {"keyframes": 4, "points": 995}, "keyframes_made": 4,
           "first_frame": {"triangulated": 542,
                           "median_rel_err": 0.002783536911010742,
                           "median_abs_rel_err": 0.0468568429350853}}
RIG_ATE_BOUND_M = max(1.5 * REF_RIG["ate_rmse_m"], REF_RIG["ate_rmse_m"] + 0.01)
N_RIG_FRAMES = 20
RIG_PATH_POSES = 120
# JAX package's figures on phase 11's run: the same rig with rectify=True
# and 2 cm dense mapping (CPU run of JAX_PLATFORMS=cpu python
# scripts/reference_rig.py --phase 11 --frames 20, 153 s: all OK, 4
# keyframes made; the fine volume fills its 8192 blocks; 40 frames until
# phase 18 was added). The port is held
# to the ATE bound below, one K3 launch per keyframe made, the occupied
# voxels and mesh triangles within +-25% of these (the JAX package's CPU
# path computes disparity with its jnp volume, K3 has the TPU kernel's
# border semantics), the median |z - 3 m| within the JAX value + 2 cm (phase
# 3's limit), and SGM on the first rectified pair to JAX's valid share
# +-0.01 and median |depth - 3 m| + 5 mm (JAX on the CPU: 8.2 s).
REF_RECT = {"ate_rmse_m": 0.005772902536790433,
            "map": {"keyframes": 4, "points": 990}, "keyframes_made": 4,
            "occupied_voxels": 110826, "mesh_triangles_full": 60200,
            "median_abs_dz_m": 0.06999993324279785,
            "sgm_first_pair": {"valid_share": 0.6937890625,
                               "median_abs_depth_err_m": 0.15798723697662354}}
RECT_ATE_BOUND_M = max(1.5 * REF_RECT["ate_rmse_m"],
                       REF_RECT["ate_rmse_m"] + 0.01)
N_RECT_FRAMES = 20
# JAX package's figures on phase 12's run: demo_inseg.py's configuration
# at bench width over phase 5's room (no depth noise) on
# orbit_loop_trajectory(40, radius=0.6, laps=0.5) (CPU run of
# JAX_PLATFORMS=cpu python scripts/reference_inseg.py --frames 40, 70 s:
# all OK, 12 keyframes, no loop; the segmentation links the room's inside
# corners, so one segment holds confidence >= 2), then the library check
# on the stored keyframes at their final poses (78 s). The half orbit ran
# in 60 frames until the script's phases passed 600 s on one H100 (787 s
# with phase 17 on a slow host). The port is held to the ATE bound
# below, the segmented surface voxels and the segments at confidence >= 2
# within +-25% of these, one segmentation per dense keyframe; the
# library's fine and coarse occupied voxels, triangles and carved voxels
# within +-25%, the ESDF's median at 1000 wall points within one voxel and
# the mesh normals' median cosine to the walls over 0.9.
REF_SEG = {"ate_rmse_m": 0.016202351340185234, "first_ok": 1,
           "map": {"keyframes": 12, "points": 3800}, "loops": 0,
           "segmented_voxels": 323048, "labelled_voxels": 296418,
           "segments_conf2": 1, "next_global": 7,
           "library": {"fine_occupied": 178174, "coarse_occupied": 4383,
                       "triangles": 318586, "carved_voxels": 353193,
                       "esdf_grid": [228, 157, 317], "esdf_median_m": 0.0,
                       "normals_median_cos": 0.9998856782913208}}
SEG_ATE_BOUND_M = max(1.5 * REF_SEG["ate_rmse_m"],
                      REF_SEG["ate_rmse_m"] + 0.01)
N_SEG_FRAMES = 40

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
# JAX package's figures on phase 15's map reuse: phase 2's 40-frame run
# saved with shutdown(save_map_path=...), loaded into a fresh System with
# the same configuration (load_map(freeze=True, force_relocalization=True))
# and frames 18-29 of the same sweep replayed (CPU run of JAX_PLATFORMS=cpu
# python scripts/reference_map_reuse.py --frames 40, 164 s): 4 keyframes
# loaded and frozen, RELOCALIZE_IN_LOADED_MAP (4) before the first frame,
# OK on every replayed frame from frame 18, camera-centre errors
# 2.27-7.67 mm (median 5.59 mm), one map, the loaded poses bit-equal after
# the replay. Phase 15 holds the port to: state 4 before the first frame,
# OK from JAX's first OK frame on, the median centre error within JAX's +
# 1 cm, one map, and every loaded keyframe pose bit-equal.
REF_REUSE = {"state_before": 4, "first_ok": 18, "n_ok": 12,
             "median_centre_err_m": 0.005589180625975132, "n_maps": 1,
             "loaded_keyframes": 4}
REUSE_REPLAY = (18, 30)
REUSE_ERR_BOUND_M = REF_REUSE["median_centre_err_m"] + 0.01
# JAX package's figures for phase 16 (CPU runs of JAX_PLATFORMS=cpu python
# scripts/reference_demos.py --part ar|inseg|bridge|plane, 28 (with
# --ar-frames 30), 48 (with --inseg-frames 30), 146 and 116 s). AR demo
# (demo_ar --synthetic --frames 30, cut from its default 60: 40 until the
# script's phases passed 600 s on one H100): the plane locks at
# frame 0 with 462 inliers, origin (0.000128, 0.003945, 3.0), 6 frames
# composited. Segmentation demo (demo_inseg --synthetic --frames 30, 40
# until then): 24 of 30 frames OK, 99,456 surface voxels, 1 segment of
# 91,402 (the 6 frames not OK are the reference's behaviour too). The bridges on
# frames 0-19 of phase 2's sweep as mono8 + 16UC1 millimetre messages:
# RGB-D every frame OK, ATE 0.002495 m; monocular (phase 13's flags, no
# loop closing) NOT_INITIALIZED at frame 0, OK from frame 1. The plane of
# phase 2's 40-frame map: 2,486 points, all inliers, normal 0.0685 degrees
# from the wall's. Phase 16 holds the port to: the AR lock frame +-2, its
# inliers within 5% and origin within 1 cm, the frames composited equal;
# the segmentation demo's frames tracked +-2, surface voxels and the
# largest segment within 10%, segments +-1; the RGB-D bridge every frame
# OK within phase 2's ATE bound (its depth is quantised to whole
# millimetres, so it is not phase 2's run bit for bit); the monocular
# bridge NOT_INITIALIZED at frame 0 and OK from JAX's first OK frame +-2 on
# (JAX's two-view samples come from jax.random, the port's from a torch
# generator: phase 13's tolerance); the plane within 1 degree of the wall's
# normal with at least JAX's inlier share - 2%.
REF_AR = {"lock_frame": 0, "inliers": 462,
          "origin": (0.000127829, 0.0039447937, 3.0000002), "composited": 6}
N_AR_FRAMES = 30
REF_INSEG = {"tracked": 24, "surface_voxels": 99456, "segments": 1,
             "largest_segment": 91402}
N_INSEG_FRAMES = 30
N_BRIDGE_FRAMES = 20
REF_BRIDGE = {"rgbd_ate_m": 0.002494553687926449, "mono_first_ok": 1}
REF_PLANE = {"points": 2486, "angle_deg": 0.06852804325551864,
             "inlier_share": 1.0}
PLANE_ANGLE_BOUND_DEG = 1.0

# JAX package's figures on phase 18's runs (CPU runs of JAX_PLATFORMS=cpu
# python scripts/reference_sensor_lines.py --part a|b|c, with the
# masked-line-row repair the port has, given to the JAX package at run
# time: unrepaired, its pose solve turns NaN on frames whose keyline table
# has empty slots, about one in two on the bar-dominated wall). 18a:
# phase 4's configuration over phase 2's wall and sweep, every frame
# through SensorModel(seed=11); 18b: stereo with lines and the keyframe
# backend on make_line_texture(rng=default_rng(11)) at bench width, the
# right image one baseline to the right; 18c: tests/test_lines_e2e.py's
# scene and size with depth noise 0.006 z^2 (seeded 77 + i), points only
# and points + lines. The port is held to: at most 2 non-OK frames after
# the first and OK wherever JAX is (18a), JAX's states +-1 frame at any
# change of state (18b), the ATE bound max(1.5 x JAX, JAX + 1 cm), live
# keyframes and points within +-25% (18a-b) and live lines too (18a), one
# finite, non-increasing local BA per window with a problem (18a-b), and in
# 18c the order of the two ATEs JAX gives, each within its bound. 18b's
# lines are held to the wall instead: the port departs from the JAX
# package's stereo line depths and triangulated lines (their docstrings),
# and 4 of the 5 JAX lines with two or more observations lie 1.1-2.6 m in
# front of the wall. So 18b asks for live lines, at least one with two or
# more observations, and every live endpoint within STEREO_LINE_WALL_M of
# the wall (the port: 6 lines, 1 such, the farthest endpoint 0.158 m off;
# CPU run). Repaired, JAX keeps every frame of all four runs (states 2 =
# OK); unrepaired (--as-is) it loses 20 of 40 frames in 18b and 11 of 30
# in 18c's lines run, and there its lines do not lower the ATE (0.0710 m
# against 0.0432). 18a: --part a, 158 s; 18b: --part b, 236 s; 18c:
# --part c, 165 s.
REF_SENSOR = {"ate_rmse_m": 0.006266698746597203, "states": [2] * 40,
              "not_ok_after_first": 0,
              "map": {"keyframes": 4, "points": 1520, "lines": 48},
              "lines_multi_view": 0}
REF_STEREO_LINES = {"ate_rmse_m": 0.008134606627673468, "states": [2] * 40,
                    "map": {"keyframes": 5, "points": 1086, "lines": 11},
                    "lines_multi_view": 5}
STEREO_LINE_WALL_M = 0.25
REF_LINES_NOISE = {
    "points": {"ate_rmse_m": 0.04321630674194927, "states": [2] * 30,
               "map": {"keyframes": 3, "points": 668, "lines": 0}},
    "lines": {"ate_rmse_m": 0.03958258027723534, "states": [2] * 30,
              "map": {"keyframes": 3, "points": 666, "lines": 16},
              "lines_multi_view": 2}}
N_SENSOR_FRAMES = 40
N_LINES_NOISE_FRAMES = 30

# phases 2-4 and 6-7: bench.py's sweep (default_trajectory) in 40 frames,
# three times the step of a 120-frame run, to keep the script well inside
# its time limit
N_FRAMES = 40
# phases 3-4 and 7-8: the first 20 poses of that 40-pose sweep (the same
# step), cut from 40 when phase 18 was added (phase 18a runs phase 4's
# configuration over all 40 with sensor artifacts, 18b stereo with the
# backend over 40)
N_SHORT_FRAMES = 20
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
        shown = ops if len(ops) <= 8 else ops[:4]
        more = ("" if len(ops) <= 8 else f"; ... {len(ops) - 4} more, "
                f"{sum(us for _, us in ops):.3f} us in all")
        print(f"phase 1: {label}: one call ran {len(ops)} device op(s): "
              + "; ".join(f"{_short(nm)} {us:.3f} us" for nm, us in shown)
              + more + f" ({len(segs)} of {rounds} rounds cleanly bounded, "
              f"op counts {[len(s) for s in segs]})")
    return dict(zip(labels, clean))


# the tracker's two pose solves a frame on the benchmark's cell: the
# motion-model solve (1,000 point rows) and the local-map solve (1,000
# point and 100 line rows)
POSE_SHAPES = (("motion-model solve", 1000, 0),
               ("local-map solve", 1000, 100))


def _pose_problems(torch) -> list:
    """(label, cam, R0, t0, obs) at POSE_SHAPES, on the card. The seed is
    one whose converged steps stay ~100x above the 1e-16 exit on the CPU
    (|dx|^2 >= 9.6e-15 at both shapes), so both versions run all 40
    iterations: a step within rounding of the exit may stop either one an
    iteration early (tests/test_torch_pose_kernel.py)."""
    from plvs_tpu_torch.io import synthetic

    out = []
    for label, n, nl in POSE_SHAPES:
        cam, R0, t0, obs, _ = synthetic.pose_problem(42, n, nl,
                                                     device="cuda")
        out.append((f"{label} ({n} points, {nl} lines)", cam, R0, t0, obs))
    return out


def _hold_pose(torch, problems) -> dict:
    """The pose kernel against the eager loop at each problem: the same
    iterations (40: these never meet the exit), R and t / max(1, |t|)
    within 1e-5, flags equal but for rows within 0.1% of their chi2
    threshold at the eager loop's pose; then the kernel's device ms (back
    to back) and host ms a launch, and the eager loop's host ms a solve.
    Returns the worst R / t error and the times by label."""
    from plvs_tpu_torch.solvers import pose_opt, robust

    worst, times = 0.0, {}
    for label, cam, R0, t0, obs in problems:
        it0 = pose_opt.iteration_count()
        R, t, inl, lin, num = pose_opt.pose_optimize(cam, R0, t0, obs)
        torch.cuda.synchronize()
        its = pose_opt.iteration_count() - it0
        it1 = pose_opt.iterations
        Rp, tp, inl_p, lin_p, num_p = pose_opt.pose_optimize_plain(
            cam, R0, t0, obs)
        its_p = pose_opt.iterations - it1
        err = max(float((R - Rp).abs().max()), float(
            (t - tp).abs().max()) / max(1.0, float(tp.norm())))
        worst = max(worst, err)
        res, _, _, st = pose_opt._point_residual_jac(cam, Rp, tp, obs)
        chi2 = (res * res).sum(-1) * obs.inv_sigma2
        thr = torch.where(st, robust.CHI2_3D, robust.CHI2_2D)
        lres, _, _ = pose_opt._line_residual_jac(cam, Rp, tp, obs)
        lchi2 = (lres * lres).sum(-1) * obs.line_inv_sigma2
        near = (chi2 - thr).abs() <= 1e-3 * thr
        lnear = (lchi2 - robust.CHI2_2D).abs() <= 1e-3 * robust.CHI2_2D
        flips = int((inl != inl_p).sum() + (lin != lin_p).sum())
        far = int(((inl != inl_p) & ~near).sum()
                  + ((lin != lin_p) & ~lnear).sum())
        print(f"phase 1: pose kernel, {label}: {its} iterations (eager "
              f"{its_p}), max |R|, |t| error {err:.3g}, {int(num)} inliers "
              f"(eager {int(num_p)}), {flips} flags differ, {far} of them "
              "beyond 0.1% of the threshold")
        if its != its_p or its != 40 or err > 1e-5 or far:
            _fail(f"the pose kernel disagrees with the eager loop, {label}")
        fn = (lambda c=cam, a=R0, b=t0, o=obs:
              pose_opt.pose_optimize(c, a, b, o))
        ms = _time_ms(torch, fn, reps=50)
        host = []
        for _ in range(20):
            h0 = time.perf_counter()
            fn()
            host.append(time.perf_counter() - h0)
            torch.cuda.synchronize()
        plain = []
        for _ in range(3):
            h0 = time.perf_counter()
            pose_opt.pose_optimize_plain(cam, R0, t0, obs)
            torch.cuda.synchronize()
            plain.append(time.perf_counter() - h0)
        times[label] = {"ms": ms, "host_ms": float(np.median(host)) * 1e3,
                        "plain_host_ms": float(np.median(plain)) * 1e3}
        print(f"phase 1: pose kernel, {label}: device {ms:.6f} ms a solve "
              f"(back to back), host {times[label]['host_ms']:.4f} ms a "
              f"launch; eager loop {times[label]['plain_host_ms']:.2f} ms a "
              "solve (host clock, synchronised)")
    return {"err": worst, "times": times}


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _short_sweep(scene):
    """(ts, gray, depth, R, t) of the first N_SHORT_FRAMES poses of the
    N_FRAMES sweep."""
    from plvs_tpu_torch.io import synthetic

    return list(scene.sequence(
        synthetic.default_trajectory(N_FRAMES)[:N_SHORT_FRAMES]))


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
              for ts, g, _, R, t in _short_sweep(scene)]
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
    print(f"phase 3: {len(frames)} stereo frames 640x480, per-frame ms p50 "
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
    if (launches["hamming"] < 2 * len(frames)
            or launches["cc_labels"] < 2 * len(frames)):
        _fail(f"K1 / K2 launched {launches} times in {len(frames)} frames")
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
    launches["system"] = system  # phase 16's viewer serves its mesh
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
    frames = _short_sweep(scene)
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
    print(f"phase 4: {len(frames)} frames 640x480 with the keyframe backend, "
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
    if launches["hamming"] < 2 * (len(frames) - 1) or not backend:
        _fail(f"K1 launched {launches['hamming']} times in phase 4, "
              f"{sum(backend.values())} at the backend's shapes")
    if launches["cc_labels"] < len(frames):
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
    system.stopwatch.spans = []
    frames = _short_sweep(scene)
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
    sw = system.stopwatch
    resolve = np.asarray(sw.samples.get("resolve", [])) * 1e3
    waits = np.asarray(sw.samples.get("resolve.wait", [])) * 1e3
    finishes = np.asarray(sw.samples.get("resolve.finish", [])) * 1e3
    group_frames = [s_.attrs["frames"] for s_ in sw.spans
                    if s_.name == "resolve.wait"]
    print(f"phase 7: bench.py's configuration, {len(frames)} frames 640x480 "
          f"(pipelined, depth 4, overlap thread, interleaved backend): "
          f"track_rgbd's return on the tracking thread p50 "
          f"{np.percentile(ms, 50):.2f} ms p90 {np.percentile(ms, 90):.2f} "
          f"max {ms.max():.2f} (first frame {run['ms'][0]:.1f}); resolve "
          f"{resolve.sum():.2f} ms in {len(resolve)} calls (median "
          f"{np.median(resolve) if len(resolve) else 0.0:.3f}; "
          f"{len(group_frames)} groups of {np.mean(group_frames):.2f} frames, "
          f"fetch waits {waits.sum():.2f} ms, finishes {finishes.sum():.2f} "
          f"ms); flush {run['flush_ms']:.2f} ms; largest backlog "
          f"{run['max_backlog']}; launches {launches}, "
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
    if launches["hamming"] < 2 * (len(frames) - 1):
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
    frames = _short_sweep(scene)
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


def _phase15(torch, cam, system, frames, brackets, k1_ms_at: dict,
             words) -> dict:
    """Slice 11's program around the tracker: phase 2's System (``system``,
    after its ``frames``) writes its TUM, KITTI and EuRoC trajectories and
    its atlas (``shutdown(save_map_path=...)``); a fresh System on the card
    loads the atlas and relocalizes in it over frames 18-29 (BoW
    candidates, K1 matches, the SE3 RANSAC); then ``run_slam.main`` runs
    the synthetic sequence on the card. Returns the launches, the largest
    K1 error at new shapes and K1's bracketed device ms."""
    import io
    import tempfile

    from plvs_tpu_torch import run_slam
    from plvs_tpu_torch.io import serialization, trajectory
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.slam import System
    from plvs_tpu_torch.slam.tracking import OK, RELOCALIZE_IN_LOADED_MAP

    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"traj.{k}")
                 for k in ("tum", "kitti", "euroc")}
        system.save_trajectory_tum(paths["tum"])
        system.save_trajectory_kitti(paths["kitti"])
        system.save_trajectory_euroc(paths["euroc"])
        retro = system.retro_trajectory()
        tum = trajectory.read_tum(paths["tum"])
        centres = np.stack([-R.T @ t for _, R, t in retro])
        tum_err = float(np.abs(tum[:, 1:4] - centres).max())
        rows = {k: sum(1 for _ in open(p)) for k, p in paths.items()}
        atlas = os.path.join(tmp, "atlas.npz")
        system.shutdown(save_map_path=atlas)
        atlas_mb = os.path.getsize(atlas) / 2 ** 20
        print(f"phase 15: phase 2's run wrote {rows} trajectory rows (TUM "
              f"read back within {tum_err:.2e} m of retro_trajectory()) and "
              f"a {atlas_mb:.2f} MiB atlas")
        if len(tum) != len(frames) or rows["kitti"] != len(frames) or \
                rows["euroc"] != len(frames) + 1:
            _fail(f"phase 15 trajectory rows {rows} for {len(frames)} frames")
        if not tum_err <= 1e-6:
            _fail(f"phase 15 TUM file {tum_err} m from retro_trajectory()")

        t1 = time.perf_counter()
        reuse = System(cam, system.config, device="cuda")
        reuse.load_map(atlas, freeze=True, force_relocalization=True)
        load_ms = (time.perf_counter() - t1) * 1e3
    st = reuse.store
    frozen = np.nonzero(st.kf_fixed)[0]
    R0, t0_ = st.kf_R[frozen].copy(), st.kf_t[frozen].copy()
    state_before = int(reuse.tracker.state)
    reloc_idx = _k1_inside(brackets, reuse.tracker, "_relocalize")
    a, b = REUSE_REPLAY
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states, errs, ms = [], [], []
    with brackets.run():
        for ts, g, d, R_gt, t_gt in frames[a:b]:
            t1 = time.perf_counter()
            state, R, t = reuse.track_rgbd(g, d, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
            if state == OK:
                errs.append(float(np.linalg.norm(-R.T @ t + R_gt.T @ t_gt)))
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    by_shape = brackets.ms_by_shape()
    reloc_by_shape = brackets.ms_by_shape(reloc_idx)
    first_ok = next((a + k for k, s_ in enumerate(states) if s_ == OK), None)
    med = float(np.median(errs)) if errs else float("inf")
    frozen_same = bool(np.array_equal(st.kf_R[frozen], R0)
                       and np.array_equal(st.kf_t[frozen], t0_))
    print(f"phase 15: load_map of {len(frozen)} keyframes {load_ms:.1f} ms; "
          f"state before the replay {state_before} (JAX "
          f"{REF_REUSE['state_before']}); frames {a}-{b - 1}: states "
          f"{states}, first OK {first_ok} (JAX {REF_REUSE['first_ok']}); "
          f"camera-centre error median {med:.6f} m (JAX "
          f"{REF_REUSE['median_centre_err_m']:.6f}, bound "
          f"{REUSE_ERR_BOUND_M:.6f}), max {max(errs, default=0.0):.6f} m; "
          f"relocalizing frame {ms[0]:.1f} ms, later frames "
          f"{np.median(ms[1:]):.1f} ms median; maps {st.n_maps}; loaded "
          f"poses unchanged {frozen_same}; launches {launches}")
    print("phase 15: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 15)
    dev_ms = _k1_report(15, "over the replay", by_shape, k1_ms_at,
                        brackets)[0]
    _k1_report(15, "inside relocalization", reloc_by_shape, k1_ms_at)
    if state_before != RELOCALIZE_IN_LOADED_MAP:
        _fail(f"phase 15 state {state_before} after load_map")
    if len(frozen) != REF_REUSE["loaded_keyframes"]:
        _fail(f"phase 15 loaded {len(frozen)} frozen keyframes; JAX "
              f"{REF_REUSE['loaded_keyframes']}")
    if first_ok != REF_REUSE["first_ok"] or \
            not all(s_ == OK for s_ in states[first_ok - a:]):
        _fail(f"phase 15 states {states}; JAX OK from "
              f"{REF_REUSE['first_ok']}")
    if not med <= REUSE_ERR_BOUND_M:
        _fail(f"phase 15 median centre error {med} m over the bound "
              f"{REUSE_ERR_BOUND_M} m")
    if st.n_maps != REF_REUSE["n_maps"] or not frozen_same:
        _fail(f"phase 15 maps {st.n_maps}, loaded poses unchanged "
              f"{frozen_same}")
    if not reloc_by_shape:
        _fail("phase 15 relocalized without a K1 launch")
    reuse.shutdown()

    with tempfile.TemporaryDirectory() as tmp:
        out, mp = os.path.join(tmp, "traj.txt"), os.path.join(tmp, "map.npz")
        buf = io.StringIO()
        t1 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            run_slam.main(["--synthetic", "--frames", "8", "--device",
                           "cuda", "--out", out, "--save-map", mp])
        cli_s = time.perf_counter() - t1
        text = buf.getvalue()
        res = json.loads(text.splitlines()[0])
        st2, voc = serialization.load_atlas(mp)
        print(f"phase 15: run_slam --synthetic --frames 8 --device cuda in "
              f"{cli_s:.1f} s: {res}; {sum(1 for _ in open(out))} trajectory "
              f"rows; the atlas loads: {st2.num_keyframes} keyframes, "
              f"{st2.num_points} points, vocabulary of {voc.n_words} words")
        if "ate_rmse" not in res or not np.isfinite(res["ate_rmse"]) or \
                st2.num_keyframes < 1 or not os.path.exists(out):
            _fail(f"phase 15 run_slam gave {text!r}")
    return {"launches": launches, "k1_err": err, "k1_device_ms": dev_ms}


class _Stamp:
    def __init__(self, ts: float):
        ns = int(round(ts * 1e9))
        self.sec, self.nanosec = ns // 10 ** 9, ns % 10 ** 9


class _Header:
    def __init__(self, ts: float):
        self.stamp, self.frame_id = _Stamp(ts), ""


class _Image:
    """A sensor_msgs/Image stand-in (the bridges read these fields)."""

    def __init__(self, arr: np.ndarray, encoding: str, ts: float):
        self.height, self.width = arr.shape
        self.encoding = encoding
        self.step = arr.shape[1] * arr.itemsize
        self.data = arr.tobytes()
        self.header = _Header(ts)


def _mono8(gray: np.ndarray, ts: float) -> _Image:
    """A camera's mono8 image of a float render (rounded to u8), as
    scripts/reference_demos.py makes it."""
    return _Image(np.clip(np.round(gray), 0, 255).astype(np.uint8), "mono8",
                  ts)


def _depth16(depth: np.ndarray, ts: float) -> _Image:
    """A depth camera's 16UC1 image in whole millimetres."""
    mm = np.clip(np.round(depth * 1000.0), 0, 65535).astype(np.uint16)
    return _Image(mm, "16UC1", ts)


def _http(port: int, path: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=120) as r:
        return r.read()


def _quiet(fn, argv) -> str:
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


def _phase16(torch, cam, system, frames, stereo_system, k1_ms_at: dict,
             words) -> dict:
    """Slice 12's path on the card: the live viewer serving phase 2's
    System (``system``, after its ``frames``) and phase 3's dense stereo
    System, the drawers and the AR plane on phase 2's map, the ROS bridges
    on fake messages over frames 0-19 of phase 2's sweep, and the two demos
    at their defaults. Returns the launches and K1's error at new shapes."""
    import collections
    import tempfile

    from plvs_tpu_torch import demo_ar, demo_inseg
    from plvs_tpu_torch.io import evaluation, serialization
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.ros.nodes import MonoSlamBridge, RgbdSlamBridge
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import NOT_INITIALIZED, OK
    from plvs_tpu_torch.viz import ar, frame_drawer, map_drawer
    from plvs_tpu_torch.viz.live_server import LiveViewer

    k2_shapes = collections.Counter()
    cc_min_labels = cc_labels.cc_min_labels

    def k2_logged(init, *a, **kw):
        if init.is_cuda:
            k2_shapes[tuple(init.shape)] += 1
        return cc_min_labels(init, *a, **kw)

    cc_labels.cc_min_labels = k2_logged
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    tmp_dir = tempfile.TemporaryDirectory()
    tmp = tmp_dir.name
    try:
        # -- (a) the live viewer ---------------------------------------------
        st = system.store
        viewer = LiveViewer(system, port=0,
                            save_path=os.path.join(tmp, "live.npz"))
        dense_viewer = LiveViewer(stereo_system, port=0)
        try:
            page = _http(viewer.port, "/")
            state = json.loads(_http(viewer.port, "/state.json"))
            empty = json.loads(_http(viewer.port, "/mesh.json"))
            verbs = {}
            for op in ("pause", "resume", "save", "localization",
                       "mapping"):
                verbs[op] = _http(viewer.port, f"/cmd?op={op}")
                if op == "pause":
                    paused = json.loads(_http(viewer.port,
                                              "/state.json"))["paused"]
                elif op == "localization":
                    loc = system.tracker.only_tracking
            saved, _ = serialization.load_atlas(os.path.join(tmp,
                                                             "live.npz"))
            t1 = time.perf_counter()
            mesh = json.loads(_http(dense_viewer.port, "/mesh.json"))
            mesh_ms = (time.perf_counter() - t1) * 1e3
        finally:
            viewer.close()
            dense_viewer.close()
        live = np.nonzero(st.pt_mask)[0]
        sel = live[::len(live) // viewer.max_points + 1] \
            if len(live) > viewer.max_points else live
        covis = [np.round(np.concatenate(s_), 3).tolist()
                 for s_ in map_drawer.covisibility_segments(st)[:2000]]
        n_kf = int(st.kf_mask.sum())
        print(f"phase 16: live viewer on phase 2's System: page "
              f"{len(page)} B, state: {len(state['points'])} of {len(live)} "
              f"points, {len(state['keyframes'])} keyframe centres, "
              f"{len(state['trajectory'])} trajectory entries, frustum of "
              f"{len(state['frustum'])}, {len(state['covis'])} covisibility "
              f"segments, {len(state['lines'])} lines; verbs {verbs}; paused "
              f"{paused}, localization {loc}; saved atlas loads with "
              f"{saved.num_keyframes} keyframes; phase 3's dense System "
              f"serves {len(mesh['tris']) // 18} triangles in {mesh_ms:.1f} "
              "ms")
        if "webgl" not in page.decode() or empty != {"tris": [], "wire": []}:
            _fail("phase 16 viewer page or empty mesh payload")
        if state["points"] != np.round(st.pt_xyz[sel], 3).tolist() or \
                len(state["keyframes"]) != n_kf or \
                len(state["trajectory"]) != len(frames) or \
                len(state["frustum"]) != 12 or state["covis"] != covis:
            _fail("phase 16 viewer state does not hold the store")
        if any(v != b"ok" for v in verbs.values()) or not paused or \
                not loc or system.tracker.only_tracking or \
                saved.num_keyframes != n_kf:
            _fail(f"phase 16 viewer verbs {verbs}")
        if not mesh["tris"] or not np.isfinite(mesh["tris"]).all():
            _fail("phase 16 /mesh.json of the dense System has no triangles")

        # -- (b) the drawers and AR on phase 2's map ----------------------------
        _, g_last, _, _, _ = frames[-1]
        _, R_last, t_last = system.trajectory[-1]
        fr = system.tracker.last_frame
        kp_ok = fr.kp.mask.cpu().numpy()
        kp_xy = fr.kp.xy.cpu().numpy()[kp_ok]
        kp_trk = system.tracker.last_kp_pt_id[kp_ok] >= 0
        kf = np.nonzero(st.kf_mask)[0][-1]
        kl = st.kf_kl_mask[kf]
        img = frame_drawer.draw_frame(
            g_last, kp_xy=kp_xy, kp_tracked=kp_trk, kl_p0=st.kf_kl_sp[kf][kl],
            kl_p1=st.kf_kl_ep[kf][kl], kl_tracked=st.kf_kl_line[kf][kl] >= 0,
            state=int(system.tracker.state))
        greens = int((img == frame_drawer.GREEN).all(-1).sum())
        frusta = map_drawer.keyframe_frusta(st.kf_R, st.kf_t, st.kf_mask)
        png = os.path.join(tmp, "map.png")
        drawn = map_drawer.render_map_png(
            png, st, traj=system.trajectory_tum()[:, 1:4])
        pts = st.pt_xyz[st.pt_mask]
        plane_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            plane = ar.detect_plane(pts, device="cuda")
            torch.cuda.synchronize()
            plane_ms.append((time.perf_counter() - t1) * 1e3)
        plane_ops = _count_ops(torch, lambda: ar.detect_plane(pts,
                                                              device="cuda"))
        angle = float(np.degrees(np.arccos(min(1.0, abs(float(
            plane.normal[2])) / float(np.linalg.norm(plane.normal))))))
        share = plane.n_inliers / len(pts)
        ar_img = ar.render_ar_frame(g_last, system.cam, R_last, t_last,
                                    plane=plane, cube_size=0.3,
                                    device="cuda")
        cube_px = int(((ar_img[..., 1] == 255) & (ar_img[..., 0] == 0)).sum())
        print(f"phase 16: draw_frame {img.shape}: {len(kp_xy)} keypoints "
              f"({int(kp_trk.sum())} tracked), {int(kl.sum())} keylines, "
              f"{greens} green pixels; {len(frusta)} frustum segments for "
              f"{n_kf} keyframes; render_map_png "
              + (f"wrote {os.path.getsize(png)} B" if drawn else
                 "returned False (no matplotlib on this machine)"))
        print(f"phase 16: AR plane on phase 2's {len(pts)} live points (JAX "
              f"{REF_PLANE['points']}): normal "
              f"{np.round(plane.normal, 6).tolist()}, {angle:.4f} degrees "
              f"from the wall's (JAX {REF_PLANE['angle_deg']:.4f}, bound "
              f"{PLANE_ANGLE_BOUND_DEG}), d {plane.d:.6f}, "
              f"{plane.n_inliers} inliers = {share:.4f} of the points (JAX "
              f"{REF_PLANE['inlier_share']:.4f}); detect_plane ms "
              f"(synchronised) {[round(v, 3) for v in plane_ms]}, "
              f"{plane_ops} dispatched operations; the AR frame's cube "
              f"{cube_px} pixels")
        if img.shape != (*g_last.shape, 3) or greens == 0:
            _fail("phase 16 draw_frame drew no tracked feature")
        if len(frusta) != 8 * n_kf:
            _fail(f"phase 16 {len(frusta)} frustum segments for {n_kf} "
                  "keyframes")
        try:
            import matplotlib  # noqa: F401
            has_mpl = True
        except ImportError:
            has_mpl = False
        if drawn != has_mpl or (drawn and os.path.getsize(png) < 1000):
            _fail(f"phase 16 render_map_png gave {drawn}")
        if angle > PLANE_ANGLE_BOUND_DEG or \
                share < REF_PLANE["inlier_share"] - 0.02:
            _fail(f"phase 16 AR plane {angle} degrees off, share {share}")
        if cube_px < 20:
            _fail("phase 16 render_ar_frame drew no cube")

        # -- (c) the ROS bridges on fake messages -------------------------------
        sweep = frames[:N_BRIDGE_FRAMES]
        rgbd_sys = System(cam, system.config, device="cuda")
        rgbd = RgbdSlamBridge(rgbd_sys)
        bridge_view = LiveViewer(rgbd_sys, port=0)
        served = []
        ms = []
        try:
            for i, (ts, g, d, _, _) in enumerate(sweep):
                m_rgb, m_d = _mono8(g, ts), _depth16(d, ts)
                t1 = time.perf_counter()
                first, second = ((rgbd.on_depth, m_d), (rgbd.on_rgb, m_rgb)) \
                    if i % 2 else ((rgbd.on_rgb, m_rgb), (rgbd.on_depth, m_d))
                if first[0](first[1]) is not None:
                    _fail(f"phase 16 RGB-D bridge tracked half a pair at {i}")
                out = second[0](second[1])
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t1) * 1e3)
                if out is None:
                    _fail(f"phase 16 RGB-D bridge paired nothing at frame {i}")
                if i % 5 == 4:
                    served.append(len(json.loads(_http(
                        bridge_view.port, "/state.json"))["trajectory"]))
        finally:
            bridge_view.close()
        rgbd_sys.shutdown()
        states = [s_ for _, s_, _ in rgbd.poses]
        est = np.stack([[p["position"][k] for k in "xyz"]
                        for _, _, p in rgbd.poses])
        centres = np.stack([-R.T @ t for _, R, t in rgbd_sys.trajectory])
        pose_err = float(np.abs(est - centres).max())
        gt = np.stack([-R.T @ t for _, _, _, R, t in sweep])
        ate = evaluation.ate_rmse(est, gt, align=True)
        q_err = max(abs(float(np.linalg.norm([p["orientation"][k]
                                              for k in "xyzw"])) - 1.0)
                    for _, _, p in rgbd.poses)
        mono = MonoSlamBridge(System(cam, SystemConfig(
            num_features=1024, n_levels=8, scale=1.2, max_kf=64,
            max_pts=16384, sensor="mono", max_kf_interval=5,
            min_kf_inliers=25, local_ba=True, loop_closing=False,
            pipelined=False), device="cuda"))
        for ts, g, _, _, _ in sweep:
            mono.on_image(_mono8(g, ts))
        mono.system.shutdown()
        m_states = [s_ for _, s_, _ in mono.poses]
        m_first = next((i for i, s_ in enumerate(m_states) if s_ == OK), None)
        print(f"phase 16: RGB-D bridge over frames 0-{N_BRIDGE_FRAMES - 1} "
              f"(mono8 + 16UC1 mm): states {states}, ATE-RMSE {ate:.6f} m "
              f"(JAX bridge {REF_BRIDGE['rgbd_ate_m']:.6f}, bound "
              f"{ATE_BOUND_M:.6f}), pose messages within {pose_err:.2e} m "
              f"of the camera centres, |q| - 1 within {q_err:.1e}; per pair "
              f"ms p50 {np.percentile(ms[1:], 50):.2f}; the viewer served "
              f"{served} trajectory entries during the run; mono bridge "
              f"states {m_states} (JAX first OK at frame "
              f"{REF_BRIDGE['mono_first_ok']})")
        if not all(s_ == OK for s_ in states) or len(states) != len(sweep):
            _fail(f"phase 16 RGB-D bridge states {states}")
        if not np.isfinite(est).all() or ate > ATE_BOUND_M:
            _fail(f"phase 16 RGB-D bridge ATE {ate} m over {ATE_BOUND_M}")
        if pose_err > 1e-6 or q_err > 1e-5:
            _fail(f"phase 16 pose messages off by {pose_err} m, |q| {q_err}")
        if served != list(range(5, N_BRIDGE_FRAMES + 1, 5)):
            _fail(f"phase 16 viewer served {served} during the bridge run")
        if m_states[0] != NOT_INITIALIZED or m_first is None or \
                abs(m_first - REF_BRIDGE["mono_first_ok"]) > 2 or \
                not all(s_ == OK for s_ in m_states[m_first:]):
            _fail(f"phase 16 mono bridge states {m_states}")

        # -- (d) the demos -------------------------------------------------------
        t1 = time.perf_counter()
        out_ar = _quiet(demo_ar.main, [
            "--synthetic", "--frames", str(N_AR_FRAMES), "--out",
            os.path.join(tmp, "ar")])
        ar_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        out_seg = _quiet(demo_inseg.main, [
            "--synthetic", "--frames", str(N_INSEG_FRAMES), "--out",
            os.path.join(tmp, "seg")])
        seg_s = time.perf_counter() - t1
    finally:
        cc_labels.cc_min_labels = cc_min_labels
        tmp_dir.cleanup()
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    m = re.search(r"plane locked at frame (\d+): origin=\[([^\]]*)\], "
                  r"inliers=(\d+)", out_ar)
    n = re.search(r"AR demo: (\d+) composited", out_ar)
    s = re.search(r"(\d+) frames tracked, (\d+) surface voxels, (\d+) "
                  r"segments", out_seg)
    sizes = [int(c) for c in re.findall(r"segment \d+: (\d+) voxels",
                                        out_seg)]
    print(f"phase 16: demo_ar --synthetic --frames {N_AR_FRAMES} on the card "
          f"in {ar_s:.1f} s: {out_ar.strip()!r} (JAX: lock at frame "
          f"{REF_AR['lock_frame']}, {REF_AR['inliers']} inliers, origin "
          f"{REF_AR['origin']}, {REF_AR['composited']} composited)")
    print(f"phase 16: demo_inseg --synthetic --frames {N_INSEG_FRAMES} on the "
          f"card in {seg_s:.1f} s: {out_seg.strip()!r} (JAX: "
          f"{REF_INSEG['tracked']} tracked, {REF_INSEG['surface_voxels']} "
          f"voxels, {REF_INSEG['segments']} segment of "
          f"{REF_INSEG['largest_segment']})")
    print(f"phase 16: launches {launches}; K1 by Q x K: " + ", ".join(
        f"{q}x{k} {c}" for (q, k), c in sorted(mix.items()))
        + "; K2 by grid: " + ", ".join(
        f"{h}x{w} {c}" for (h, w), c in sorted(k2_shapes.items())))
    err = _hold_k1(torch, hamming, words, k1_ms_at, mix, 16)
    if not m or abs(int(m.group(1)) - REF_AR["lock_frame"]) > 2:
        _fail(f"phase 16 AR demo lock: {out_ar!r}")
    if abs(int(m.group(3)) - REF_AR["inliers"]) > 0.05 * REF_AR["inliers"]:
        _fail(f"phase 16 AR demo inliers {m.group(3)}")
    origin = np.array(m.group(2).split(), float)
    if np.abs(origin - REF_AR["origin"]).max() > 0.01:
        _fail(f"phase 16 AR demo origin {origin}")
    if not n or int(n.group(1)) != REF_AR["composited"]:
        _fail(f"phase 16 AR demo composited: {out_ar!r}")
    if not s or abs(int(s.group(1)) - REF_INSEG["tracked"]) > 2:
        _fail(f"phase 16 segmentation demo tracked: {out_seg!r}")
    for name, got, ref in (
            ("surface voxels", int(s.group(2)), REF_INSEG["surface_voxels"]),
            ("largest segment", max(sizes, default=0),
             REF_INSEG["largest_segment"])):
        if abs(got - ref) > 0.1 * ref:
            _fail(f"phase 16 segmentation demo {name} {got}, JAX {ref}")
    if abs(int(s.group(3)) - REF_INSEG["segments"]) > 1:
        _fail(f"phase 16 segmentation demo segments {s.group(3)}")
    if launches["hamming"] < N_AR_FRAMES + N_INSEG_FRAMES + 2 * N_BRIDGE_FRAMES:
        _fail(f"phase 16 K1 launched {launches['hamming']} times")
    if launches["cc_labels"] < 1 or launches["stereo_wta"] != 0:
        _fail(f"phase 16 launches {launches}")
    return {"launches": launches, "k1_err": err,
            "plane_ms": float(np.median(plane_ms)), "plane_ops": plane_ops}


# phase 17: the multi-device backend through meshes of shards on one card
N_SHARDED_FRAMES = 10
# __graft_entry__.dryrun_multichip's problem: a mid-size sequence's map
DRYRUN_KPM = (256, 49152, 524288)
# a window of phase 4's size for the direct Schur solve: 8 free and 8
# fixed keyframes, 1,536 landmarks, 96 lines
SCHUR_WINDOW = (16, 1536, 96)


def _event_ms(torch, fn):
    """(fn's result, CUDA-event ms from before its first launch to after
    its last; host gaps between launches included: these solves are
    eager)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def _dryrun_problem(torch, ba, cameras, dev):
    """dryrun_multichip's problem (K keyframes 2 m along x, P landmarks
    3-12 m ahead with 1 cm of noise, M observations with 0.5 px of noise;
    its numpy draws in its order) on ``dev``, and its camera."""
    cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                          bf=24.0)
    rng = np.random.default_rng(0)
    K, P, M = DRYRUN_KPM
    pts = np.stack([rng.uniform(-4, 4, P), rng.uniform(-2.5, 2.5, P),
                    rng.uniform(3, 12, P)], -1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    t[:, 0] = np.linspace(0, -2.0, K)
    obs_cam = torch.from_numpy(rng.integers(0, K, M)).to(dev)
    obs_pt = torch.from_numpy(rng.integers(0, P, M)).to(dev)
    Rd, td, pd = (torch.from_numpy(a).to(dev) for a in (R, t, pts))
    Xc = (Rd[obs_cam] @ pd[obs_pt][..., None])[..., 0] + td[obs_cam]
    uv = cameras.project(cam, Xc) + torch.from_numpy(
        rng.normal(0, 0.5, (M, 2)).astype(np.float32)).to(dev)
    noisy = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
    fixed = torch.zeros((K,), dtype=torch.bool, device=dev)
    fixed[0] = True
    prob = ba.make_problem(
        Rd, td, fixed, torch.from_numpy(noisy).to(dev), obs_cam, obs_pt,
        torch.cat([uv, -torch.ones((M, 1), device=dev)], -1),
        torch.ones((M,), device=dev),
        torch.ones((M,), dtype=torch.bool, device=dev))
    return cam, prob


def _dryrun_map(st, cam) -> np.ndarray:
    """dryrun_multichip's product-path map written into store ``st``: 512
    landmarks 2.5-6 m ahead (1 cm of noise on their positions) seen by 6
    keyframes 5 cm apart, each keyframe's keypoints the exact projections
    of the landmarks it sees; returns the landmark ids."""
    rng = np.random.default_rng(1)
    pts_w = np.stack([rng.uniform(-2, 2, 512), rng.uniform(-1.5, 1.5, 512),
                      rng.uniform(2.5, 6, 512)], -1).astype(np.float32)
    pids = st.alloc_pts(512)
    st.pt_mask[pids] = True
    st.pt_xyz[pids] = pts_w + rng.normal(0, 0.01, (512, 3)).astype(
        np.float32)
    fx, fy, cx, cy = (float(v) for v in cam.params[:4])
    for i in range(6):
        kf = st.alloc_kf()
        st.kf_mask[kf] = True
        st.kf_R[kf] = np.eye(3, dtype=np.float32)
        st.kf_t[kf] = np.asarray([-0.05 * i, 0, 0], np.float32)
        Xc = pts_w @ st.kf_R[kf].T + st.kf_t[kf]
        uv = np.stack([fx * Xc[:, 0] / Xc[:, 2] + cx,
                       fy * Xc[:, 1] / Xc[:, 2] + cy], -1).astype(np.float32)
        ok = (Xc[:, 2] > 0.1) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width) \
            & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height)
        sel = np.nonzero(ok)[0][: st.n_kp]
        st.kf_kp_uvr[kf, : len(sel), :2] = uv[sel]
        st.kf_kp_uvr[kf, : len(sel), 2] = -1.0
        st.kf_kp_mask[kf, : len(sel)] = True
        st.pt_ref_kf[pids[sel]] = np.where(
            st.pt_ref_kf[pids[sel]] < 0, kf, st.pt_ref_kf[pids[sel]])
        st.add_observations(kf, pids[sel], np.arange(len(sel)))
    return pids


def _ring_graph(torch, pose_graph, lie, dev, K=64):
    """A ring of K poses 0.3 m apart turning once around y, chain edges,
    skip-2 edges and the loop edge measured from the truth, the vertices'
    translations drifted by N(0, 5 cm) (vertex 0 fixed); the truth's
    translations."""
    rng = np.random.default_rng(17)
    R_gt, t_gt = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    step = lie.so3_exp(torch.tensor([0.0, 2 * np.pi / K, 0.0])).numpy()
    for _ in range(1, K):
        R_gt.append((step @ R_gt[-1]).astype(np.float32))
        t_gt.append((t_gt[-1] + np.array([0.3, 0, 0])).astype(np.float32))
    R_gt, t_gt = np.stack(R_gt), np.stack(t_gt)
    pairs = ([(k, k + 1) for k in range(K - 1)]
             + [(k, k + 2) for k in range(K - 2)] + [(0, K - 1)])
    pairs_d = torch.tensor(pairs, device=dev)
    Rg, tg = torch.from_numpy(R_gt).to(dev), torch.from_numpy(t_gt).to(dev)
    eR, et, es = pose_graph.make_edges_from_poses(
        Rg, tg, torch.ones((K,), device=dev), pairs_d)
    t0 = t_gt + rng.normal(0, 0.05, t_gt.shape).astype(np.float32)
    t0[0] = t_gt[0]
    fixed = torch.zeros((K,), dtype=torch.bool, device=dev)
    fixed[0] = True
    E = len(pairs)
    prob = pose_graph.PoseGraphProblem(
        Rg, torch.from_numpy(t0).to(dev), torch.ones((K,), device=dev),
        fixed, pairs_d[:, 0], pairs_d[:, 1], eR, et, es,
        torch.ones((E,), device=dev),
        torch.ones((E,), dtype=torch.bool, device=dev))
    return prob, t_gt


def _schur_window(torch, ba, dev):
    """A stereo window with lines at phase 4's size (SCHUR_WINDOW): poses
    perturbed by 0.01 rad / 3 cm, landmarks by 5 cm, 0.3 px of noise, each
    landmark seen at least twice; the first half of the keyframes fixed,
    as the local BA fixes the window's outside observers."""
    rng = np.random.default_rng(4)
    K, P, L = SCHUR_WINDOW

    def so3(s):
        w = rng.normal(size=3) * s
        th = np.linalg.norm(w)
        k = w / max(th, 1e-12)
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return (np.eye(3) + np.sin(th) * Kx
                + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)

    X = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P),
                  rng.uniform(2.0, 6.0, P)], -1).astype(np.float32)
    R_gt = np.stack([so3(0.05) for _ in range(K)])
    t_gt = (np.stack([[-0.15 * k, 0, 0] for k in range(K)])
            + rng.normal(size=(K, 3)) * 0.02).astype(np.float32)
    oc, op, ouvr = [], [], []
    for k in range(K):
        Xc = X @ R_gt[k].T + t_gt[k]
        uv = Xc[:, :2] / Xc[:, 2:] * 520.0 + np.array([320.0, 240.0])
        vis = ((uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0)
               & (uv[:, 1] < 480) & (Xc[:, 2] > 0.5))
        idx = np.nonzero(vis & (rng.uniform(size=P) > 0.5))[0]
        u = uv[idx] + rng.normal(size=(len(idx), 2)) * 0.3
        uR = u[:, 0] - 40.0 / Xc[idx, 2] + rng.normal(size=len(idx)) * 0.3
        oc.append(np.full(len(idx), k))
        op.append(idx)
        ouvr.append(np.concatenate([u, uR[:, None]], -1))
    oc, op = np.concatenate(oc), np.concatenate(op)
    ouvr = np.concatenate(ouvr).astype(np.float32)
    seen = np.bincount(op, minlength=P) >= 2
    keep = seen[op]
    oc, op, ouvr = oc[keep], op[keep], ouvr[keep]
    Xs = np.stack([rng.uniform(-3, 3, L), rng.uniform(-2, 2, L),
                   rng.uniform(2.0, 5.0, L)], -1).astype(np.float32)
    d = rng.normal(size=(L, 3))
    d[:, 2] = np.sign(d[:, 2]) * (1.0 + np.abs(d[:, 2]))
    Xe = (Xs + 0.8 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)
    lc, ll, nld, dep = [], [], [], []
    for k in range(K):
        for j in range(L):
            ends = [(R_gt[k] @ Xw + t_gt[k]) for Xw in (Xs[j], Xe[j])]
            if min(e[2] for e in ends) < 0.5:
                continue
            sp, ep = (e[:2] / e[2] * 520.0 + [320.0, 240.0] for e in ends)
            dv = ep - sp
            n = np.array([-dv[1], dv[0]]) / np.linalg.norm(dv)
            lc.append(k)
            ll.append(j)
            nld.append([n[0], n[1], -n @ sp + rng.normal() * 0.3])
            dep.append([ends[0][2], ends[1][2]])
    R0, t0 = R_gt.copy(), t_gt.copy()
    for k in range(K // 2, K):
        R0[k] = so3(0.01) @ R_gt[k]
        t0[k] = t_gt[k] + rng.normal(size=3) * 0.03
    M, Ml = len(oc), len(lc)

    def put(a, dtype=None):
        return torch.as_tensor(np.asarray(a, dtype), device=dev)

    return ba.make_problem(
        put(R0), put(t0), put(np.arange(K) < K // 2),
        put(X + rng.normal(size=X.shape) * 0.05, np.float32), put(oc),
        put(op), put(ouvr), put(np.ones(M), np.float32),
        put(np.ones(M, bool)), point_mask=put(seen),
        lines_Xs=put(Xs + rng.normal(size=Xs.shape) * 0.03, np.float32),
        lines_Xe=put(Xe + rng.normal(size=Xe.shape) * 0.03, np.float32),
        line_mask=put(np.ones(L, bool)), lobs_cam=put(lc), lobs_line=put(ll),
        lobs_nld=put(nld, np.float32),
        lobs_inv_sigma2=put(np.ones(Ml), np.float32),
        lobs_mask=put(np.ones(Ml, bool)), lobs_depth=put(dep, np.float32))


def _phase17(torch, cam, frames, k1_ms_at: dict, words) -> dict:
    """Slice 13's multi-device backend on one card, each solve through a
    mesh of shards on cuda:0 (``make_mesh(n, device="cuda:0")``) and held
    to the unsharded solve on the card: dryrun_multichip's global BA at
    full size (4 shards, landmarks partitioned), the ring pose graph and
    the block-sharded TSDF at bench width, a System with
    ``sharded_backend`` (no mesh on one card; 2 shards set on its local
    mapper and loop closer: tracking, the product-path global BA, one loop
    correction), the gloo check in two processes on the card, and the
    direct Schur BA on a window of phase 4's size against the same solve
    on the CPU. Returns the launches and the largest K1 error at new
    shapes."""
    from plvs_tpu_torch.dense.tsdf import TSDFVolume
    from plvs_tpu_torch.geometry import cameras, lie
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo
    from plvs_tpu_torch.parallel import (distributed_check, sharded_ba,
                                         sharded_pose_graph, sharded_tsdf)
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import OK
    from plvs_tpu_torch.solvers import ba, pose_graph

    dev = torch.device("cuda")
    if torch.backends.cuda.matmul.allow_tf32:
        _fail("phase 17: TF32 matmuls are on; the Schur assembly needs "
              "float32 products")

    # -- the dryrun's global BA at full size, 4 shards on cuda:0 ----------
    dcam, prob = _dryrun_problem(torch, ba, cameras, dev)
    mesh4 = sharded_ba.make_mesh(4, device="cuda:0")

    def sharded():
        return sharded_ba.bundle_adjust_sharded(
            dcam, prob, mesh4, num_iters=2, cg_iters=8, shard_points=True)

    def unsharded():
        return ba.bundle_adjust(dcam, prob, num_iters=2, cg_iters=8,
                                scatter_free=False)

    sharded(), unsharded()                         # warm-up
    out_s, ms_s = _event_ms(torch, sharded)
    out_1, ms_1 = _event_ms(torch, unsharded)
    c_s, c0 = float(out_s[-1]["cost"]), float(out_s[-1]["cost0"])
    c_1 = float(out_1[-1]["cost"])
    K, P, M = DRYRUN_KPM
    print(f"phase 17: dryrun global BA K {K} P {P} M {M}, 2 LM x 8 CG: "
          f"4 shards on cuda:0 with the landmarks partitioned: cost "
          f"{c0:.3f} -> {c_s:.3f} in {ms_s:.2f} ms; unsharded "
          f"(scatter_free=False) {c_1:.3f} in {ms_1:.2f} ms; relative "
          f"difference {abs(c_s - c_1) / c_1:.2e}")
    if not (math.isfinite(c_s) and c_s < c0):
        _fail(f"phase 17 sharded BA cost {c0} -> {c_s}")
    if not all(bool(torch.isfinite(o).all()) for o in out_s[:3]):
        _fail("phase 17 sharded BA returned non-finite blocks")
    if abs(c_s - c_1) > 1e-3 * c_1:
        _fail(f"phase 17 sharded BA cost {c_s} against unsharded {c_1}")
    del prob, out_s, out_1

    # -- the ring pose graph and the block-sharded TSDF -------------------
    ring, t_gt = _ring_graph(torch, pose_graph, lie, dev)

    def ring_sharded():
        return sharded_pose_graph.optimize_sharded(
            ring, mesh4, num_iters=12, cg_iters=50, fix_scale=True)

    def ring_one():
        return pose_graph.optimize(ring, num_iters=12, cg_iters=50,
                                   fix_scale=True)

    ring_sharded(), ring_one()
    (Rs, ts, _, pinfo), pg_ms = _event_ms(torch, ring_sharded)
    (R1, t1, _, pinfo1), pg1_ms = _event_ms(torch, ring_one)
    err0 = float(np.linalg.norm(ring.t.cpu().numpy() - t_gt, axis=-1).mean())
    err1 = float(np.linalg.norm(ts.cpu().numpy() - t_gt, axis=-1).mean())
    dpose = max(float((Rs - R1).abs().max()), float((ts - t1).abs().max()))
    print(f"phase 17: ring pose graph ({ring.R.shape[0]} vertices, "
          f"{ring.edge_i.shape[0]} edges, 12 LM x 50 CG, 4 shards): cost "
          f"{float(pinfo['cost0']):.5f} -> {float(pinfo['cost']):.6f} in "
          f"{pg_ms:.2f} ms (unsharded {float(pinfo1['cost']):.6f} in "
          f"{pg1_ms:.2f} ms); mean position error {err0:.4f} -> {err1:.4f} "
          f"m; poses within {dpose:.2e} of the unsharded solve")
    if not (float(pinfo["cost"]) < float(pinfo["cost0"])
            and err1 < 0.5 * err0 and dpose <= 1e-3):
        _fail(f"phase 17 sharded pose graph: cost {pinfo}, error {err0} -> "
              f"{err1}, {dpose} from the unsharded solve")

    vol = TSDFVolume(cam, voxel_size=0.02, device="cuda")
    svol = sharded_tsdf.ShardedTSDFVolume(mesh4, cam, voxel_size=0.02)
    t_ms = {"sharded": [], "unsharded": []}
    for _, g, d, R_gt, t_gt_ in frames[:3]:
        for name, v in (("unsharded", vol), ("sharded", svol)):
            _, ms = _event_ms(torch, lambda: v.integrate(d, g, R_gt, t_gt_))
            t_ms[name].append(ms)
    n = vol.n_blocks
    d_t = float(np.abs(svol.tsdf[:n] - vol.tsdf[:n]).max())
    d_w = float(np.abs(svol.weight[:n] - vol.weight[:n]).max())
    print(f"phase 17: ShardedTSDFVolume (4 shards, 2 cm, 640x480): {n} "
          f"blocks after 3 frames, integrate ms "
          f"{[round(x, 3) for x in t_ms['sharded']]} against the unsharded "
          f"volume's {[round(x, 3) for x in t_ms['unsharded']]}; tsdf within "
          f"{d_t:.2e}, weight within {d_w:.2e}")
    if svol.n_blocks != n or n == 0 or d_t > 1e-5 or d_w > 1e-5:
        _fail(f"phase 17 sharded TSDF: {svol.n_blocks} / {n} blocks, tsdf "
              f"{d_t}, weight {d_w}")
    del vol, svol

    # -- a System with sharded_backend on one card ------------------------
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=False, local_ba=True,
                       loop_closing=True, dense_mapping=False,
                       sharded_backend=True, backend_fixed_shapes=True,
                       max_kf_interval=3, depth_upload_decimation=2)
    system = System(cam, cfg, device="cuda")
    if torch.cuda.device_count() == 1 and system.mesh is not None:
        _fail("phase 17: System.mesh is set on one card")
    mesh2 = sharded_ba.make_mesh(2, device="cuda:0")
    system.local_mapper.mesh = system.loop_closer.mesh = mesh2
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states = []
    for ts_, g, d, _, _ in frames[:N_SHARDED_FRAMES]:
        states.append(int(system.track_rgbd(g, d, ts_)[0]))
    torch.cuda.synchronize()
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    st = system.store
    lm = system.local_mapper
    window = np.sort(st.kfs_of_map(st.active_map)).astype(np.int64)
    ctx_one = lm._ba_dispatch(window, num_iters=10, cg_iters=30)
    if ctx_one is None:
        _fail(f"phase 17: {len(window)} keyframes gave no global BA problem")
    c_one = float(ctx_one["info"]["cost"])
    gba, gba_ms = _event_ms(torch, lm.global_ba)
    print(f"phase 17: System(sharded_backend=True) on {torch.cuda.device_count()}"
          f" card(s): mesh {system.mesh}; 2 shards on cuda:0 set on its local"
          f" mapper and loop closer; {N_SHARDED_FRAMES} frames 640x480, states "
          f"{states}, {st.num_keyframes} keyframes; global_ba over them: cost "
          f"{gba['cost0']:.3f} -> {gba['cost']:.3f} in {gba_ms:.2f} ms "
          f"(unsharded {c_one:.3f}); launches {launches}")
    if not all(s == OK for s in states[1:]):
        _fail(f"phase 17 tracking states {states}")
    if not (math.isfinite(gba["cost"]) and gba["cost"] <= gba["cost0"]
            and abs(gba["cost"] - c_one) <= 1e-3 * max(c_one, 1e-6)):
        _fail(f"phase 17 sharded global BA {gba} against unsharded {c_one}")
    if launches["hamming"] < N_SHARDED_FRAMES:
        _fail(f"phase 17: K1 launched {launches['hamming']} times")
    # one sharded loop correction: the last keyframe drifted by 5 cm, the
    # loop edge to keyframe 0 at the relative pose of their true poses
    live = np.nonzero(st.kf_mask)[0]
    kf0, kfn = int(live[0]), int(live[-1])
    gt = {k: frames[int(st.kf_frame_id[k])][3:] for k in (kf0, kfn)}
    R_rel = gt[kf0][0] @ gt[kfn][0].T
    t_rel = gt[kf0][1] - R_rel @ gt[kfn][1]

    def rel_err():
        Rr = st.kf_R[kf0] @ st.kf_R[kfn].T
        return float(np.linalg.norm(st.kf_t[kf0] - Rr @ st.kf_t[kfn] - t_rel))

    st.kf_t[kfn] = st.kf_t[kfn] + np.array([0.05, 0.0, -0.03], np.float32)
    e_before = rel_err()
    corr, corr_ms = _event_ms(
        torch, lambda: system.loop_closer._correct(kfn, kf0, R_rel, t_rel))
    e_after = rel_err()
    print(f"phase 17: sharded loop correction (keyframe {kfn} against {kf0}, "
          f"{corr['n_kf']} vertices): pose graph {corr['cost0']:.5f} -> "
          f"{corr['cost']:.6f} in {corr_ms:.2f} ms; the loop's relative "
          f"translation error {e_before:.4f} -> {e_after:.4f} m")
    if not (corr["cost"] < corr["cost0"] and e_after < 0.5 * e_before):
        _fail(f"phase 17 sharded loop correction {corr}, error {e_before} -> "
              f"{e_after}")
    err = _hold_k1(torch, hamming, words, k1_ms_at, dict(hamming.shapes), 17)
    del system

    # the product-path scenario of dryrun_multichip itself: 6 keyframes,
    # 512 landmarks, global_ba() on the 2-shard mesh against no mesh
    costs = {}
    for name in ("sharded", "unsharded"):
        dsys = System(dcam, SystemConfig(num_features=128, n_levels=3,
                                         max_kf=32, max_pts=4096,
                                         local_ba=True, loop_closing=False,
                                         sharded_backend=True),
                      device="cuda")
        if name == "sharded":
            dsys.local_mapper.mesh = mesh2
        pids = _dryrun_map(dsys.store, dcam)
        info, ms = _event_ms(torch, dsys.local_mapper.global_ba)
        costs[name] = (info, ms, dsys.store.pt_xyz[pids].copy())
    (si, sms, sx), (ui, ums, ux) = costs["sharded"], costs["unsharded"]
    dx = float(np.abs(sx - ux).max())
    print(f"phase 17: dryrun product path (6 keyframes, 512 landmarks): "
          f"sharded global_ba {si['cost0']:.3f} -> {si['cost']:.3e} in "
          f"{sms:.2f} ms, unsharded {ui['cost']:.3e} in {ums:.2f} ms; "
          f"landmarks within {dx:.2e} m")
    if not (np.isfinite(sx).all() and si["cost"] <= si["cost0"]
            and dx <= 1e-3):
        _fail(f"phase 17 dryrun product path {si}, {dx} m from unsharded")

    # -- distributed_check: two gloo ranks on cuda:0 ----------------------
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    t1 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "plvs_tpu_torch.parallel.distributed_check",
         f"tcp://127.0.0.1:{port}", "2", str(r), "--device", "cuda"],
        cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    dist_s = time.perf_counter() - t1
    ranks = []
    for p, out in zip(procs, outs):
        line = [ln for ln in out.splitlines() if ln.startswith("DIST_OK")]
        if p.returncode != 0 or not line:
            _fail(f"phase 17 distributed_check rank failed: {out[-2000:]}")
        ranks.append(float(line[0].split("cost=")[1]))
    ccam, cprob = distributed_check.make_problem(dev)
    (one,), one_ms = _event_ms(torch, lambda: (float(ba.bundle_adjust(
        ccam, cprob, num_iters=2, cg_iters=8,
        scatter_free=False)[-1]["cost"]),))
    print(f"phase 17: distributed_check, 2 gloo ranks on cuda:0: costs "
          f"{ranks} in {dist_s:.1f} s of wall (two processes); the "
          f"in-process solve {one:.6f} in {one_ms:.2f} ms")
    if ranks[0] != ranks[1] or abs(ranks[0] - one) > 1e-3 * one:
        _fail(f"phase 17 gloo ranks {ranks} against in-process {one}")

    # -- the direct Schur BA on a window of phase 4's size -----------------
    wprob = _schur_window(torch, ba, dev)

    def schur():
        return ba.bundle_adjust(cam, wprob, num_iters=5, cg_iters=14,
                                schur_direct=True)

    def pcg():
        return ba.bundle_adjust(cam, wprob, num_iters=5, cg_iters=14)

    schur(), pcg()
    sout, s_ms = _event_ms(torch, schur)
    pout, p_ms = _event_ms(torch, pcg)
    cpu = ba.bundle_adjust(cam, ba.BAProblem(*(f.cpu() for f in wprob)),
                           num_iters=5, cg_iters=14, schur_direct=True)
    sc, sc0 = float(sout[-1]["cost"]), float(sout[-1]["cost0"])
    cc = float(cpu[-1]["cost"])
    Kw, Pw, Lw = SCHUR_WINDOW
    print(f"phase 17: schur_direct on a {Kw}-keyframe window ({Pw} landmarks,"
          f" {wprob.obs_cam.shape[0]} observations, {Lw} lines, "
          f"{wprob.lobs_cam.shape[0]} line observations), 5 LM x 14 CG: cost "
          f"{sc0:.3f} -> {sc:.4f} in {s_ms:.2f} ms ({int(sout[-1]['cg_iters'])}"
          f" CG), the CPU's {cc:.4f}; the PCG solve {float(pout[-1]['cost']):.4f}"
          f" in {p_ms:.2f} ms ({int(pout[-1]['cg_iters'])} CG)")
    if not (math.isfinite(sc) and sc <= sc0 and abs(sc - cc) <= 1e-3 * cc):
        _fail(f"phase 17 schur_direct cost {sc0} -> {sc}, CPU {cc}")
    return {"launches": launches, "k1_err": err}


def _ate_bound(ref_m: float) -> float:
    return max(1.5 * ref_m, ref_m + 0.01)


def _drive18(torch, tag: str, system, frames, stereo_pair: bool, brackets,
             k1_ms_at: dict, words, line_frames: list) -> dict:
    """Track one of phase 18's runs synchronously with K1 bracketed and the
    launch counters set to 0 just before; hold K1 at its new shapes and
    print the run's figures. Returns them."""
    from plvs_tpu_torch.io import evaluation
    from plvs_tpu_torch.ops import cc_labels, hamming, stereo

    lm = system.local_mapper
    gathered = []
    gather = lm._gather_ba

    def counting_gather(window):
        packed = gather(window)
        gathered.append(packed is not None)
        return packed

    lm._gather_ba = counting_gather
    track = system.track_stereo if stereo_pair else system.track_rgbd
    line_frames.clear()
    hamming.launches = cc_labels.launches = stereo.launches = 0
    hamming.shapes.clear()
    states, ms = [], []
    with brackets.run():
        for ts, a, b, _, _ in frames:
            t1 = time.perf_counter()
            state, _, _ = track(a, b, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches}
    mix = dict(hamming.shapes)
    by_shape = brackets.ms_by_shape()
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    st = system.store
    lns = np.nonzero(st.ln_mask)[0]
    ends_z = np.concatenate([st.ln_Xs[lns, 2], st.ln_Xe[lns, 2]])
    out = {"states": states, "ate": evaluation.ate_rmse(est, gt, align=True),
           "finite": bool(np.isfinite(est).all()),
           "map": system.map_statistics(),
           "lines_multi_view": int((st.ln_n_obs[lns] >= 2).sum()),
           # the farthest live line endpoint from the wall z = 3 m
           "line_off_wall_m": float(np.abs(ends_z - 3.0).max(initial=0.0)),
           "ba_log": lm.ba_log, "gathered": gathered,
           "launches": launches, "line_frames": len(line_frames)}
    steady = np.asarray(ms[1:])
    log = out["ba_log"]
    print(f"phase 18{tag}: {len(frames)} frames, per-frame ms p50 "
          f"{np.percentile(steady, 50):.2f} p90 "
          f"{np.percentile(steady, 90):.2f} (synchronised; first frame "
          f"{ms[0]:.1f}); states {states}; map {out['map']}, lines with >= 2 "
          f"observations {out['lines_multi_view']}; ATE-RMSE "
          f"{out['ate']:.6f} m; {len(log)} local BA solves for "
          f"{sum(gathered)} windows with a problem, cost0 -> cost "
          + ", ".join(f"{b['cost0']:.1f} -> {b['cost']:.1f}" for b in log)
          + f"; launches {launches}, {len(line_frames)} line frames built")
    print(f"phase 18{tag}: K1 launches by Q x K: " + ", ".join(
        f"{q}x{k} {n}" for (q, k), n in sorted(mix.items())))
    out["k1_err"] = _hold_k1(torch, hamming, words, k1_ms_at, mix, 18)
    out["k1_device_ms"] = _k1_report(18, f"over run 18{tag}", by_shape,
                                     k1_ms_at, brackets)[0]
    if launches["cc_labels"] != len(line_frames):
        _fail(f"phase 18{tag}: K2 launched {launches['cc_labels']} times "
              f"for {len(line_frames)} line frames")
    if launches["stereo_wta"] != 0:
        _fail(f"phase 18{tag}: K3 launched {launches['stereo_wta']} times")
    return out


def _hold18(tag: str, run: dict, ref: dict,
            keys=("keyframes", "points", "lines")) -> None:
    """The ATE bound, the live map's ``keys`` within 25% and the local-BA
    gate."""
    bound = _ate_bound(ref["ate_rmse_m"])
    if not run["finite"] or run["ate"] > bound:
        _fail(f"phase 18{tag} ATE {run['ate']} m exceeds the bound {bound} m "
              f"(JAX {ref['ate_rmse_m']} m)")
    for key in keys:
        got, want = run["map"][key], ref["map"][key]
        if abs(got - want) > 0.25 * want:
            _fail(f"phase 18{tag} live {key} {got} not within 25% of JAX's "
                  f"{want}")
    log = run["ba_log"]
    if len(log) != sum(run["gathered"]) or not log:
        _fail(f"phase 18{tag}: {len(log)} local BA solves for "
              f"{sum(run['gathered'])} problems")
    for b in log:
        if not (np.isfinite(b["cost"]) and b["cost"] <= b["cost0"]):
            _fail(f"phase 18{tag} local BA diverged: {b}")


def _states_near(states: list, ref: list) -> bool:
    """Each state equals JAX's at that frame, or at a neighbouring frame
    where JAX's state changes (a change may come one frame early or
    late)."""
    for i, s_ in enumerate(states):
        near = ref[max(i - 1, 0):i + 2]
        if s_ != ref[i] and (s_ not in near or len(set(near)) == 1):
            return False
    return len(states) == len(ref)


def _phase18(torch, cam, scene, brackets, k1_ms_at: dict, words) -> dict:
    """Slice 14's paths: (a) phase 4's RGB-D configuration with lines and
    the keyframe backend over phase 2's frames through the sensor-artifact
    model; (b) stereo with lines and the keyframe backend on the
    bar-dominated wall at bench width; (c) tests/test_lines_e2e.py's
    low-texture scene at 320x240 with depth noise, points only and points
    + lines. Returns the launches over the four runs, the largest K1 error
    at new shapes and K1's bracketed device ms."""
    from plvs_tpu_torch.features import lines as lines_mod
    from plvs_tpu_torch.geometry import cameras
    from plvs_tpu_torch.io import synthetic
    from plvs_tpu_torch.slam import System, SystemConfig
    from plvs_tpu_torch.slam.tracking import OK

    line_frames = []
    detect = lines_mod.detect_lines

    def counting_detect(*a, **kw):
        line_frames.append(1)
        return detect(*a, **kw)

    lines_mod.detect_lines = counting_detect
    wide = dict(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                max_pts=65536, use_lines=True, max_lines=160, local_ba=True,
                loop_closing=False, dense_mapping=False, pipelined=False,
                backend_fixed_shapes=True)
    runs = {}
    try:
        # -- 18a: RGB-D under sensor artifacts ------------------------------
        frames = list(scene.sequence(n_frames=N_SENSOR_FRAMES,
                                     sensor=synthetic.SensorModel(seed=11)))
        system = System(cam, SystemConfig(**wide, depth_upload_decimation=2),
                        device="cuda")
        runs["a"] = a = _drive18(torch, "a", system, frames, False, brackets,
                                 k1_ms_at, words, line_frames)
        ref = REF_SENSOR
        lost = [i for i, s_ in enumerate(a["states"]) if s_ != OK and i]
        kept = [i for i in lost if ref["states"][i] == OK]
        print(f"phase 18a: non-OK frames after the first {lost} (JAX "
              f"{ref['not_ok_after_first']}); ATE bound "
              f"{_ate_bound(ref['ate_rmse_m']):.6f} m (JAX "
              f"{ref['ate_rmse_m']:.6f} m); JAX map {ref['map']}")
        if len(lost) > 2 or kept:
            _fail(f"phase 18a lost frames {lost}, {kept} of them OK in JAX")
        _hold18("a", a, ref)

        # -- 18b: stereo with lines and the keyframe backend ----------------
        bars = synthetic.SyntheticRGBD(
            cam, wall_z=3.0, texture=synthetic.make_line_texture(
                rng=np.random.default_rng(11)))
        shift = np.array([cam.bf / float(cam.params[0]), 0.0, 0.0],
                         np.float32)
        frames = [(ts, g, bars.render(R, t - shift)[0], R, t) for ts, g, _, R,
                  t in bars.sequence(n_frames=N_SENSOR_FRAMES)]
        system = System(cam, SystemConfig(**wide, sensor="stereo"),
                        device="cuda")
        runs["b"] = b = _drive18(torch, "b", system, frames, True, brackets,
                                 k1_ms_at, words, line_frames)
        ref = REF_STEREO_LINES
        print(f"phase 18b: JAX states {ref['states']}; ATE bound "
              f"{_ate_bound(ref['ate_rmse_m']):.6f} m (JAX "
              f"{ref['ate_rmse_m']:.6f} m); JAX map {ref['map']}; the "
              f"farthest live line endpoint {b['line_off_wall_m']:.3f} m "
              f"off the wall (bound {STEREO_LINE_WALL_M} m)")
        if not _states_near(b["states"], ref["states"]):
            _fail(f"phase 18b states {b['states']}; JAX {ref['states']}")
        if (b["map"]["lines"] <= 0 or b["lines_multi_view"] < 1
                or b["line_off_wall_m"] > STEREO_LINE_WALL_M):
            _fail(f"phase 18b: {b['map']['lines']} live lines, "
                  f"{b['lines_multi_view']} with >= 2 observations, the "
                  f"farthest endpoint {b['line_off_wall_m']:.3f} m off the "
                  f"wall")
        _hold18("b", b, ref, keys=("keyframes", "points"))

        # -- 18c: lines under depth noise, 320x240 -------------------------
        small = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320,
                                height=240, bf=24.0)
        bars = synthetic.SyntheticRGBD(
            small, wall_z=3.0, texture=synthetic.make_line_texture(
                rng=np.random.default_rng(11)))
        frames = []
        for i, (ts, g, d, R, t) in enumerate(
                bars.sequence(n_frames=N_LINES_NOISE_FRAMES)):
            noise = np.random.default_rng(77 + i).normal(
                0, 0.006, d.shape).astype(np.float32)
            frames.append((ts, g, d + noise * d ** 2, R, t))
        for key, use_lines in (("points", False), ("lines", True)):
            system = System(small, SystemConfig(
                num_features=512, n_levels=4, max_kf=64, max_pts=16384,
                use_lines=use_lines, max_lines=64), device="cuda")
            runs[key] = run = _drive18(torch, f"c {key}", system, frames,
                                       False, brackets, k1_ms_at, words,
                                       line_frames)
            ref = REF_LINES_NOISE[key]
            bound = _ate_bound(ref["ate_rmse_m"])
            kept = [i for i, s_ in enumerate(run["states"])
                    if s_ != OK and ref["states"][i] == OK and i > 0]
            print(f"phase 18c {key}: ATE bound {bound:.6f} m (JAX "
                  f"{ref['ate_rmse_m']:.6f} m); JAX map {ref['map']}")
            if kept:
                _fail(f"phase 18c {key} lost frames {kept} JAX keeps")
            if not run["finite"] or run["ate"] > bound:
                _fail(f"phase 18c {key} ATE {run['ate']} m exceeds the "
                      f"bound {bound} m")
        pts, lns = runs["points"]["ate"], runs["lines"]["ate"]
        ref_lower = (REF_LINES_NOISE["lines"]["ate_rmse_m"]
                     < REF_LINES_NOISE["points"]["ate_rmse_m"])
        print(f"phase 18c: ATE with lines {lns:.6f} m, points only "
              f"{pts:.6f} m (JAX: lines {'lower' if ref_lower else 'not lower'})")
        if (lns < pts) != ref_lower:
            _fail(f"phase 18c: lines ATE {lns} against points {pts}; JAX's "
                  f"with lines {'is' if ref_lower else 'is not'} lower")
    finally:
        lines_mod.detect_lines = detect
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("hamming", "cc_labels", "stereo_wta")}
    print(f"phase 18: launches over the four runs {launches}, "
          f"{sum(r['line_frames'] for r in runs.values())} line frames built")
    return {"launches": launches,
            "k1_err": max(r["k1_err"] for r in runs.values()),
            "k1_device_ms": sum(r["k1_device_ms"] for r in runs.values())}


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
    from plvs_tpu_torch.solvers import pose_opt

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

    poses = _pose_problems(torch)
    pose = _hold_pose(torch, poses)

    (_, a1, b1), (_, a2, b2) = k1_cases[0], k1_cases[5]
    kernel_calls = {
        f"K1 at {a1.shape[0]}x{b1.shape[0]}":
            lambda: hamming.hamming_matrix(a1, b1),
        f"K1 at {a2.shape[0]}x{b2.shape[0]}":
            lambda: hamming.hamming_matrix(a2, b2),
        "K2": lambda: cc_labels.cc_min_labels(init_r, conn_r),
        "K3": lambda: stereo.disparity_wta(cl0, cr0)}
    for label, cam_p, R0_p, t0_p, obs_p in poses:
        kernel_calls[f"pose kernel, {label}"] = (
            lambda c=cam_p, a=R0_p, b=t0_p, o=obs_p:
            pose_opt.pose_optimize(c, a, b, o))
    eager_calls = {
        f"eager pose loop, {label}":
            (lambda c=cam_p, a=R0_p, b=t0_p, o=obs_p:
             pose_opt.pose_optimize_plain(c, a, b, o))
        for label, cam_p, R0_p, t0_p, obs_p in poses}
    ops = _device_ops_per_call(torch, {**kernel_calls, **eager_calls})
    for label in kernel_calls:
        if any(len(o) != 1 for o in ops[label]):
            _fail(f"one call of {label} did not run exactly one device kernel")
    for (label, *_), eager in zip(poses, eager_calls):
        dev_ms = [sum(us for _, us in o) * 1e-3 for o in ops[eager]]
        pose["times"][label]["plain_device_ms"] = float(np.median(dev_ms))
        print(f"phase 1: eager pose loop, {label}: device "
              f"{np.median(dev_ms):.4f} ms a solve over "
              f"{int(np.median([len(o) for o in ops[eager]]))} device ops "
              f"(kernel {pose['times'][label]['ms']:.6f} ms)")

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
    pose_opt.solves = pose_opt.kernel_solves = 0
    states, ms = [], []
    with brackets.run():
        for ts, g, d, _, _ in frames:
            t1 = time.perf_counter()
            state, _, _ = system.track_rgbd(g, d, ts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            states.append(int(state))
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches,
                "stereo_wta": stereo.launches,
                "pose_opt": pose_opt.kernel_solves}
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
    if not 2 * (N_FRAMES - 1) <= pose_opt.kernel_solves == pose_opt.solves:
        _fail(f"the pose kernel ran {pose_opt.kernel_solves} of "
              f"{pose_opt.solves} pose solves on the main path")
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
    run15 = timed(15, _phase15, torch, cam, system, frames, brackets,
                  k1_ms_at, words)
    run16 = timed(16, _phase16, torch, cam, system, frames,
                  launches3.pop("system"), k1_ms_at, words)
    run17 = timed(17, _phase17, torch, cam, frames, k1_ms_at, words)
    run18 = timed(18, _phase18, torch, cam, scene, brackets, k1_ms_at, words)
    launches5, launches6 = run5["launches"], run6["launches"]
    launches7, launches8 = run7["launches"], run8["launches"]
    launches9 = run9["launches"]
    later = {10: run10["launches"], 11: run11["launches"],
             12: run12["launches"], 13: run13["launches"],
             14: run14["launches"], 15: run15["launches"],
             16: run16["launches"], 17: run17["launches"],
             18: run18["launches"]}
    k1_err = max(k1_err, launches3["k1_err"], launches4["k1_err"],
                 run5["k1_err"], run6["k1_err"], run7["k1_err"],
                 run8["k1_err"], run9["k1_err"], run10["k1_err"],
                 run11["k1_err"], run12["k1_err"], run13["k1_err"],
                 run14["k1_err"], run15["k1_err"], run16["k1_err"],
                 run17["k1_err"], run18["k1_err"])

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
         "device_ms_phase13": run13["k1_device_ms"],
         "device_ms_phase15": run15["k1_device_ms"],
         "device_ms_phase18": run18["k1_device_ms"]},
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
        {"name": "pose_optimize", "route": "cuda",
         "source": "plvs_tpu_torch/csrc/pose_opt.cu",
         "replaces": None, "counterpart": "plvs_tpu/solvers/pose_opt.py:130",
         "launches": launches["pose_opt"], "max_abs_err": pose["err"],
         "bound_by": "latency (40 dependent block reductions and 6x6 solves)",
         "library_ms": None, "library": None, "by_shape": pose["times"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
