"""Chip smoke test of plvs_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0 prints the card's name and power limit and builds every CUDA
kernel of the port from ``plvs_tpu_torch/csrc`` (one nvcc per source, all
started together). Phase 1 holds each kernel against its plain PyTorch
version on the card (exact equality: both functions are integer) at the
shapes the main path gives it plus ragged and adversarial inputs, and
times both with CUDA events. Phase 2 drives the port's main path —
``System.track_rgbd``, synchronous RGB-D tracking with points and lines at
640x480, 1024 ORB features, 8 levels, 160 keylines, keyframe backend off —
over bench.py's structured-wall scene, with every launch counter set to 0
just before and read just after, and checks that every frame is tracked
and the trajectory's ATE is within the bound below.

It prints one ``{"kernels": [...]}`` line and ends with one
``{"ok": true, "device": {...}}`` line. Any failed phase exits non-zero; so
does a machine without CUDA, or a directory without the port beside this
file. Imports nothing of jax or plvs_tpu.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# JAX package's ATE-RMSE on this scene and configuration (CPU run of
# scripts/reference_ate_rgbd_lines.py, 120 frames); the port is held to
# max(1.5 x it, it + 1 cm)
REF_ATE_M = 0.0029674518356454585
ATE_BOUND_M = max(1.5 * REF_ATE_M, REF_ATE_M + 0.01)

N_FRAMES = 120
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3
CUDA_CORE_OPS_PER_S = 67e12   # H100 SXM non-tensor peak (float32 figure)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(torch, fn, reps: int = 50, warmup: int = 5) -> float:
    """Median device time of one call (CUDA events around each call)."""
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


def _bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _scene(cam, synthetic):
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    return synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                   tex_scale=420.0)


def _sym_links(mask: np.ndarray, keep: np.ndarray | None = None) -> np.ndarray:
    """Undirected 8-neighbour link bits between valid cells of ``mask``
    (no wrap at the borders); ``keep[ci]`` [H, W] optionally drops links
    (applied symmetrically)."""
    from plvs_tpu_torch.ops.cc_labels import SHIFTS

    h, w = mask.shape
    bits = np.zeros((h, w), np.int32)
    ys, xs = np.mgrid[0:h, 0:w]
    for ci, (sy, sx) in enumerate(SHIFTS):
        ny, nx = ys - sy, xs - sx
        inside = (ny >= 0) & (ny < h) & (nx >= 0) & (nx < w)
        nyc, nxc = np.clip(ny, 0, h - 1), np.clip(nx, 0, w - 1)
        link = inside & mask & mask[nyc, nxc]
        if keep is not None:
            # the opposite direction of (sy, sx) is ci ^ 1 in SHIFTS; a link
            # survives when the lower-index end keeps it
            lo = np.minimum(ys * w + xs, nyc * w + nxc)
            link &= keep[ci // 2].reshape(-1)[lo]
        bits |= link.astype(np.int32) << ci
    return bits


def _spiral(h: int, w: int) -> np.ndarray:
    """One corridor spiralling inward with a one-cell gap between turns."""
    m = np.zeros((h, w), bool)
    y, x, dy, dx = 0, 0, 0, 1
    m[0, 0] = True
    stuck = 0
    while stuck < 2:
        ny, nx, fy, fx = y + dy, x + dx, y + 2 * dy, x + 2 * dx
        ahead_free = (0 <= ny < h and 0 <= nx < w and not m[ny, nx]
                      and not (0 <= fy < h and 0 <= fx < w and m[fy, fx]))
        if ahead_free:
            y, x, stuck = ny, nx, 0
            m[y, x] = True
        else:
            dy, dx, stuck = dx, -dy, stuck + 1
    return m


def _adversarial_grids(h: int, w: int, rng):
    """(name, mask, conn_bits): grids that defeat a bounded sweep count."""
    grids = []
    full = np.ones((h, w), bool)
    grids.append(("full_grid", full, _sym_links(full)))
    empty = np.zeros((h, w), bool)
    grids.append(("empty", empty, np.zeros((h, w), np.int32)))
    stair = np.zeros((h, w), bool)   # one diagonal staircase, corner links
    for i in range(min(h, w)):
        stair[i, i] = True
    grids.append(("diagonal_staircase", stair, _sym_links(stair)))
    spiral = _spiral(h, w)
    grids.append(("spiral", spiral, _sym_links(spiral)))
    rmask = rng.random((h, w)) < 0.55
    keep = rng.random((4, h, w)) < 0.6
    grids.append(("random_links", rmask, _sym_links(rmask, keep)))
    return grids


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
    from plvs_tpu_torch.ops import _build, cc_labels, hamming
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

    # main-path shapes: point searches are [candidate bucket 512..4096] x
    # [1024 keypoints]; the line match is [line bucket 128..512] x [160]
    k1_cases = [("4096x1024", words(4096), words(1024)),
                ("512x1024", words(512), words(1024)),
                ("512x160", words(512), words(160)),
                ("128x160", words(128), words(160)),
                ("160x512", words(160), words(512)),
                ("1x1", words(1), words(1)),
                ("1000x999", words(1000), words(999)),
                ("zeros_vs_ones", words(300, 0), words(257, 0xFFFFFFFF)),
                ("ones_vs_ones", words(65, 0xFFFFFFFF), words(130, 0xFFFFFFFF))]
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
    a, b = k1_cases[0][1], k1_cases[0][2]
    q, k = a.shape[0], b.shape[0]
    k1_ms = _time_ms(torch, lambda: hamming.hamming_matrix(a, b))
    k1_plain_ms = _time_ms(torch, lambda: hamming.hamming_plain(a, b))
    shifts = torch.arange(32, device=dev)
    bq = ((a.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(q, 256).float()
    bk = ((b.to(torch.int64)[:, :, None] >> shifts) & 1).reshape(k, 256).float()
    if not torch.equal(torch.cdist(bq, bk, p=0).to(torch.int32),
                       hamming.hamming_matrix(a, b)):
        _fail("the torch.cdist(p=0) yardstick disagrees with K1")
    k1_lib_ms = _time_ms(torch, lambda: torch.cdist(bq, bk, p=0))
    k1_bound, k1_by = _bound_ms((q + k) * 32 + q * k * 4, q * k * 24)
    print(f"phase 1: K1 at {q}x{k}: kernel {k1_ms:.4f} ms, plain "
          f"{k1_plain_ms:.4f} ms, torch.cdist(p=0) {k1_lib_ms:.4f} ms, bound "
          f"{k1_bound:.4f} ms ({k1_by})")

    R0, t0_ = synthetic.default_trajectory(N_FRAMES)[0]
    g0, d0 = scene.render(R0, t0_)
    g8, _ = _quantize(g0, d0)
    gray = torch.from_numpy(g8).to(dev).float()
    _, _, init_r, conn_r = lines_mod.connectivity_grid(gray)
    h2, w2 = init_r.shape
    ref_cap = -(-((h2 + w2) // 3) // 8)
    k2_cases = [("frame_640x480", init_r, conn_r)]
    sentinel = h2 * w2
    for name, mask, bits in _adversarial_grids(h2, w2, rng):
        init = np.where(mask, np.arange(h2 * w2).reshape(h2, w2), sentinel)
        k2_cases.append((name, torch.from_numpy(init.astype(np.int32)).to(dev),
                         torch.from_numpy(bits).to(dev)))
    k2_err = 0
    for name, init, conn in k2_cases:
        got = cc_labels.cc_min_labels(init, conn)
        ref = cc_labels.cc_min_labels_plain(init, conn, max_chunks=None)
        capped = cc_labels.cc_min_labels_plain(init, conn, max_chunks=ref_cap)
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - ref).abs().max())
        k2_err = max(k2_err, err)
        print(f"phase 1: K2 cc_min_labels {name}: max_abs_err {err} vs the "
              f"converged plain version; plain with the reference cap of "
              f"{ref_cap} chunks {'agrees' if torch.equal(got, capped) else 'stops short'}")
        if err:
            _fail(f"K2 disagrees with its plain version on {name}")
    k2_ms = _time_ms(torch, lambda: cc_labels.cc_min_labels(init_r, conn_r))
    k2_plain_ms = _time_ms(torch, lambda: cc_labels.cc_min_labels_plain(
        init_r, conn_r, ref_cap))
    n_links = int(sum(((conn_r >> ci) & 1).sum() for ci in range(8)))
    k2_bound, k2_by = _bound_ms(12 * h2 * w2, 8 * h2 * w2 + 4 * n_links)
    print(f"phase 1: K2 at {h2}x{w2}: kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain_ms:.4f} ms, bound {k2_bound:.6f} ms ({k2_by}); no "
          "single PyTorch call computes connected components")

    # -- phase 2: the port's main path -------------------------------------
    cfg = SystemConfig(num_features=1024, n_levels=8, scale=1.2, max_kf=256,
                       max_pts=65536, use_lines=True, max_lines=160,
                       local_ba=False, loop_closing=False,
                       dense_mapping=False, pipelined=False,
                       depth_upload_decimation=2)
    system = System(cam, cfg, device="cuda")
    frames = list(scene.sequence(n_frames=N_FRAMES))
    hamming.launches = 0
    cc_labels.launches = 0
    states, ms = [], []
    for ts, g, d, _, _ in frames:
        t1 = time.perf_counter()
        state, _, _ = system.track_rgbd(g, d, ts)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t1) * 1e3)
        states.append(int(state))
    launches = {"hamming": hamming.launches, "cc_labels": cc_labels.launches}
    est = system.trajectory_tum()[:, 1:4]
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(est, gt, align=True)
    steady = np.asarray(ms[1:])
    print(f"phase 2: {N_FRAMES} frames 640x480, per-frame ms p50 "
          f"{np.percentile(steady, 50):.2f} p90 {np.percentile(steady, 90):.2f} "
          f"(first frame {ms[0]:.1f}); map {system.map_statistics()}; ATE-RMSE "
          f"{ate:.6f} m (bound {ATE_BOUND_M:.6f} m); launches {launches}")
    if not all(s == OK for s in states[1:]):
        _fail(f"tracking states {states}")
    if launches["hamming"] < 2 * (N_FRAMES - 1):
        _fail(f"K1 launched {launches['hamming']} times on the main path")
    if launches["cc_labels"] < N_FRAMES:
        _fail(f"K2 launched {launches['cc_labels']} times on the main path")
    if not np.isfinite(est).all() or ate > ATE_BOUND_M:
        _fail(f"ATE {ate} m exceeds the bound {ATE_BOUND_M} m")

    kernels = [
        {"name": "hamming_matrix", "route": "cuda",
         "source": "plvs_tpu_torch/csrc/hamming.cu",
         "replaces": "plvs_tpu/ops/hamming.py:84",
         "launches": launches["hamming"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1_lib_ms},
        {"name": "cc_min_labels", "route": "cuda",
         "source": "plvs_tpu_torch/csrc/cc_labels.cu",
         "replaces": "plvs_tpu/ops/cc_labels.py:95",
         "launches": launches["cc_labels"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
