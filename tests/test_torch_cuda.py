"""The port's CUDA kernels on the card, held against their plain versions.

These tests need a CUDA card and skip without one. They import nothing of
jax or plvs_tpu, so they also run on a GPU machine that has no jax:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q

K1 and K2 compute integer functions, and K3's float steps are rounded once
each in the same order in the kernel and its plain version, so every
comparison is exact. K2 runs at every half-resolution grid of the cameras
the repo configures and on grids that defeat a bounded sweep count; K3 at
D in {3, 16, 64, 128}, r in {1, 2, 3}, ragged, main-path and KITTI shapes.
The keyframe backend's bundle adjustment and one local-mapper pass run on
the card against the same code on the CPU, and so do place recognition's
vocabulary descent (exact), the pose graph (under sync-debug mode: no host
read inside the solve) and one loop-closer pass. The pipelined runtime's
helper-thread fetch is held to a synchronous copy, and a pipelined run with
its threads and a run with the mapper actor go through the card. The
inertial path: preintegration, the inertial-only initialization and the VI
BA against the CPU (the two solves under sync-debug mode), and an RGB-D +
IMU System through the pipelined runtime. Slice 9: the KB8 rig's frame,
SGM disparity, the segmentation's edge stage and capped fill, and the
ESDF's jump flooding, each on the card against the CPU. Slice 10: the
per-level ORB path, the two-view reconstruction, the PnP RANSAC and the
plane-homography RANSAC (from the same samples), each on the card against
the CPU, K1 at the monocular path's [512] x [1024] and the template's
[345] x [1024], and a monocular System on the card.
"""

import math

import numpy as np
import pytest
import torch

from plvs_tpu_torch import convert
from plvs_tpu_torch.features import lines
from plvs_tpu_torch.geometry import cameras, lie
from plvs_tpu_torch.io import synthetic
from plvs_tpu_torch.dense import stereo_depth
from plvs_tpu_torch.ops import cc_labels, hamming, stereo
from plvs_tpu_torch.slam import LocalMapper, System, SystemConfig
from plvs_tpu_torch.slam import keyframe_database, loop_closing
from plvs_tpu_torch.solvers import ba, pose_graph
from plvs_tpu_torch.vocab import bow

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _words(rng, n, dev):
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(dev)


# phase 2's shapes, then the edges of K1's 16 x 8 fragments, 16 x 32 warp
# tiles and 16 x 128 blocks, then the keyframe backend's stacked shapes
# (line matches [128] x [128 per neighbour], fuse [points] x [1024 per
# neighbour])
K1_SHAPES = [(4096, 1024), (2048, 1024), (1024, 1024), (512, 160),
             (256, 160), (128, 160), (1, 1), (15, 7), (17, 9), (63, 65),
             (129, 257), (1000, 999), (4097, 1023), (128, 128), (128, 512),
             (1024, 5120), (777, 3072), (512, 1024), (345, 1024)]
# (q, k, kind of words): random words at every shape, the other kinds at
# the small main-path shapes and across the edges
K1_CASES = ([(q, k, "random") for q, k in K1_SHAPES]
            + [(q, k, kind) for q, k in K1_SHAPES[3:] if q * k < 4 * 10 ** 6
               for kind in ("zeros_vs_ones", "ones_vs_ones", "high_bit_set",
                            "strided_view")])


def _k1_inputs(rng, q, k, kind, dev):
    if kind == "random":
        return _words(rng, q, dev), _words(rng, k, dev)
    if kind == "zeros_vs_ones":
        return (torch.zeros((q, 8), dtype=torch.int32, device=dev),
                torch.full((k, 8), -1, dtype=torch.int32, device=dev))
    if kind == "ones_vs_ones":
        return (torch.full((q, 8), -1, dtype=torch.int32, device=dev),
                torch.full((k, 8), -1, dtype=torch.int32, device=dev))
    if kind == "high_bit_set":   # negative int32 words
        return _words(rng, q, dev) | -2 ** 31, _words(rng, k, dev) | -2 ** 31
    return _words(rng, 3 * q, dev)[::3], _words(rng, 2 * k, dev)[1::2]


@pytest.mark.parametrize("q,k,kind", K1_CASES)
def test_hamming_kernel_matches_plain(dev, q, k, kind):
    rng = np.random.default_rng(q * 7919 + k)
    a, b = _k1_inputs(rng, q, k, kind, dev)
    before = hamming.launches
    got = hamming.hamming_matrix(a, b)
    assert hamming.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.int32
    ref = hamming.hamming_plain(a, b)
    assert torch.equal(got, ref)
    if kind == "zeros_vs_ones":
        assert bool((got == 256).all())
    if kind == "ones_vs_ones":
        assert bool((got == 0).all())


K1_PROFILED = [(4096, 1024), (128, 160)]


@pytest.fixture(scope="module")
def k1_device_ops():
    """The device ops of calls of K1 at each K1_PROFILED shape, from ONE
    torch.profiler session (a second session in a process has seen no
    device events at all). Call i follows a spin kernel of 50k x 4^i
    cycles and a longer one closes each of 4 rounds, so a marker's length
    names the call after it; CUPTI now and then drops an event, so only
    calls with both bounding markers present are kept. Returns their op
    names by shape, and the markers as read (for a failure's message)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    inputs = [(_words(rng, q, dev), _words(rng, k, dev))
              for q, k in K1_PROFILED]
    n, cycles = len(inputs), 50_000
    for a, b in inputs:
        hamming.hamming_matrix(a, b)
    # a first long spin loads the spin kernel (lazily, which would fall
    # inside the timed pair) and raises the clocks
    torch.cuda._sleep(200_000_000)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles * 4 ** n)
    end.record()
    end.synchronize()
    us_per_cycle = start.elapsed_time(end) * 1e3 / (cycles * 4 ** n)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            for i, (a, b) in enumerate(inputs):
                torch.cuda._sleep(cycles * 4 ** i)
                hamming.hamming_matrix(a, b)
            torch.cuda._sleep(cycles * 4 ** n)
            torch.cuda.synchronize()
    segments = []
    for e in sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        if "spin_kernel" in e.name:
            x = math.log(e.time_range.elapsed_us()
                         / (cycles * us_per_cycle), 4)
            segments.append((round(x) if abs(x - round(x)) < 0.25 else -1,
                             [], e.time_range.elapsed_us()))
        elif segments:
            segments[-1][1].append(e.name)
    per_call = {shape: [] for shape in K1_PROFILED}
    for (i, names, _), (j, _, _) in zip(segments, segments[1:]):
        if 0 <= i < n and j == i + 1:
            per_call[K1_PROFILED[i]].append(names)
    marks = [(i, us) for i, _, us in segments]
    return per_call, f"markers (index, us) {marks}, {us_per_cycle} us a cycle"


@pytest.mark.parametrize("q,k", K1_PROFILED)
def test_hamming_kernel_is_one_device_kernel(k1_device_ops, q, k):
    per_call, marks = k1_device_ops
    calls = per_call[(q, k)]
    assert calls, f"no call traced with both of its markers: {marks}"
    for names in calls:
        assert len(names) == 1 and "hamming_bmma_kernel" in names[0], names


def test_cc_kernel_matches_plain_on_a_frame(dev):
    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    tex = synthetic.make_structured_texture(
        2048, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=420.0)
    R, t = synthetic.default_trajectory(120)[40]
    g, _ = scene.render(R, t)
    gray = torch.from_numpy(
        np.clip(g, 0, 255).astype(np.uint8).astype(np.float32)).to(dev)
    _, _, init, conn = lines.connectivity_grid(gray)
    before = cc_labels.launches
    got = cc_labels.cc_min_labels(init, conn)
    assert cc_labels.launches == before + 1
    assert torch.equal(got, cc_labels.cc_min_labels_plain(init, conn, None))


# K2's cluster holds up to 232,448 cells: every grid below fits, the last
# ones are 640x480's, EuRoC's, KITTI's and 1280x720's half-resolution grids
CC_SHAPES = [(96, 160), (1, 1), (1, 320), (240, 1), (240, 320), (240, 376),
             (188, 620), (360, 640)]


@pytest.mark.parametrize("h,w", CC_SHAPES)
def test_cc_kernel_matches_plain_on_random_links(dev, h, w):
    """Symmetric random links, cyclic across both borders."""
    rng = np.random.default_rng(3)
    mask = rng.random((h, w)) < 0.6
    init = np.where(mask, rng.permutation(h * w).reshape(h, w),
                    h * w).astype(np.int32)
    bits = np.zeros((h, w), np.int32)
    ys, xs = np.mgrid[0:h, 0:w]
    for ci in range(0, 8, 2):          # symmetric links, both directions
        sy, sx = cc_labels.SHIFTS[ci]
        ny, nx = (ys - sy) % h, (xs - sx) % w
        link = mask & mask[ny, nx] & (rng.random((h, w)) < 0.5)
        bits |= link.astype(np.int32) << ci
        back = np.zeros((h, w), bool)
        back[ny[link], nx[link]] = True
        bits |= back.astype(np.int32) << (ci + 1)
    ti = torch.from_numpy(init).to(dev)
    tb = torch.from_numpy(bits).to(dev)
    before = cc_labels.launches
    got = cc_labels.cc_min_labels(ti, tb)
    assert cc_labels.launches == before + 1
    assert torch.equal(got, cc_labels.cc_min_labels_plain(ti, tb, None))


@pytest.mark.parametrize("h,w", CC_SHAPES[1:])
@pytest.mark.parametrize("grid", ["full_grid", "empty", "diagonal_staircase",
                                  "spiral", "random_links",
                                  "random_wrapping_links"])
def test_cc_kernel_matches_plain_on_adversarial_grids(dev, grid, h, w):
    grids = {name: (init, bits) for name, init, bits in
             synthetic.cc_grids(h, w, np.random.default_rng(h * 1000 + w))}
    init, bits = (torch.from_numpy(a).to(dev) for a in grids[grid])
    assert torch.equal(cc_labels.cc_min_labels(init, bits),
                       cc_labels.cc_min_labels_plain(init, bits, None))


@pytest.mark.parametrize("extra", [0, 1])
def test_cc_kernel_capacity(dev, extra):
    """A grid of exactly the cluster's capacity runs; one cell more is
    refused before any launch."""
    h, w = 8, cc_labels.CLUSTER_CAPACITY // 8 + extra
    rng = np.random.default_rng(5)
    init = torch.from_numpy(rng.permutation(h * w).reshape(h, w).astype(
        np.int32)).to(dev)
    mask = rng.random((h, w)) < 0.7
    bits = torch.from_numpy(synthetic.link_bits(mask)).to(dev)
    if extra:
        before = cc_labels.launches
        with pytest.raises(ValueError, match="capacity"):
            cc_labels.cc_min_labels(init, bits)
        assert cc_labels.launches == before
    else:
        assert torch.equal(cc_labels.cc_min_labels(init, bits),
                           cc_labels.cc_min_labels_plain(init, bits, None))


@pytest.mark.parametrize("r", [1, 2, 3])
@pytest.mark.parametrize("d", [3, 16, 64, 128])
@pytest.mark.parametrize("h,w,census", [(37, 150, "random"),
                                        (480, 640, "shifted"),
                                        (481, 641, "shifted"),
                                        (376, 1241, "shifted")])
def test_stereo_wta_kernel_matches_plain(dev, h, w, census, d, r):
    rng = np.random.default_rng(h + w + d)
    if census == "random":
        cl, cr = (torch.from_numpy(rng.integers(
            0, 2 ** 32, (h, w), dtype=np.uint64).astype(np.uint32).view(
                np.int32)).to(dev) for _ in range(2))
    else:
        base = rng.uniform(0, 255, (h, w + 16)).astype(np.float32)
        left = torch.from_numpy(base[:, 8:w + 8]).to(dev)
        right = torch.from_numpy(base[:, 15:w + 15]).to(dev)  # disparity 7
        cl = stereo_depth.census_transform(left)
        cr = stereo_depth.census_transform(right)
    before = stereo.launches
    got = stereo.disparity_wta(cl, cr, max_disp=d, agg_radius=r)
    assert stereo.launches == before + 1
    assert got.device.type == "cuda" and got.dtype == torch.float32
    ref = stereo.disparity_wta_plain(cl, cr, max_disp=d, agg_radius=r)
    assert torch.equal(got, ref)
    if census == "shifted" and d >= 16:
        assert (got > 0).float().mean() > 0.9


def test_stereo_wta_kernel_rejects_a_textureless_pair(dev):
    flat = stereo_depth.census_transform(torch.zeros((480, 640), device=dev))
    got = stereo.disparity_wta(flat, flat)
    assert torch.equal(got, stereo.disparity_wta_plain(flat, flat))
    assert bool((got < 0).all())


# -- the keyframe backend -----------------------------------------------------

def _ba_problem(seed: int = 0) -> dict:
    """A padded stereo window with lines, numpy fields of a BAProblem: 6
    cameras along a 1.5 m track (2 fixed, 2 padding), 300 points 2-5 m
    ahead each seen at least twice, 40 lines with endpoint depths."""
    rng = np.random.default_rng(seed)
    K, P, L, fx, bf = 6, 300, 40, 520.0, 40.0
    so3 = lambda s: lie.so3_exp(torch.from_numpy(  # noqa: E731
        (rng.normal(size=3) * s).astype(np.float32))).numpy()
    R = np.stack([so3(0.05) for _ in range(K)])
    t = (np.stack([[-0.3 * k, 0, 0] for k in range(K)])
         + rng.normal(size=(K, 3)) * 0.02).astype(np.float32)
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                  rng.uniform(2.0, 5.0, P)], -1).astype(np.float32)

    def proj(k, Xw):
        Xc = Xw @ R[k].T + t[k]
        return Xc[..., :2] / Xc[..., 2:] * fx + np.array([320.0, 240.0]), \
            Xc[..., 2]

    rows = []
    for k in range(K):
        uv, z = proj(k, X)
        for i in np.nonzero((uv[:, 0] >= 0) & (uv[:, 0] < 640)
                            & (uv[:, 1] >= 0) & (uv[:, 1] < 480)
                            & (rng.uniform(size=P) > 0.3))[0]:
            u = uv[i] + rng.normal(size=2) * 0.3
            rows.append((k, i, u[0], u[1], u[0] - bf / z[i]))
    rows = np.asarray(rows)
    keep = np.bincount(rows[:, 1].astype(int), minlength=P)[
        rows[:, 1].astype(int)] >= 2
    rows = rows[keep]
    Xs = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                   rng.uniform(2.0, 4.5, L)], -1).astype(np.float32)
    d = rng.normal(size=(L, 3))
    d[:, 2] = np.sign(d[:, 2]) * (1.0 + np.abs(d[:, 2]))
    Xe = (Xs + 0.8 * d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)
    lrows = []
    for k in range(K):
        (sp, zs), (ep, ze) = proj(k, Xs), proj(k, Xe)
        for j in range(L):
            dv = ep[j] - sp[j]
            n = np.array([-dv[1], dv[0]]) / np.linalg.norm(dv)
            lrows.append((k, j, n[0], n[1], -n @ sp[j] + rng.normal() * 0.3,
                          zs[j], ze[j]))
    lrows = np.asarray(lrows)
    for k in range(2, K):
        R[k] = so3(0.01) @ R[k]
        t[k] += (rng.normal(size=3) * 0.03).astype(np.float32)
    pad = lambda a, n, fill: np.concatenate(  # noqa: E731
        [a, np.full((n,) + a.shape[1:], fill, a.dtype)])
    M, Ml = len(rows), len(lrows)
    cam_id = np.arange(K + 2)
    return dict(
        R=np.concatenate([R, np.eye(3, dtype=np.float32)[None].repeat(2, 0)]),
        t=pad(t, 2, 0.0), fixed_cam=(cam_id < 2) | (cam_id >= K),
        cam_mask=cam_id < K,
        points=pad((X + rng.normal(size=(P, 3)) * 0.05).astype(np.float32),
                   16, 0.0),
        point_mask=pad(np.bincount(rows[:, 1].astype(int), minlength=P)
                       >= 2, 16, False),
        obs_cam=pad(rows[:, 0].astype(np.int64), 64, 0),
        obs_pt=pad(rows[:, 1].astype(np.int64), 64, 0),
        obs_uvr=pad(rows[:, 2:5].astype(np.float32), 64, -1.0),
        obs_inv_sigma2=pad(np.ones(M, np.float32), 64, 1.0),
        obs_mask=pad(np.ones(M, bool), 64, False),
        lines_Xs=(Xs + rng.normal(size=(L, 3)) * 0.03).astype(np.float32),
        lines_Xe=(Xe + rng.normal(size=(L, 3)) * 0.03).astype(np.float32),
        line_mask=np.ones(L, bool),
        lobs_cam=lrows[:, 0].astype(np.int64),
        lobs_line=lrows[:, 1].astype(np.int64),
        lobs_nld=lrows[:, 2:5].astype(np.float32),
        lobs_inv_sigma2=np.ones(Ml, np.float32), lobs_mask=np.ones(Ml, bool),
        lobs_depth=lrows[:, 5:7].astype(np.float32))


def test_bundle_adjust_on_cuda_matches_cpu(dev):
    """The same solve on the card and on the CPU: poses and points within
    1e-4, line endpoints within 1e-3 (tests/test_torch_ba.py's tolerances:
    the card sums in another order), lam equal; the solve reads nothing
    back to the host (a synchronising call under sync-debug mode raises)."""
    fields = _ba_problem()
    cam = cameras.pinhole(520.0, 520.0, 320.0, 240.0, width=640, height=480,
                          bf=40.0)
    cpu = ba.bundle_adjust(cam, convert.ba_problem_from_numpy(fields, "cpu"),
                           num_iters=5, cg_iters=14)
    prob = convert.ba_problem_from_numpy(fields, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu = ba.bundle_adjust(cam, prob, num_iters=5, cg_iters=14)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for a, b, tol in zip(gpu[:5], cpu[:5], (1e-4, 1e-4, 1e-4, 1e-3, 1e-3)):
        torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=0)
    assert float(gpu[5]["lam"]) == float(cpu[5]["lam"])
    assert float(gpu[5]["cost"]) < float(gpu[5]["cost0"])
    assert abs(float(gpu[5]["cost"]) - float(cpu[5]["cost"])) <= \
        1e-3 * float(cpu[5]["cost"])


def _store_state(store) -> dict:
    return {k: (v.copy() if isinstance(v, np.ndarray) else dict(v)
                if isinstance(v, dict) else v)
            for k, v in vars(store).items()
            if isinstance(v, (np.ndarray, dict, int))}


def test_local_mapper_pass_on_cuda_matches_cpu(dev):
    """A map built by the port on the CPU (16 RGB-D frames at 320x240, a
    keyframe every 3 frames, backend on); its last keyframe's backend pass
    replayed on the card and on the CPU from the same store: the
    bookkeeping exact, poses within 1e-2 and points within 0.1 m (the
    window's solve is ill-conditioned in directions 5 LM x 14 CG leaves
    unconverged; tests/test_torch_local_mapping.py)."""
    cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                          bf=24.0)
    cfg = SystemConfig(num_features=512, n_levels=4, max_kf=64,
                       max_pts=16384, use_lines=True, max_lines=64,
                       local_ba=True, loop_closing=False, pipelined=False,
                       depth_upload_decimation=2, backend_fixed_shapes=True,
                       max_kf_interval=3)
    system = System(cam, cfg, device="cpu")
    passes = []
    orig = system.local_mapper.process_keyframe_stages

    def recording(kf_id, extra_fetch=None, submit=None):
        passes.append((kf_id, _store_state(system.store)))
        return (yield from orig(kf_id, extra_fetch=extra_fetch,
                                submit=submit))

    system.local_mapper.process_keyframe_stages = recording
    tex = synthetic.make_structured_texture(
        1024, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=220.0)
    for ts, g, d, _, _ in scene.sequence(synthetic.default_trajectory(36)[
            :16]):
        system.track_rgbd(g, d, ts)
    kf_id, before = passes[-1]
    out = {}
    for where in ("cpu", dev):
        st = convert.map_store_from_numpy(before)
        mapper = LocalMapper(cam, st, scale=1.2, n_levels=4, use_lines=True,
                             fixed_shapes=True, device=where)
        mapper.process_keyframe(kf_id)
        assert len(mapper.ba_log) == 1
        out[str(where)] = st
    a, b = out["cpu"], out[str(dev)]
    for name in ("kf_mask", "pt_mask", "ln_mask", "kf_kp_pt", "kf_kl_line",
                 "pt_n_obs", "ln_n_obs", "pt_desc", "ln_desc"):
        np.testing.assert_array_equal(getattr(b, name), getattr(a, name),
                                      err_msg=name)
    live, pts = a.kf_mask, a.pt_mask
    np.testing.assert_allclose(b.kf_R[live], a.kf_R[live], atol=1e-2)
    np.testing.assert_allclose(b.kf_t[live], a.kf_t[live], atol=1e-2)
    np.testing.assert_allclose(b.pt_xyz[pts], a.pt_xyz[pts], atol=0.1)


def test_bow_descent_on_cuda_matches_cpu(dev):
    """Word ids of 1024 random descriptors through the shipped 100k tree
    and a small trained tree, on the card and on the CPU: exact."""
    rng = np.random.default_rng(0)
    d = _words(rng, 1024, "cpu")
    trained = bow.train(
        rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint64).astype(
            np.uint32), k=8, depth=3, seed=0)
    for voc in (bow.load_vocabulary(keyframe_database._DEFAULT_VOCAB),
                trained):
        got = bow.quantize(voc, d.to(dev))
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), bow.quantize(voc, d))


def _pose_chain(K: int = 24, drift: float = 0.02, seed: int = 0):
    """An odometry circle with drift and one loop edge back to the start
    (tests/test_loop.py's construction, in the port's own lie)."""
    rng = np.random.default_rng(seed)
    gt_R = lie.so3_exp(torch.tensor(
        [[0.0, 2 * np.pi * k / K, 0.0] for k in range(K)],
        dtype=torch.float32))
    C = torch.tensor([[np.sin(2 * np.pi * k / K) * 3, 0.0,
                       3 - np.cos(2 * np.pi * k / K) * 3] for k in range(K)],
                     dtype=torch.float32)
    gt_t = -(gt_R @ C[..., None])[..., 0]
    one = torch.ones(K)
    pairs = torch.stack([torch.arange(1, K), torch.arange(0, K - 1)], -1)
    eR, et, es = pose_graph.make_edges_from_poses(gt_R, gt_t, one, pairs)
    noise = lie.so3_exp(torch.from_numpy(
        (rng.normal(size=(K - 1, 3)) * drift).astype(np.float32)))
    eR = eR @ noise
    et = et + torch.from_numpy((rng.normal(size=(K - 1, 3))
                                * drift).astype(np.float32))
    R, t = [gt_R[0]], [gt_t[0]]
    for k in range(K - 1):
        R.append(eR[k] @ R[-1])
        t.append(eR[k] @ t[-1] + et[k])
    lR, lt, ls = pose_graph.make_edges_from_poses(
        gt_R, gt_t, one, torch.tensor([[K - 1, 0]]))
    fixed = torch.zeros(K, dtype=torch.bool)
    fixed[0] = True
    E = K
    return pose_graph.PoseGraphProblem(
        torch.stack(R), torch.stack(t), one, fixed,
        torch.cat([pairs[:, 0], torch.tensor([K - 1])]),
        torch.cat([pairs[:, 1], torch.tensor([0])]),
        torch.cat([eR, lR]), torch.cat([et, lt]), torch.cat([es, ls]),
        torch.ones(E), torch.ones(E, dtype=torch.bool))


def test_pose_graph_on_cuda_matches_cpu(dev):
    """12 LM x 50 CG on the card, with no host read inside the solve
    (sync-debug mode "error"), against the CPU: poses within 1e-3 (the
    two devices' float32 sums and autodiff order differ; the JAX parity
    test holds the CPU solve to 1e-3 as well)."""
    prob = _pose_chain()
    R0, t0, _, info0 = pose_graph.optimize(prob, num_iters=12, cg_iters=50,
                                           fix_scale=True)
    probd = pose_graph.PoseGraphProblem(*(a.to(dev) for a in prob))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        R1, t1, _, info1 = pose_graph.optimize(probd, num_iters=12,
                                               cg_iters=50, fix_scale=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(info1["cost"]) < 0.05 * float(info1["cost0"])
    np.testing.assert_allclose(R1.cpu().numpy(), R0.numpy(), atol=1e-3)
    np.testing.assert_allclose(t1.cpu().numpy(), t0.numpy(), atol=1e-3)


def test_loop_closer_pass_on_cuda_matches_cpu(dev):
    """A 12-frame sweep mapped by the port on the CPU, then a manufactured
    drifted revisit of keyframe 0 (tests/test_slam_e2e.py's construction)
    closed on the card and on the CPU from the same store: the same
    candidate, inliers within 10% (each device draws its own RANSAC
    samples) and corrected keyframe translations within 2 cm."""
    cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                          bf=24.0)
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, seed=4, tex_size=2048,
                                    tex_scale=220.0)
    poses = [(np.eye(3, dtype=np.float32),
              -np.array([0.1 * i, 0.0, 0.0], np.float32)) for i in range(12)]
    system = System(cam, SystemConfig(
        num_features=512, n_levels=4, max_kf=32, max_pts=16384,
        max_kf_interval=5, loop_closing=False), device="cpu")
    for ts, g, d, _, _ in scene.sequence(poses=poses):
        system.track_rgbd(g, d, ts)
    st = system.store
    kf_new = st.alloc_kf()
    st.kf_mask[kf_new] = True
    st.kf_frame_id[kf_new] = 1000
    st.kf_R[kf_new] = st.kf_R[0]
    st.kf_t[kf_new] = st.kf_t[0] + np.array([0.25, 0.1, -0.15], np.float32)
    for a in ("kf_kp_xy", "kf_kp_uvr", "kf_kp_desc", "kf_kp_octave",
              "kf_kp_angle", "kf_kp_mask"):
        getattr(st, a)[kf_new] = getattr(st, a)[0]
    sel = np.nonzero(st.kf_kp_mask[0] & (st.kf_kp_pt[0] >= 0))[0]
    old = st.kf_kp_pt[0][sel]
    new = st.alloc_pts(len(sel))
    Rwc = st.kf_R[kf_new].T
    st.pt_xyz[new] = (st.pt_xyz[old] @ st.kf_R[0].T + st.kf_t[0]) @ Rwc.T \
        - Rwc @ st.kf_t[kf_new]
    st.pt_desc[new] = st.pt_desc[old]
    st.pt_mask[new] = True
    st.pt_ref_kf[new] = st.pt_first_kf[new] = kf_new
    st.add_observations(kf_new, new, sel)
    state = _store_state(st)
    out = {}
    for where in ("cpu", dev):
        s2 = convert.map_store_from_numpy(state)
        db = keyframe_database.KeyFrameDatabase(s2, device=where)
        for k in np.nonzero(s2.kf_mask)[0]:
            if k != kf_new:
                db.add(int(k))
        closer = loop_closing.LoopCloser(s2, kfdb=db, cam=cam, device=where,
                                         required_coincidences=1)
        info = closer.process_keyframe(kf_new)
        assert info is not None
        out[str(where)] = (s2, info)
    (a, ia), (b, ib) = out["cpu"], out[str(dev)]
    assert ib["candidate"] == ia["candidate"] == 0
    assert abs(ib["inliers"] - ia["inliers"]) <= 0.1 * ia["inliers"]
    live = a.kf_mask
    np.testing.assert_allclose(b.kf_t[live], a.kf_t[live], atol=0.02)


# ---------------------------------------------------------------------------
# the pipelined runtime
# ---------------------------------------------------------------------------

def test_helper_fetch_matches_a_synchronous_copy(dev):
    """The helper thread's event-gated fetch of a tree of device outputs
    equals a synchronous .cpu() of them, with more work queued on the
    stream after the fetch (which the helper thread does not wait for)."""
    from plvs_tpu_torch.utils.fetch import HelperFetch

    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1024, 1024), device=dev, generator=g)
    y = x @ x
    fetch = HelperFetch(dev, 1)
    try:
        fut = fetch((y, {"sum": y.sum(), "ids": torch.arange(7, device=dev)},
                     None))
        for _ in range(20):
            x = x @ x.T * 1e-3   # queued after the fetch
        got = fut.result()
    finally:
        fetch.shutdown()
    np.testing.assert_array_equal(got[0], y.cpu().numpy())
    assert got[1]["sum"] == y.sum().item()
    np.testing.assert_array_equal(got[1]["ids"], np.arange(7))
    assert got[2] is None


def _small_scene():
    cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                          bf=24.0)
    tex = synthetic.make_structured_texture(
        1024, rng=np.random.default_rng(7))
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, texture=tex,
                                    tex_scale=220.0)
    return cam, list(scene.sequence(synthetic.default_trajectory(36)[:16]))


def test_pipelined_run_with_overlap_thread_on_cuda(dev):
    """16 frames at 320x240 through bench.py's runtime on the card
    (pipelined at depth 4, the overlap thread, the interleaved backend with
    its helper threads, dense mapping): every frame resolves, tracked, the
    queues are empty after shutdown, and the ATE is under
    tests/test_torch_pipelined.py's 3 cm for the same run with threads on
    the CPU (which frames resolve together follows timing, so the two runs
    are not compared frame by frame)."""
    from plvs_tpu_torch.io import evaluation

    cam, frames = _small_scene()
    cfg = SystemConfig(num_features=512, n_levels=4, max_kf=64,
                       max_pts=16384, use_lines=True, max_lines=64,
                       dense_mapping=True, dense_voxel_size=0.04,
                       backend_fixed_shapes=True, pipelined=True,
                       pipeline_depth=4, pipeline_overlap=True)
    system = System(cam, cfg, device=dev)
    resolved = []
    post = system._post_track

    def recording(res, ts, payload=None):
        resolved.append(int(res.state))
        return post(res, ts, payload)

    system._post_track = recording
    for ts, g, d, _, _ in frames:
        system.track_rgbd(g, d, ts)
    assert system.tracker._fetch_pool is not None
    system.shutdown()
    assert len(system.trajectory) == len(frames)
    assert all(s == 2 for s in resolved[1:]), resolved
    assert not system.tracker._pending and not system._backend_q
    gt = np.stack([-R.T @ t for _, _, _, R, t in frames])
    ate = evaluation.ate_rmse(system.trajectory_tum()[:, 1:4], gt,
                              align=True)
    assert ate < 0.03, ate


def test_mapper_actor_on_cuda(dev):
    """The mapper actor on the card: 16 frames with local BA and loop
    closing on its thread, every frame tracked, one local BA per keyframe
    after the first, no actor error, and shutdown joins its thread."""
    cam, frames = _small_scene()
    cfg = SystemConfig(num_features=512, n_levels=4, max_kf=64,
                       max_pts=16384, async_mapping=True)
    system = System(cam, cfg, device=dev)
    states = [int(system.track_rgbd(g, d, ts)[0])
              for ts, g, d, _, _ in frames]
    assert system.actor.wait_idle(120.0)
    assert system.actor._error is None
    system.shutdown()
    assert not system.actor.thread.is_alive()
    assert all(s == 2 for s in states[1:]), states
    assert 1 <= len(system.local_mapper.ba_log) < system.store._next_kf_uid


# -- the inertial path (slice 8) ---------------------------------------------

def _imu_windows(n_kf=8):
    """Keyframe body poses four frames apart of the inertial motion and the
    raw IMU window of each keyframe gap (numpy)."""
    frames = synthetic.inertial_sequence(n_frames=4 * n_kf, seed=5)
    kf = frames[3::4]
    wins = []
    for i in range(1, n_kf):
        sel = [s for f in frames[4 * i:4 * i + 4] for s in f[3]]
        ts = np.asarray([s[0] for s in sel])
        wins.append((np.stack([s[1] for s in sel]).astype(np.float32),
                     np.stack([s[2] for s in sel]).astype(np.float32),
                     np.diff(ts, prepend=kf[i - 1][0]).astype(np.float32)))
    R_wb = np.stack([R.T for _, R, _, _ in kf]).astype(np.float32)
    p_wb = np.stack([-R.T @ t for _, R, t, _ in kf]).astype(np.float32)
    return frames, kf, R_wb, p_wb, wins


def _preints(wins, device):
    from plvs_tpu_torch.imu import preintegration as pre

    z = np.zeros(3, np.float32)
    return [pre.preintegrate(*(torch.from_numpy(a).to(device) for a in w),
                             z, z) for w in wins]


def test_preintegration_on_cuda_matches_cpu(dev):
    """Keyframe-gap preintegrations on the card against the CPU: deltas
    within 1e-5, the bias Jacobians within 5e-5 (the right Jacobian's
    (1 - cos x) / x^2 at |w dt| ~ 5e-4 is float32 cancellation noise, and
    the card's cos rounds differently; tests/test_torch_inertial.py), the
    covariance within 1e-5 of its largest entry."""
    _, _, _, _, wins = _imu_windows()
    for c, g in zip(_preints(wins, "cpu"), _preints(wins, dev)):
        for f in c._fields:
            a, b = getattr(g, f).cpu().numpy(), getattr(c, f).numpy()
            tol = (1e-5 * np.abs(b).max() if f == "cov"
                   else 5e-5 if f in ("JRg", "JVg", "JPg") else 1e-5)
            np.testing.assert_allclose(a, b, atol=tol, rtol=0, err_msg=f)


def test_inertial_init_on_cuda_matches_cpu(dev):
    """The inertial-only Gauss-Newton solve on the card, with no host read
    inside it (sync-debug mode "error"), against the CPU: gravity within
    1e-3, biases within 1e-4 (tests/test_torch_imu.py's CPU bounds times
    ten: the card's preintegrations differ as above)."""
    from plvs_tpu_torch.imu import initialization as init

    _, _, R_wb, p_wb, wins = _imu_windows(6)
    cpu = init.inertial_only_optimize_padded(R_wb, p_wb, _preints(wins, "cpu"),
                                             fix_scale=True)
    pres = _preints(wins, dev)
    pres += [init._identity_preint(pres[0])] * 2
    args = (torch.from_numpy(np.concatenate(
        [R_wb, np.tile(np.eye(3, dtype=np.float32)[None], (2, 1, 1))])).to(
        dev), torch.from_numpy(np.concatenate(
            [p_wb, np.zeros((2, 3), np.float32)])).to(dev),
        init.stack_preints(pres))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu = init.inertial_only_optimize(*args, fix_scale=True, k_real=6)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_allclose(gpu.gravity.cpu().numpy(),
                               cpu.gravity.numpy(), atol=1e-3, rtol=0)
    for a, b in ((gpu.bias_gyro, cpu.bias_gyro), (gpu.bias_acc, cpu.bias_acc)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4,
                                   rtol=0)


def test_vi_bundle_adjust_on_cuda_matches_cpu(dev):
    """The VI BA (6 LM x 30 CG) on the card with no host read inside the
    solve, against the CPU: poses, velocities and points within
    tests/test_torch_vi_ba.py's JAX bounds (1e-4 for the states, 5e-4 m
    for the points), the final cost within 1e-3 relative."""
    from plvs_tpu_torch.imu import initialization as init
    from plvs_tpu_torch.solvers import vi_ba

    _, kf, R_wb, p_wb, wins = _imu_windows(8)
    rng = np.random.default_rng(3)
    K, P = 8, 150
    R_cw = R_wb.transpose(0, 2, 1)
    t_cw = -np.einsum("kij,kj->ki", R_cw, p_wb)
    pts = np.c_[rng.uniform(-1.5, 1.5, (P, 2)), rng.uniform(2, 5, P)]
    pts = ((pts - t_cw[4]) @ R_cw[4]).astype(np.float32)
    Xc = np.einsum("kij,pj->kpi", R_cw, pts) + t_cw[:, None]
    uv = 520.0 * Xc[..., :2] / Xc[..., 2:] + np.array([320.0, 240.0])
    uvr = np.concatenate([uv + rng.normal(0, 0.5, uv.shape),
                          -np.ones((K, P, 1))], -1).reshape(-1, 3)
    ts = np.asarray([f[0] for f in kf])
    v_w = np.gradient(p_wb, ts, axis=0).astype(np.float32)
    M = K * P

    def problem(device):
        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return vi_ba.VIProblem(
            t(R_wb), t((p_wb + rng_p).astype(np.float32)), t(v_w),
            t(np.zeros((K, 3), np.float32)), t(np.zeros((K, 3), np.float32)),
            t(np.arange(K) == 0), t(np.ones(K, bool)),
            t(np.eye(3, dtype=np.float32)), t(np.zeros(3, np.float32)),
            t(pts + 0.02), t(np.ones(P, bool)), t(np.repeat(np.arange(K), P)),
            t(np.tile(np.arange(P), K)), t(uvr.astype(np.float32)),
            t(np.ones(M, np.float32)), t(np.ones(M, bool)),
            init.stack_preints(_preints(wins, device)),
            t(np.ones(K - 1, bool)),
            t(np.array([0.3, 9.7, -0.4], np.float32) / np.float32(
                np.linalg.norm([0.3, 9.7, -0.4])) * np.float32(9.81)))

    rng_p = rng.normal(0, 0.01, (K, 3))
    rng_p[0] = 0
    cam = cameras.pinhole(520.0, 520.0, 320.0, 240.0, width=640, height=480,
                          bf=40.0)
    cpu = vi_ba.vi_bundle_adjust(cam, problem("cpu"), num_iters=6,
                                 cg_iters=30)
    prob = problem(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        gpu = vi_ba.vi_bundle_adjust(cam, prob, num_iters=6, cg_iters=30)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(gpu[6]["cost"]) < float(gpu[6]["cost0"])
    for a, b, tol in zip(gpu[:6], cpu[:6],
                         (1e-4, 1e-4, 1e-4, 1e-4, 2e-4, 5e-4)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=tol,
                                   rtol=0)
    assert abs(float(gpu[6]["cost"]) - float(cpu[6]["cost"])) <= \
        1e-3 * float(cpu[6]["cost"])


def test_inertial_system_on_cuda(dev):
    """RGB-D + IMU at 320x240 through the pipelined runtime with its
    overlap thread on the card (40 frames, init_min_time lowered to 1 s as
    in tests/test_torch_inertial.py): every frame resolves tracked, the
    IMU initializes, every VI BA is finite, and the ATE is under that
    file's 5 cm."""
    from plvs_tpu_torch.io import evaluation

    cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                          bf=24.0)
    scene = synthetic.inertial_scene(cam, 1)
    seq = synthetic.inertial_sequence(n_frames=40, seed=1)
    cfg = SystemConfig(num_features=512, n_levels=4, max_kf=64,
                       max_pts=16384, loop_closing=False, use_imu=True,
                       max_kf_interval=4, pipelined=True, pipeline_depth=2,
                       pipeline_overlap=True, backend_fixed_shapes=True)
    system = System(cam, cfg, device=dev)
    system.inertial.init_min_time = 1.0
    resolved = []
    post = system._post_track

    def recording(res, ts, payload=None):
        resolved.append(int(res.state))
        return post(res, ts, payload)

    system._post_track = recording
    for ts, R, t, samples in seq:
        g, d = scene.render(R, t)
        system.track_rgbd(g, d, ts, imu_samples=samples)
    system.shutdown()
    assert len(resolved) == len(seq) and all(s == 2 for s in resolved[1:])
    assert system.inertial.initialized
    log = system.inertial.vi_ba_log
    assert log and all(np.isfinite(e["cost"]) for e in log)
    gt = np.stack([-R.T @ t for _, R, t, _ in seq])
    ate = evaluation.ate_rmse(system.trajectory_tum()[:, 1:4], gt,
                              align=True)
    assert ate < 0.05, ate


# ---------------------------------------------------------------------------
# stereo rigs and the rest of the dense stage
# ---------------------------------------------------------------------------

def test_rig_frame_on_cuda_matches_cpu(dev):
    """The KB8 rig's frame at 640x480 (chip smoke phase 10's pair and first
    frame) on the card against the same code on the CPU: the same
    keypoints and triangulated matches on >= 97% (float32 steps on the
    card in another order can move a borderline keypoint), depths with a
    median within 5e-4 relative and all
    within 2e-2 (the SAD parabola amplifies float32 reduction-order
    differences, as in tests/test_torch_stereo_rig.py; measured on the
    card: median 1.1e-4)."""
    from plvs_tpu_torch.slam import frame as frame_mod

    size = dict(width=640, height=480)
    cl = cameras.kannala_brandt8(*synthetic.RIG_KB8_LEFT, **size)
    cr = cameras.kannala_brandt8(*synthetic.RIG_KB8_RIGHT, **size)
    T = synthetic.rig_extrinsic()
    rig = synthetic.SyntheticRig(cl, cr, T, wall_z=3.0,
                                 texture=synthetic.make_structured_texture(
                                     2048, rng=np.random.default_rng(7)),
                                 tex_scale=420.0)
    gl, gr, _ = rig.render(*synthetic.default_trajectory(120)[0])
    out = {}
    for d in ("cpu", dev):
        out[str(d)] = frame_mod.build_frame_stereo_rig(
            torch.from_numpy(gl).to(d), torch.from_numpy(gr).to(d), cl, cr,
            torch.from_numpy(T[:3, :3].copy()).to(d),
            torch.from_numpy(T[:3, 3].copy()).to(d), 1024, 8, 1.2)
    a, b = out["cpu"], out[str(dev)]
    same = ((a.kp.xy == b.kp.xy.cpu()).all(-1)
            & (a.kp.mask == b.kp.mask.cpu())).numpy()
    assert same.mean() >= 0.97
    da, db = a.depth.numpy(), b.depth.cpu().numpy()
    assert ((da > 0) == (db > 0))[same].mean() >= 0.97
    both = same & (da > 0) & (db > 0)
    assert both.sum() > 100
    rel = np.abs(db[both] - da[both]) / da[both]
    assert np.median(rel) < 5e-4 and rel.max() < 2e-2


def test_sgm_on_cuda_matches_cpu(dev):
    """SGM disparity at 480x640, D = 64, on the card against the CPU: the
    same valid pixels on >= 99.5% and the same disparities within 1e-4 px
    (elementwise float32 steps in one order; only the parabola divides)."""
    from plvs_tpu_torch.dense import stereo_depth as sd

    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (480, 640 + 80)).astype(np.float32)
    left, right = base[:, 40:680], base[:, 49:689]
    before = stereo.launches
    out = [sd.disparity(torch.from_numpy(left).to(d),
                        torch.from_numpy(right).to(d), max_disp=64,
                        method="sgm").cpu().numpy() for d in ("cpu", dev)]
    assert stereo.launches == before       # SGM never reaches K3
    a, b = out
    assert ((a > 0) == (b > 0)).mean() >= 0.995
    both = (a > 0) & (b > 0)
    assert both.mean() > 0.8
    np.testing.assert_allclose(b[both], a[both], atol=1e-4, rtol=0)
    assert np.median(np.abs(b[both] - 9.0)) < 0.1


def test_segment_depth_on_cuda_matches_cpu(dev):
    """segment_depth of a 640x480 room depth with two boxes and dropouts on
    the card against the CPU: links on >= 99.9% of the edges, and the
    labels fed the CPU's links equal (integer fill and area threshold)."""
    from plvs_tpu_torch.dense import processing as proc

    cam = cameras.pinhole(520.9, 521.0, 325.1, 249.7, width=640, height=480,
                          bf=40.0)
    room = synthetic.SyntheticRoom(cam, half=3.0, tex_size=2048, seed=3)
    R, t = synthetic.orbit_loop_trajectory(60, radius=0.6, laps=0.5)[20]
    _, depth = room.render(R, t)
    rng = np.random.default_rng(0)
    depth[100:220, 150:330] = 1.5
    depth[rng.random(depth.shape) < 0.02] = 0.0
    c_cpu, _, v = proc.segment_connectivity(cam, torch.from_numpy(depth))
    c_gpu, _, _ = proc.segment_connectivity(
        cam, torch.from_numpy(depth).to(dev))
    assert (c_gpu.cpu() == c_cpu).float().mean() >= 0.999
    lab_cpu = proc.label_components(c_cpu, v)
    lab_gpu = proc.label_components(c_cpu.to(dev), v.to(dev))
    assert torch.equal(lab_gpu.cpu(), lab_cpu)
    assert len(torch.unique(lab_cpu)) > 2


def test_esdf_on_cuda_matches_cpu(dev):
    """Jump flooding on a random 64x48x40 occupancy on the card against
    the CPU: the same distances."""
    from plvs_tpu_torch.dense import esdf

    rng = np.random.default_rng(1)
    occ = np.zeros((64, 48, 40), bool)
    pts = rng.integers(0, occ.shape, (50, 3))
    occ[pts[:, 0], pts[:, 1], pts[:, 2]] = True
    a = esdf.esdf_jfa(torch.from_numpy(occ), 0.02)
    b = esdf.esdf_jfa(torch.from_numpy(occ).to(dev), 0.02).cpu()
    torch.testing.assert_close(b, a, rtol=2.5e-7, atol=0)


# ---------------------------------------------------------------------------
# slice 10: the monocular path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,n", [(256, 256, 512), (240, 320, 1024)])
def test_per_level_orb_on_cuda_matches_cpu(dev, h, w, n):
    """The per-level extraction (8 levels; the uniformity cells differ by
    level) on the card against the CPU. Fed the same level, FAST's
    selection (positions, scores, masks) is exact; descriptors from the
    same patches and angles at least 99% of words exact and within 2 bits
    a descriptor (the sampling product's 4 terms summed in cuBLAS's order:
    a sample pair within a float32 step flips its bit, as between XLA and
    torch on the CPU, tests/test_torch_features.py). End to end (each
    device resizing its own pyramid) at least 97% of the keypoints
    identical, as for the rig's frame below."""
    from plvs_tpu_torch.features import fast, orb, pyramid

    tex = synthetic.make_structured_texture(1024,
                                            rng=np.random.default_rng(7))
    img = torch.from_numpy(np.clip(tex[20:20 + h, 20:20 + w], 0, 255)
                           .astype(np.uint8).astype(np.float32))
    per = orb.features_per_level(n, 8, 1.2)
    shapes = pyramid.level_shapes(h, w, 8, 1.2)
    cells = [max(8, min(16, int(np.sqrt(hl * wl / max(nl, 1)))))
             for (hl, wl), nl in zip(shapes, per)]
    for lv, level in enumerate(pyramid.build_pyramid(img, 8, 1.2)):
        if per[lv] <= 0:
            continue
        a = fast.detect(level, per[lv], border=orb.HALF + 1, cell=cells[lv])
        b = fast.detect(level.to(dev), per[lv], border=orb.HALF + 1,
                        cell=cells[lv])
        for x, y in zip(a, b):
            assert torch.equal(x, y.cpu())
        blurred = pyramid.gaussian_blur(level)
        bp = orb.extract_patches(blurred, a[0])
        ang = orb.ic_angle(orb.extract_patches(level, a[0]))
        da = orb.descriptors(bp, ang)
        db = orb.descriptors(bp.to(dev), ang.to(dev)).cpu()
        assert (da == db).float().mean() >= 0.99
        from plvs_tpu_torch.features import matching

        assert int(matching.hamming_pairs(da, db).max()) <= 2
    ka = orb.extract(img, n, 8)
    kb = orb.extract(img.to(dev), n, 8)
    same = ((ka.xy == kb.xy.cpu()).all(-1) & (ka.mask == kb.mask.cpu()))
    assert same.float().mean() >= 0.97
    assert torch.equal(ka.octave, kb.octave.cpu())


def test_two_view_on_cuda_matches_cpu(dev):
    """The two-view reconstruction on the card from the CPU's samples: the
    same model, inliers and good count; R21 and t21 within 1e-4 (cuSOLVER's
    singular vectors differ in sign and the E decomposition's pair in
    order, which the cheirality scoring resolves: the same pose wins)."""
    from plvs_tpu_torch.solvers import two_view

    rng = np.random.default_rng(3)
    n = 300
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                  rng.uniform(3, 6, n)], -1)
    a = 0.05
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    X2 = X @ R.T + [-0.3, 0.02, 0.05]
    p1 = torch.from_numpy((X[:, :2] / X[:, 2:] + rng.normal(
        0, 2e-3, (n, 2))).astype(np.float32))
    p2 = torch.from_numpy((X2[:, :2] / X2[:, 2:] + rng.normal(
        0, 2e-3, (n, 2))).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) >= 0.1)
    sF, sH = two_view.draw_samples(valid, torch.Generator().manual_seed(1))
    ra = two_view.reconstruct_from_samples(p1, p2, valid, sF, sH,
                                           sigma=1 / 500, min_good=80)
    rb = two_view.reconstruct_from_samples(
        p1.to(dev), p2.to(dev), valid.to(dev), sF.to(dev), sH.to(dev),
        sigma=1 / 500, min_good=80)
    assert bool(ra.success) and bool(rb.success)
    assert bool(ra.used_homography) == bool(rb.used_homography)
    assert torch.equal(ra.inliers, rb.inliers.cpu())
    torch.testing.assert_close(rb.R21.cpu(), ra.R21, atol=1e-4, rtol=0)
    torch.testing.assert_close(rb.t21.cpu(), ra.t21, atol=1e-4, rtol=0)


def test_pnp_and_plane_ransac_on_cuda_match_cpu(dev):
    """The PnP RANSAC and the plane-homography RANSAC on the card from the
    CPU's samples: the same inliers, poses within 1e-4; the PnP's 8-step
    polish under sync-debug mode (no host read inside; the hypotheses'
    SVDs read their status back)."""
    from plvs_tpu_torch.slam import map_objects
    from plvs_tpu_torch.solvers import pnp

    rng = np.random.default_rng(3)
    n = 200
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1, 1, n),
                  rng.uniform(2, 6, n)], -1).astype(np.float32)
    Xc = X + np.array([0.2, -0.1, 0.3], np.float32)
    uv = (Xc[:, :2] / Xc[:, 2:] + rng.normal(0, 2e-3, (n, 2))).astype(
        np.float32)
    out = rng.random(n) < 0.4
    uv[out] += rng.uniform(-0.2, 0.2, (out.sum(), 2)).astype(np.float32)
    valid = torch.ones(n, dtype=torch.bool)
    X, uv = torch.from_numpy(X), torch.from_numpy(uv)
    s = pnp.draw_samples(valid, torch.Generator().manual_seed(2))
    ra = pnp.pnp_ransac_from_samples(X, uv, valid, s, inlier_thresh=4 / 500)
    rb = pnp.pnp_ransac_from_samples(*(t.to(dev) for t in (X, uv, valid, s)),
                                     inlier_thresh=4 / 500)
    w = ra.inliers.to(torch.float32)
    xa = pnp._polish(ra.R, ra.t, X, uv, w, 8)
    args = [t.to(dev) for t in (ra.R, ra.t, X, uv, w)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        xb = pnp._polish(*args, 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(xb.cpu(), xa, atol=1e-5, rtol=0)
    assert torch.equal(ra.inliers, rb.inliers.cpu())
    torch.testing.assert_close(rb.R.cpu(), ra.R, atol=1e-4, rtol=0)
    torch.testing.assert_close(rb.t.cpu(), ra.t, atol=1e-4, rtol=0)
    plane = torch.from_numpy(rng.uniform(0, 1, (150, 2)).astype(np.float32))
    P = torch.cat([plane, torch.zeros(150, 1)], -1) + torch.tensor(
        [-0.5, -0.5, 2.5])
    img = P[:, :2] / P[:, 2:] + torch.from_numpy(rng.normal(
        0, 1 / 600, (150, 2)).astype(np.float32))
    ok = torch.from_numpy(rng.random(150) < 0.9)
    samples = map_objects.draw_samples(ok, torch.Generator().manual_seed(3))
    Ha, ia, _ = map_objects.ransac_plane_homography_from_samples(
        plane, img, ok, 1 / 300 ** 2, samples)
    Hb, ib, _ = map_objects.ransac_plane_homography_from_samples(
        plane.to(dev), img.to(dev), ok.to(dev), 1 / 300 ** 2,
        samples.to(dev))
    assert torch.equal(ia, ib.cpu())
    torch.testing.assert_close(Hb.cpu(), Ha, atol=1e-4, rtol=1e-4)


def test_mono_system_on_cuda(dev):
    """A monocular System on the card over 12 frames of
    tests/test_slam_e2e.py TestMonocular's scene at 320x240: the two-view
    map at frame 1, every later frame OK, map growth by triangulation, and
    K1 launched for the initializer's and the triangulation's matches."""
    cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                          bf=24.0)
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, seed=9)
    poses = [(np.eye(3, dtype=np.float32),
              -np.array([1.6 * i / 39, 0.1 * np.sin(2 * np.pi * i / 39),
                         0.3 * i / 39], np.float32)) for i in range(12)]
    system = System(cam, SystemConfig(
        num_features=512, n_levels=4, max_kf=64, max_pts=16384,
        loop_closing=False, sensor="mono", max_kf_interval=5,
        min_kf_inliers=25), device="cuda")
    hamming.launches = 0
    states = [int(system.track_monocular(g, ts)[0])
              for ts, g, _, _, _ in scene.sequence(poses=poses)]
    assert states[0] == 1 and all(s_ == 2 for s_ in states[1:]), states
    assert sum(system.local_mapper.new_points_log) > 0
    assert hamming.launches > 12
