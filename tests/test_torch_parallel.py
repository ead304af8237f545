"""The port's multi-device backend (plvs_tpu_torch/parallel/) against the
JAX package's on the same inputs: the JAX side on the 8-device virtual CPU
mesh that tests/conftest.py sets up, the port on an 8-shard mesh on the CPU
(``make_mesh(8, device="cpu")``, the same split and reductions with every
shard on one device), and the multi-process check as two gloo ranks.

Tolerances, and why:

* Sharded BA (tests/test_parallel.py's problem, 3 LM x 10 CG): the final
  cost within rtol 1e-3 of JAX's ``bundle_adjust_sharded`` and of the
  port's unsharded ``scatter_free=False`` solve (JAX's own bound: sharding
  changes only the order of the float32 partial sums).
* ``partition_by_point``: bit-equal (host integer arithmetic and copies).
* Ring pose graph (10 LM x 30 CG): both packages' rules (cost below cost0,
  mean position error under half the initial), and poses within 1e-3 of
  JAX's sharded solve (tests/test_torch_loop.py's pose-graph tolerance:
  two autodiff systems' Jacobians, amplified a little by CG).
* ``ShardedTSDFVolume`` and ``DevicePlacedTSDF``: tsdf and weight within
  1e-5 (tests/test_parallel.py's), against the port's unsharded volume and
  against JAX's sharded one.
* The gloo check: the two ranks print the same cost; it equals the port's
  single-process solve and JAX's ``ba.bundle_adjust`` within rtol 1e-3.
"""

import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_parallel
from plvs_tpu.dense.tsdf import TSDFVolume as JTSDFVolume
from plvs_tpu.parallel import sharded_ba as jsb
from plvs_tpu.parallel import sharded_pose_graph as jspg
from plvs_tpu.parallel import sharded_tsdf as jstsdf
from plvs_tpu.solvers import ba as jba
from plvs_tpu_torch import convert
from plvs_tpu_torch.dense.tsdf import TSDFVolume
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.parallel import distributed_check, pipeline
from plvs_tpu_torch.parallel import sharded_ba as tsb
from plvs_tpu_torch.parallel import sharded_pose_graph as tspg
from plvs_tpu_torch.parallel import sharded_tsdf as tstsdf
from plvs_tpu_torch.solvers import ba as tba
from plvs_tpu_torch.solvers import pose_graph as tpg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCAM = tcam.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                    bf=24.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the parallel test workers share the cores (as
    tests/test_torch_ba.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_ba(jprob):
    return convert.ba_problem_from_numpy(
        {f: np.asarray(getattr(jprob, f)) for f in jprob._fields},
        device="cpu")


@pytest.fixture(scope="module")
def ba_case():
    """tests/test_parallel.py's problem in both packages, the meshes, and
    JAX's unsharded solve."""
    cam, jprob = test_parallel._ba_problem(np.random.default_rng(0))
    return cam, jprob, _port_ba(jprob), jsb.make_mesh(8), \
        tsb.make_mesh(8, device="cpu")


@pytest.mark.parametrize("shard_points", [False, True])
def test_sharded_ba_matches_jax_and_unsharded(ba_case, shard_points):
    cam, jprob, tprob, jmesh, tmesh = ba_case
    jout = jsb.bundle_adjust_sharded(cam, jprob, jmesh, num_iters=3,
                                     cg_iters=10, shard_points=shard_points)
    tout = tsb.bundle_adjust_sharded(TCAM, tprob, tmesh, num_iters=3,
                                     cg_iters=10, shard_points=shard_points)
    one = tba.bundle_adjust(TCAM, tprob, num_iters=3, cg_iters=10,
                            scatter_free=False)
    cost = float(tout[-1]["cost"])
    assert cost < float(tout[-1]["cost0"])
    np.testing.assert_allclose(cost, float(jout[-1]["cost"]), rtol=1e-3)
    np.testing.assert_allclose(cost, float(one[-1]["cost"]), rtol=1e-3)
    np.testing.assert_allclose(float(tout[-1]["cost0"]),
                               float(jout[-1]["cost0"]), rtol=1e-5)
    # every block comes back whole, on the mesh's first device
    for a, b in zip(tout[:5], one[:5]):
        assert a.shape == b.shape and a.device == tmesh.devices[0]
    assert torch.isfinite(tout[2]).all()


def test_partition_by_point_bit_equal_to_jax(ba_case):
    _, jprob, tprob, _, _ = ba_case
    # masked observations go to the last shard, whatever their landmark
    mask = np.asarray(jprob.obs_mask).copy()
    mask[::7] = False
    jprob = jprob._replace(obs_mask=jnp.asarray(mask))
    tprob = tprob._replace(obs_mask=torch.from_numpy(mask))
    for n in (2, 8):
        jp = jsb.partition_by_point(jprob, n)
        tp = tsb.partition_by_point(tprob, n)
        for f in ("obs_cam", "obs_pt", "obs_uvr", "obs_inv_sigma2",
                  "obs_mask"):
            a, b = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
            assert a.shape == b.shape and np.array_equal(
                a.astype(b.dtype), b), (n, f)
    with pytest.raises(ValueError, match="not divisible"):
        tsb.partition_by_point(tprob, 3)


def test_mesh_shards_on_one_device_or_raises_without_cards():
    m = tsb.make_mesh(4, device="cpu")
    assert m.size == 4 and m.axis == "obs" and m.group is None
    assert all(d == torch.device("cpu") for d in m.devices)
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="devices visible"):
            tsb.make_mesh(2)


@pytest.fixture(scope="module")
def ring():
    prob, t_gt = test_parallel.TestShardedPoseGraph()._ring_problem(
        np.random.default_rng(0))
    tprob = convert.pose_graph_problem_from_numpy(
        {f: np.asarray(getattr(prob, f)) for f in prob._fields},
        device="cpu")
    return prob, tprob, t_gt


def test_sharded_pose_graph_ring_matches_jax(ring):
    prob, tprob, t_gt = ring
    jR, jt, _, jinfo = jspg.optimize_sharded(prob, jspg.make_mesh(8),
                                             num_iters=10, cg_iters=30,
                                             fix_scale=True)
    mesh = tspg.make_mesh(8, device="cpu")
    tR, tt, ts, tinfo = tspg.optimize_sharded(tprob, mesh, num_iters=10,
                                              cg_iters=30, fix_scale=True)
    assert float(tinfo["cost"]) < float(tinfo["cost0"])
    err0 = np.linalg.norm(tprob.t.numpy() - t_gt, axis=-1).mean()
    err1 = np.linalg.norm(tt.numpy() - t_gt, axis=-1).mean()
    assert err1 < err0 * 0.5
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
    np.testing.assert_allclose(float(tinfo["cost"]), float(jinfo["cost"]),
                               rtol=1e-2, atol=1e-6)
    # 13 edges pad to 16 inside (JAX asks the caller for a divisible
    # table): the same solve as the port's unsharded one
    odd = tprob._replace(**{f: getattr(tprob, f)[3:] for f in (
        "edge_i", "edge_j", "edge_R", "edge_t", "edge_s", "edge_weight",
        "edge_mask")})
    sR, st, _, sinfo = tspg.optimize_sharded(odd, mesh, num_iters=10,
                                             cg_iters=30, fix_scale=True)
    uR, ut, _, uinfo = tpg.optimize(odd, num_iters=10, cg_iters=30,
                                    fix_scale=True)
    assert float(sinfo["cost"]) < float(sinfo["cost0"])
    np.testing.assert_allclose(float(sinfo["cost0"]), float(uinfo["cost0"]),
                               rtol=1e-6)
    np.testing.assert_allclose(st.numpy(), ut.numpy(), atol=1e-4)
    np.testing.assert_allclose(sR.numpy(), uR.numpy(), atol=1e-4)


def _wall():
    depth = np.full((240, 320), 2.0, np.float32)
    depth[:, :40] = 0.0                      # a band of missing depth
    depth[100:140, 150:200] = 1.6            # and a box in front of the wall
    color = np.zeros((240, 320, 3), np.float32)
    color[..., 0] = np.linspace(0, 255, 320, dtype=np.float32)
    return depth, color, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)


def test_sharded_tsdf_volume_matches_unsharded_and_jax():
    frame = _wall()
    ref = TSDFVolume(TCAM, voxel_size=0.05, max_blocks=4096, device="cpu")
    # 3 shards, so the live block count does not divide and the batch pads
    vol = tstsdf.ShardedTSDFVolume(tstsdf.make_mesh(3, device="cpu"), TCAM,
                                   voxel_size=0.05, max_blocks=4096)
    jvol = jstsdf.ShardedTSDFVolume(jstsdf.make_mesh(3), test_parallel._cam(),
                                    voxel_size=0.05, max_blocks=4096)
    R2 = np.asarray([[0.995, 0.0, 0.0998], [0.0, 1.0, 0.0],
                     [-0.0998, 0.0, 0.995]], np.float32)
    for R in (frame[2], R2):               # the second frame allocates more
        for v in (ref, vol, jvol):
            v.integrate(frame[0], frame[1], R, frame[3])
    n = ref.n_blocks
    assert vol.n_blocks == jvol.n_blocks == n and n % 3
    np.testing.assert_array_equal(vol.block_coords[:n], jvol.block_coords[:n])
    for other in (ref, jvol):
        np.testing.assert_allclose(vol.tsdf[:n], other.tsdf[:n], atol=1e-5)
        np.testing.assert_allclose(vol.weight[:n], other.weight[:n],
                                   atol=1e-5)
    np.testing.assert_allclose(vol.color[:n], jvol.color[:n], atol=1e-3)
    assert float(vol.weight[:n].max()) > 0.0
    # the padded slots past the live ones stay empty
    assert float(np.abs(vol.weight[n:]).max()) == 0.0
    with pytest.raises(ValueError, match="not divisible"):
        tstsdf.integrate_blocks_sharded(
            vol.mesh, torch.zeros((8, 3), dtype=torch.int32),
            *(torch.zeros((8, 8, 8, 8)) for _ in range(2)),
            torch.zeros((8, 8, 8, 8, 3)), torch.ones((240, 320)),
            torch.zeros((240, 320, 3)), torch.eye(3), torch.zeros(3), TCAM,
            0.05, 0.2)


def test_device_placed_tsdf_matches():
    depth, color, R, t = _wall()
    ref = TSDFVolume(TCAM, voxel_size=0.05, max_blocks=4096, device="cpu")
    vol = pipeline.DevicePlacedTSDF("cpu", TCAM, voxel_size=0.05,
                                    max_blocks=4096)
    jref = JTSDFVolume(test_parallel._cam(), voxel_size=0.05, max_blocks=4096)
    for _ in range(2):
        for v in (ref, vol, jref):
            v.integrate(depth, color, R, t)
    vol.flush()
    n = jref.n_blocks
    assert vol.n_blocks == ref.n_blocks == n
    for other in (ref, jref):
        np.testing.assert_allclose(vol.tsdf[:n], other.tsdf[:n], atol=1e-5)
        np.testing.assert_allclose(vol.weight[:n], other.weight[:n],
                                   atol=1e-5)
    assert len(vol.occupied_cloud()[0]) == len(jref.occupied_cloud()[0])


def test_pipelined_mapper():
    mapper = pipeline.make_pipelined_dense_mapper(
        TCAM, voxel_size=0.05, device="cpu", mapper_device="cpu",
        mesh_every=1)
    assert isinstance(mapper.volume, pipeline.DevicePlacedTSDF)
    assert mapper.mesher.volume is mapper.volume
    depth = np.full((240, 320), 2.0, np.float32)
    color = np.zeros((240, 320, 3), np.float32)
    mapper.insert_keyframe_rgbd(0, color, depth, np.eye(3, dtype=np.float32),
                                np.zeros(3, np.float32))
    pts, _ = mapper.cloud()
    assert len(pts) > 100
    assert np.abs(pts[:, 2] - 2.0).max() < 0.1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            pipeline.make_pipelined_dense_mapper(TCAM, mapper_device="cpu")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_gloo_ranks_agree_with_one_process_and_jax():
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "plvs_tpu_torch.parallel.distributed_check",
         init, "2", str(r), "--device", "cpu"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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
    costs = []
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        line = [ln for ln in out.splitlines() if ln.startswith("DIST_OK")]
        assert line, out[-2000:]
        costs.append(float(line[0].split("cost=")[1]))
    assert costs[0] == costs[1], costs
    # the same problem in one process, in both packages
    cam, prob = distributed_check.make_problem("cpu")
    one = float(tba.bundle_adjust(cam, prob, num_iters=2, cg_iters=8,
                                  scatter_free=False)[-1]["cost"])
    jprob = jba.make_problem(**{
        f: jnp.asarray(getattr(prob, f).numpy())
        for f in ("R", "t", "fixed_cam", "points", "obs_cam", "obs_pt",
                  "obs_uvr", "obs_inv_sigma2", "obs_mask")})
    jcost = float(jba.bundle_adjust(test_parallel._cam(), jprob, num_iters=2,
                                    cg_iters=8)[-1]["cost"])
    np.testing.assert_allclose(costs[0], one, rtol=1e-3)
    np.testing.assert_allclose(costs[0], jcost, rtol=1e-3)
    assert costs[0] < float(tba.bundle_adjust(
        cam, prob, num_iters=2, cg_iters=8)[-1]["cost0"])
