"""The port's viewer layer against the JAX package's: the plane RANSAC of the
AR layer fed JAX's own samples, the frame and AR overlays, the map drawer's
frusta and covisibility segments on one store, the PLY readers and the
``GlObjects`` settings block, and the two demos run through both packages.

``jax.random`` cannot be replayed in torch: the RANSAC test recomputes
JAX's samples with ``jax.random.randint`` from the key ``detect_plane``
hands ``_plane_ransac`` and gives them to the port's. The rasterizers are
numpy in both packages; the AR overlay projects through each package's
camera model, so a vertex that lands within an ulp of a pixel boundary
may round the other way (the tolerance is stated at the check).
"""

import contextlib
import io
import os
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plvs_tpu.geometry import cameras as jcam
from plvs_tpu.slam.map_store import MapStore as JStore
from plvs_tpu.viz import ar as jar
from plvs_tpu.viz import frame_drawer as jfd
from plvs_tpu.viz import gl_objects as jgl
from plvs_tpu.viz import map_drawer as jmd
from plvs_tpu_torch import convert
from plvs_tpu_torch.geometry import cameras as tcam
from plvs_tpu_torch.viz import ar as tar
from plvs_tpu_torch.viz import frame_drawer as tfd
from plvs_tpu_torch.viz import gl_objects as tgl
from plvs_tpu_torch.viz import map_drawer as tmd
from plvs_tpu_torch.viz import rerun_logger as trl
from test_torch_place_recognition import _need_native

CAM_ARGS = (300.0, 300.0, 160.0, 120.0)
CAM_KW = dict(width=320, height=240, bf=24.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread, as tests/test_torch_ba.py."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _plane_cloud(rng, n=200, noise=0.003, n_out=40):
    """A z = 0.5 patch plus uniform outliers (tests/test_ar.py's cloud)."""
    pts = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    0.5 + rng.normal(0, noise, n)], -1).astype(np.float32)
    out = rng.uniform(-1, 1, (n_out, 3)).astype(np.float32)
    return np.concatenate([pts, out])


def _jax_samples(seed: int, n: int, n_hyp: int = 128) -> np.ndarray:
    """The samples JAX's ``_plane_ransac`` draws from ``PRNGKey(seed)``."""
    return np.array(jax.random.randint(jax.random.PRNGKey(seed),
                                       (n_hyp, 3), 0, n))


# ---------------------------------------------------------------------------
# the plane RANSAC


@pytest.mark.parametrize("case", ["plane", "invalid_points", "two_planes"])
def test_plane_ransac_from_jax_samples(case):
    """Same inlier mask and count exactly; normal and d within 1e-5 (the
    refit's 3x3 ``eigh`` in two LAPACK builds, float32)."""
    rng = np.random.default_rng({"plane": 0, "invalid_points": 1,
                                 "two_planes": 2}[case])
    pts = _plane_cloud(rng)
    if case == "two_planes":
        # a second, smaller plane x = -0.3 beside the first
        other = np.stack([np.full(120, -0.3) + rng.normal(0, 0.003, 120),
                          rng.uniform(-1, 1, 120), rng.uniform(0, 1, 120)],
                         -1).astype(np.float32)
        pts = np.concatenate([pts, other])
    valid = np.ones(len(pts), bool)
    if case == "invalid_points":
        valid[rng.random(len(pts)) < 0.3] = False
    seed = 5
    jn, jd, jinl, jk = jar._plane_ransac(jnp.asarray(pts), jnp.asarray(valid),
                                         jax.random.PRNGKey(seed))
    tn, td, tinl, tk = tar._plane_ransac(
        torch.from_numpy(pts), torch.from_numpy(valid),
        torch.from_numpy(_jax_samples(seed, len(pts))))
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tk) == int(jk) > 100
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    assert abs(float(td) - float(jd)) < 1e-5


def test_plane_ransac_gates_degenerate_samples():
    """A small cloud: 10 points on z = 0.5 and 6 on one line off the plane.
    Among JAX's 128 draws are repeated indices and triples from the line
    (coincident or collinear points, |n| = 0); ungated, such a hypothesis
    would count every point within 0.02 of the plane 0 . x = 0. Both
    packages gate them to score 0 and find the same plane (mask exact,
    normal and d within 1e-5)."""
    rng = np.random.default_rng(3)
    plane = np.stack([rng.uniform(-1, 1, 10), rng.uniform(-1, 1, 10),
                      np.full(10, 0.5)], -1)
    line = np.stack([np.linspace(-1, 1, 6), np.full(6, 0.2),
                     np.full(6, -0.7)], -1)
    pts = np.concatenate([plane, line]).astype(np.float32)
    valid = np.ones(len(pts), bool)
    seed = 11
    samples = _jax_samples(seed, len(pts))
    rows = np.sort(samples, 1)
    repeated = (rows[:, 0] == rows[:, 1]) | (rows[:, 1] == rows[:, 2])
    on_line = (samples >= 10).all(1)
    assert repeated.any() and on_line.any()
    jn, jd, jinl, jk = jar._plane_ransac(jnp.asarray(pts), jnp.asarray(valid),
                                         jax.random.PRNGKey(seed))
    tn, td, tinl, tk = tar._plane_ransac(
        torch.from_numpy(pts), torch.from_numpy(valid),
        torch.from_numpy(samples))
    np.testing.assert_array_equal(tinl.numpy(), np.asarray(jinl))
    assert int(tk) == int(jk) == 10
    np.testing.assert_allclose(np.abs(tn.numpy()), [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-5)
    assert abs(float(td) - float(jd)) < 1e-5
    # all-degenerate samples: every score is 0 and the first hypothesis
    # wins in both argmaxes; the port's result is that hypothesis' refit
    same = torch.zeros((128, 3), dtype=torch.int64)
    _, _, inl0, _ = tar._plane_ransac(torch.from_numpy(pts),
                                      torch.from_numpy(valid), same)
    assert inl0.dtype == torch.bool and inl0.shape == (len(pts),)


def test_detect_plane_matches_jax_and_refuses_small_clouds():
    """``detect_plane`` draws its samples from a torch generator, not JAX's
    stream: on a clean plane both runs keep the same inliers (+-2) and
    normals agree to 1e-3. Fewer than 8 points give None in both."""
    rng = np.random.default_rng(7)
    pts = _plane_cloud(rng)
    jp = jar.detect_plane(pts)
    tp = tar.detect_plane(pts, device="cpu")
    assert abs(tp.n_inliers - jp.n_inliers) <= 2
    np.testing.assert_allclose(tp.normal, jp.normal, atol=1e-3)
    assert abs(tp.d - jp.d) < 1e-3
    np.testing.assert_allclose(tp.origin, jp.origin, atol=1e-3)
    np.testing.assert_allclose(tp.Rwp.T @ tp.Rwp, np.eye(3), atol=1e-5)
    for n in (0, 3, 7):
        small = rng.normal(size=(n, 3)).astype(np.float32)
        assert jar.detect_plane(small) is None
        assert tar.detect_plane(small, device="cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tar.detect_plane(pts)


# ---------------------------------------------------------------------------
# overlays


def test_draw_frame_matches_jax(rng):
    """Keypoints tracked and not, keylines tracked and not, off-image
    markers, each tracking state: pixel-equal (the same numpy code)."""
    gray = rng.uniform(0, 255, (120, 160)).astype(np.float32)
    kp = np.concatenate([rng.uniform(-5, 165, (40, 2)),
                         [[-10.0, 200.0], [159.0, 119.0]]]).astype(np.float32)
    trk = rng.random(len(kp)) < 0.5
    p0 = rng.uniform(-20, 180, (12, 2)).astype(np.float32)
    p1 = rng.uniform(-20, 180, (12, 2)).astype(np.float32)
    ltrk = rng.random(12) < 0.5
    for state in (-1, 0, 1, 2, 3, 4):
        args = dict(kp_xy=kp, kp_tracked=trk, kl_p0=p0, kl_p1=p1,
                    kl_tracked=ltrk, state=state)
        np.testing.assert_array_equal(tfd.draw_frame(gray, **args),
                                      jfd.draw_frame(gray, **args))
    np.testing.assert_array_equal(tfd.draw_frame(gray), jfd.draw_frame(gray))


def test_save_png_writes_an_image(tmp_path, rng):
    img = rng.integers(0, 255, (20, 30, 3), dtype=np.uint8)
    p = str(tmp_path / "f.png")
    tfd.save_png(p, img)
    assert os.path.exists(p) or os.path.exists(p[:-4] + ".ppm")


def _plane_pair(rng):
    pts = np.stack([rng.uniform(-1, 1, 300), rng.uniform(-1, 1, 300),
                    np.full(300, 2.0)], -1).astype(np.float32)
    jp = jar.detect_plane(pts)
    return jp, tar.Plane(jp.normal.copy(), jp.d, jp.origin.copy(),
                         jp.n_inliers)


def _pose(rng):
    w = rng.normal(0, 0.15, 3)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    return R.astype(np.float32), rng.normal(0, 0.1, 3).astype(np.float32)


# a projected vertex within ~1e-6 px of a .5 boundary would round the other
# way in one package and move its segment by a pixel along part of its
# length; 0 pixels differed on seeds 0-11
MAX_EDGE_PIXELS = 8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ar_overlays_match_jax(seed):
    """``cube_vertices``, ``draw_object_overlay`` (edges and squares, a
    vertex behind the camera) and ``render_ar_frame`` on one plane and one
    pose: cube corners within 1e-6, images pixel-equal or different on at
    most MAX_EDGE_PIXELS pixels."""
    rng = np.random.default_rng(seed)
    jcamera = jcam.pinhole(*CAM_ARGS, **CAM_KW)
    tcamera = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    jp, tp = _plane_pair(rng)
    R, t = _pose(rng)
    jc = jar.cube_vertices(jp, size=0.3, offset_xy=(0.1, -0.05))
    tc = tar.cube_vertices(tp, size=0.3, offset_xy=(0.1, -0.05))
    np.testing.assert_allclose(tc, jc, atol=1e-6)
    gray = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    verts = np.concatenate([rng.uniform(-1, 1, (50, 3)) + [0, 0, 2.5],
                            [[0.0, 0.0, -1.0]]]).astype(np.float32)
    objs_j = [jar.GlObject(verts, np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))]
    objs_t = [tar.GlObject(verts, np.eye(3, dtype=np.float32),
                           np.zeros(3, np.float32))]
    pairs = [
        (jar.draw_object_overlay(jfd.to_rgb(gray), jcamera, R, t, jc,
                                 jar.CUBE_EDGES),
         tar.draw_object_overlay(tfd.to_rgb(gray), tcamera, R, t, tc,
                                 tar.CUBE_EDGES)),
        (jar.draw_object_overlay(jfd.to_rgb(gray), jcamera, R, t, verts),
         tar.draw_object_overlay(tfd.to_rgb(gray), tcamera, R, t, verts)),
        (jar.render_ar_frame(gray, jcamera, R, t, plane=jp, cube_size=0.3,
                             objects=objs_j),
         tar.render_ar_frame(gray, tcamera, R, t, plane=tp, cube_size=0.3,
                             objects=objs_t, device="cpu")),
    ]
    for j_img, t_img in pairs:
        assert t_img.shape == j_img.shape and t_img.dtype == np.uint8
        diff = int((t_img != j_img).any(-1).sum())
        assert diff <= MAX_EDGE_PIXELS, diff
    green = (pairs[2][1][..., 1] == 255) & (pairs[2][1][..., 0] == 0)
    assert green.sum() > 20


def test_render_ar_frame_detects_the_plane_itself(rng):
    """Without a plane, ``render_ar_frame`` fits one on its device: the
    cube is drawn as when the plane is passed in."""
    tcamera = tcam.pinhole(*CAM_ARGS, **CAM_KW)
    pts = np.stack([rng.uniform(-1, 1, 300), rng.uniform(-1, 1, 300),
                    np.full(300, 2.0)], -1).astype(np.float32)
    gray = np.zeros((240, 320), np.float32)
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    img = tar.render_ar_frame(gray, tcamera, eye, zero, pts_world=pts,
                              cube_size=0.3, device="cpu")
    plane = tar.detect_plane(pts, device="cpu")
    ref = tar.render_ar_frame(gray, tcamera, eye, zero, plane=plane,
                              cube_size=0.3, device="cpu")
    np.testing.assert_array_equal(img, ref)
    assert (img[..., 1] == 255).sum() > 20


def test_ply_vertices_and_ar_objects_match_jax(tmp_path, rng):
    pts = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    p = tmp_path / "obj.ply"
    with open(p, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for q in pts:
            f.write(f"{q[0]} {q[1]} {q[2]}\n")
    for cap in (None, 3000):
        np.testing.assert_array_equal(
            tar.load_ply_vertices(str(p), max_points=cap),
            jar.load_ply_vertices(str(p), max_points=cap))
    R, t = _pose(rng)
    np.testing.assert_array_equal(tar.GlObject(pts, R, t).verts_world,
                                  jar.GlObject(pts, R, t).verts_world)


# ---------------------------------------------------------------------------
# the map drawer


def _jax_store(rng, n_kf=6, n_pts=300):
    """A JAX store with keyframes at random poses, points and observations
    whose covisibility weights straddle the drawer's 30."""
    st = JStore(max_kf=16, max_pts=512, max_obs=8192, n_kp=64)
    for k in range(n_kf):
        kf = st.alloc_kf()
        st.kf_mask[kf] = True
        st.kf_R[kf], st.kf_t[kf] = _pose(rng)
    st.kf_mask[2] = False                      # a culled keyframe
    pids = st.alloc_pts(n_pts)
    st.pt_mask[pids] = True
    st.pt_xyz[pids] = rng.normal(size=(n_pts, 3)).astype(np.float32)
    for pid in pids:
        seen = np.nonzero(rng.random(n_kf) < 0.45)[0]
        for k in seen:
            st.add_observations(int(k), np.array([pid]),
                                np.array([int(rng.integers(0, 64))]))
    st.obs_mask[: st._obs_top][rng.random(st._obs_top) < 0.05] = False
    return st


def test_map_drawer_matches_jax_native_path(rng, tmp_path):
    """Frusta equal; covisibility segments equal, in the same order, to the
    JAX drawer on its native path (the port replays the native graph);
    the segment PLY byte-equal; ``render_map_png`` returns what JAX's
    does."""
    _need_native()
    from plvs_tpu import native

    assert native.available()
    js = _jax_store(rng)
    ts = convert.map_store_from_numpy(vars(js))
    np.testing.assert_array_equal(
        tmd.keyframe_frusta(ts.kf_R, ts.kf_t, ts.kf_mask),
        jmd.keyframe_frusta(js.kf_R, js.kf_t, js.kf_mask))
    for w in (15, 30, 60):
        want = jmd.covisibility_segments(js, min_weight=w)
        got = tmd.covisibility_segments(ts, min_weight=w)
        assert got.shape == want.shape and len(want) > 0
        np.testing.assert_array_equal(got, want)
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    labels = rng.integers(0, 5, 20).astype(np.int32)
    jmd.save_segments_ply(str(tmp_path / "j.ply"), pts, labels)
    tmd.save_segments_ply(str(tmp_path / "t.ply"), pts, labels)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    traj = rng.normal(size=(5, 3)).astype(np.float32)
    ok_j = jmd.render_map_png(str(tmp_path / "j.png"), js, traj=traj)
    ok_t = tmd.render_map_png(str(tmp_path / "t.png"), ts, traj=traj,
                              dense_cloud=pts)
    assert ok_t == ok_j
    if ok_t:
        assert os.path.getsize(tmp_path / "t.png") > 1000


def test_rerun_logger_is_a_noop_without_the_sdk():
    assert trl.available() in (True, False)
    trl.log_frame(np.zeros((10, 10)), np.zeros((2, 2)))
    trl.log_map(np.zeros((5, 3)))
    trl.log_trajectory(np.zeros((4, 3)))


# ---------------------------------------------------------------------------
# PLY and GlObjects


def _write_ascii_ply(path, verts, colors=None, faces=None):
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment made by a test\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for i, v in enumerate(verts):
            row = f"{v[0]} {v[1]} {v[2]}"
            if colors is not None:
                row += " {} {} {}".format(*colors[i])
            f.write(row + "\n")
        for tri in faces if faces is not None else ():
            f.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")


def _write_binary_ply(path, verts, colors, faces):
    with open(path, "wb") as f:
        f.write(("ply\nformat binary_little_endian 1.0\n"
                 f"element vertex {len(verts)}\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property float nx\n"
                 "property uchar red\nproperty uchar green\n"
                 "property uchar blue\n"
                 f"element face {len(faces)}\n"
                 "property list uchar int vertex_indices\n"
                 "end_header\n").encode())
        for v, c in zip(verts, colors):
            f.write(struct.pack("<ffffBBB", v[0], v[1], v[2], 0.5, *c))
        for tri in faces:
            f.write(struct.pack("<Biii", 3, *tri))


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_ply_reader_matches_jax(tmp_path, rng):
    """ASCII with colors and faces, ASCII vertices only, binary with an
    extra property and faces, the dense mesh writer's output: the same
    arrays; a file that is not PLY raises in both."""
    from plvs_tpu_torch.dense.meshing import save_mesh_ply

    verts = rng.normal(size=(17, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (17, 3)).astype(np.uint8)
    faces = rng.integers(0, 17, (6, 3)).astype(np.int32)
    files = {"a": (_write_ascii_ply, (verts, cols, faces)),
             "v": (_write_ascii_ply, (verts,)),
             "b": (_write_binary_ply, (verts, cols, faces))}
    for name, (writer, args) in files.items():
        writer(str(tmp_path / f"{name}.ply"), *args)
    save_mesh_ply(str(tmp_path / "m.ply"), verts[:9], faces[:3] % 9)
    for name in ("a", "v", "b", "m"):
        p = str(tmp_path / f"{name}.ply")
        for x, y in zip(tgl.load_ply(p), jgl.load_ply(p)):
            _same(x, y)
    bad = tmp_path / "bad.ply"
    bad.write_text("not a ply\n")
    for mod in (tgl, jgl):
        with pytest.raises(ValueError):
            mod.load_ply(str(bad))


def test_gl_object_list_matches_jax(tmp_path, rng):
    """The settings block with a commented entry, a missing file and poses:
    the same objects, rotations and world points; ``GlObjects.on: 0``
    loads nothing in both."""
    verts = rng.normal(size=(5, 3)).astype(np.float32)
    cols = rng.integers(0, 255, (5, 3)).astype(np.uint8)
    _write_ascii_ply(str(tmp_path / "obj0.ply"), verts, cols)
    _write_ascii_ply(str(tmp_path / "obj1.ply"), verts)
    yaml = tmp_path / "settings.yaml"
    yaml.write_text(
        "Camera.fx: 300.0\nGlObjects.on: 1\n\nGlObjects.list:\n"
        '  - { filename: "obj0.ply", type: "cloudmesh", '
        "pose: [ 0, 0, 0, 0.1, -0.2, 0.3] }\n"
        '#  - { filename: "obj0.ply", type: "cloudmesh" }\n'
        '  - { filename: "missing.ply", type: "cloudmesh" }\n'
        '  - { filename: "obj1.ply", type: "mesh", '
        "pose: [ 1, 2, 3, 0, 0, 1.5707963] }\n")
    t, j = tgl.GlObjectList(), jgl.GlObjectList()
    assert t.load(str(yaml)) and j.load(str(yaml))
    assert len(t) == len(j) == 2
    for a, b in zip(t.objects, j.objects):
        assert (a.type, a.filename) == (b.type, b.filename)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.world_points(), b.world_points())
    for x, y in zip(t.all_world_points(), j.all_world_points()):
        np.testing.assert_array_equal(x, y)
    yaml.write_text("GlObjects.on: 0\nGlObjects.list:\n"
                    '  - { filename: "obj0.ply", type: "cloudmesh" }\n')
    t, j = tgl.GlObjectList(), jgl.GlObjectList()
    assert not t.load(str(yaml)) and not j.load(str(yaml))
    for x, y in zip(t.all_world_points(), j.all_world_points()):
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# the demos


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


# the AR demo's plane: JAX draws its RANSAC samples with jax.random, the
# port from a torch generator, so the two refits may keep a few different
# points at the 2 cm gate
AR_INLIER_TOL = 0.05
AR_ORIGIN_TOL_M = 0.01


def test_demo_ar_matches_jax(tmp_path):
    """``demo_ar --synthetic --frames 6``: the plane locks at the same
    frame, with inliers within 5% and its origin within 1 cm of JAX's;
    the same frames composited and written."""
    from plvs_tpu import demo_ar as jdemo
    from plvs_tpu_torch import demo_ar as tdemo

    args = ["--synthetic", "--frames", "6", "--every", "2"]
    out_j = _run(jdemo.main, args + ["--out", str(tmp_path / "j"), "--cpu"])
    out_t = _run(tdemo.main, args + ["--out", str(tmp_path / "t"), "--cpu"])
    pat = (r"plane locked at frame (\d+): origin=\[([^\]]*)\], "
           r"inliers=(\d+)")
    mj, mt = re.search(pat, out_j), re.search(pat, out_t)
    assert mj and mt, (out_j, out_t)
    assert mt.group(1) == mj.group(1)
    kj, kt = int(mj.group(3)), int(mt.group(3))
    assert abs(kt - kj) <= AR_INLIER_TOL * kj, (kt, kj)
    oj = np.array(mj.group(2).split(), float)
    ot = np.array(mt.group(2).split(), float)
    assert np.abs(ot - oj).max() < AR_ORIGIN_TOL_M
    assert out_t.splitlines()[-1].split(" in ")[0] == \
        out_j.splitlines()[-1].split(" in ")[0]
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))


# segmentation demo: float32 sums in another order move a voxel at the
# TSDF band's edge now and then
SEG_VOXEL_TOL = 0.02


def test_demo_inseg_matches_jax(tmp_path):
    """``demo_inseg --synthetic --frames 10``: the same frames tracked and
    segments, surface voxels within 2%, and a PLY with one row per voxel."""
    from plvs_tpu import demo_inseg as jdemo
    from plvs_tpu_torch import demo_inseg as tdemo

    args = ["--synthetic", "--frames", "10"]
    out_j = _run(jdemo.main, args + ["--out", str(tmp_path / "j"), "--cpu"])
    out_t = _run(tdemo.main, args + ["--out", str(tmp_path / "t"), "--cpu"])
    pat = r"(\d+) frames tracked, (\d+) surface voxels, (\d+) segments"
    (fj, vj, sj), (ft, vt, st) = (
        tuple(int(x) for x in re.search(pat, o).groups())
        for o in (out_j, out_t))
    assert ft == fj and st == sj, (out_t, out_j)
    assert abs(vt - vj) <= SEG_VOXEL_TOL * vj, (vt, vj)
    ply = (tmp_path / "t" / "segments.ply").read_text().splitlines()
    assert f"element vertex {vt}" in ply and len(ply) == vt + 10


def test_demos_default_to_cuda(tmp_path):
    """Without ``--cpu`` the demos run on CUDA, and without CUDA they raise
    before any frame is tracked."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the card tests run the demos")
    from plvs_tpu_torch import demo_ar, demo_inseg

    for main in (demo_ar.main, demo_inseg.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["--synthetic", "--frames", "1", "--out",
                  str(tmp_path / "x")])
