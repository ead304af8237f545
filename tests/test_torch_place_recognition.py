"""Place recognition: the port's vocabulary descent and keyframe database
against the JAX package's.

Every comparison here is exact. Word ids are integers from a tree descent
whose per-level distances are integer bit counts and whose argmin keeps the
first minimum in both packages. The sparse BoW lists come from the same
words through the same numpy code. The database's scores come from the
port's numpy inverted index, which sums each score in float32 in the
native C++ index's order, so they are bit-equal to the native ones and the
rankings (a stable sort of them) are the same.
"""

import fcntl
import os
import tempfile
import time

import numpy as np
import pytest
import torch

from plvs_tpu import native
from plvs_tpu.slam import keyframe_database as jkfdb
from plvs_tpu.slam.map_store import MapStore as JMapStore
from plvs_tpu.vocab import bow as jbow
from plvs_tpu_torch import convert
from plvs_tpu_torch.slam import keyframe_database as tkfdb
from plvs_tpu_torch.slam.map_store import MapStore as TMapStore
from plvs_tpu_torch.vocab import bow as tbow


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small CPU ops: one intra-op thread keeps this file from
    oversubscribing the cores the parallel test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need_native(wait_s: float = 180.0):
    """The JAX package's native index / covisibility engine builds with g++
    at first use; the tests that compare against it skip without it.

    Parallel test workers all start that build on a fresh tree and write
    the same temporary file, so a worker can lose the race and cache the
    error for its whole life. On a failed first load this waits, under an
    fcntl lock in the temp directory, for the library another worker
    built, clears the cached error in this process and loads again; it
    skips only when that fails too."""
    if native.available():
        return
    lock_path = os.path.join(tempfile.gettempdir(), "plvs_native_load.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            deadline = time.monotonic() + wait_s
            while time.monotonic() < deadline and not any(
                    n.startswith("_plvs_native_") and n.endswith(".so")
                    for n in os.listdir(native._DIR)):
                time.sleep(0.5)
            native._lib_err = None
            ok = native.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    if not ok:
        pytest.skip("the native library of plvs_tpu did not build: "
                    f"{native.build_error()}")


def _desc(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint64).astype(np.uint32)


def _twords(d: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(d).view(np.int32))


@pytest.fixture(scope="module")
def voc100k():
    j = jbow.Vocabulary.load(jkfdb._DEFAULT_VOCAB)
    t = tbow.Vocabulary.load(tkfdb._DEFAULT_VOCAB)
    return j, t


def test_default_vocabulary_is_the_ports_copy(voc100k):
    """The port loads its own copy of the 100k tree (k=10, depth 5,
    111,110 nodes), byte-identical to the JAX package's."""
    path = os.path.realpath(tkfdb._DEFAULT_VOCAB)
    assert os.sep + "plvs_tpu_torch" + os.sep in path
    assert path.endswith("voc_100k.npz")
    j, t = voc100k
    assert (t.k, t.depth, t.n_words) == (10, 5, 100_000)
    assert t.nodes.shape == (111_110, 8) and t.nodes.dtype == np.uint32
    np.testing.assert_array_equal(t.nodes, np.asarray(j.nodes))
    np.testing.assert_array_equal(t.word_weights, np.asarray(j.word_weights))
    assert t.level_offset == j.level_offset


@pytest.mark.parametrize("n", [1, 7, 1024])
def test_word_ids_on_the_100k_tree(voc100k, rng, n):
    j, t = voc100k
    d = _desc(rng, n)
    wj = np.asarray(jbow.quantize(j, d))
    wt = tbow.quantize(t, _twords(d)).numpy()
    np.testing.assert_array_equal(wt, wj)


def test_word_ids_on_orb_descriptors(voc100k):
    """Real ORB descriptors of a rendered frame (many near-ties between
    sibling nodes) descend to the same words."""
    import jax.numpy as jnp
    from plvs_tpu.features import orb
    from plvs_tpu.geometry import cameras
    from plvs_tpu.io import synthetic

    cam = cameras.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                          bf=24.0)
    scene = synthetic.SyntheticRGBD(cam, wall_z=3.0, seed=3)
    gray, _ = scene.render(*synthetic.default_trajectory(4)[1])
    kp = orb.extract(jnp.asarray(gray, jnp.float32), 512, 4, 1.2)
    d = np.asarray(kp.desc)[np.asarray(kp.mask)]
    j, t = voc100k
    np.testing.assert_array_equal(tbow.quantize(t, _twords(d)).numpy(),
                                  np.asarray(jbow.quantize(j, d)))


def test_train_matches_jax(rng):
    """``train`` runs the same numpy k-medians on the same random stream;
    its idf comes from the port's descent. Nodes, weights and words equal."""
    d = _desc(rng, 3000)
    j = jbow.train(d, k=8, depth=3, seed=0)
    t = tbow.train(d, k=8, depth=3, seed=0)
    np.testing.assert_array_equal(t.nodes, np.asarray(j.nodes))
    np.testing.assert_array_equal(t.word_weights, np.asarray(j.word_weights))
    assert t.level_offset == j.level_offset
    q = _desc(rng, 500)
    np.testing.assert_array_equal(tbow.quantize(t, _twords(q)).numpy(),
                                  np.asarray(jbow.quantize(j, q)))
    # carried across with convert, the JAX tree gives the same words
    tc = convert.vocabulary_from_numpy(
        {k: np.asarray(v) if not isinstance(v, (int, tuple)) else v
         for k, v in j._asdict().items()})
    np.testing.assert_array_equal(tbow.quantize(tc, _twords(q)).numpy(),
                                  np.asarray(jbow.quantize(j, q)))


def _general_tree(tmp_path, rng):
    """A k=10 depth-3 general (DBoW2-style) tree built by the JAX package
    from a trained regular tree's nodes, with two early leaves."""
    d = _desc(rng, 2000)
    reg = jbow.train(d, k=10, depth=2, seed=1)
    nodes = np.asarray(reg.nodes)
    n1 = 10
    parents = np.r_[np.zeros(n1, np.int64),
                    1 + np.repeat(np.arange(n1), 10)]
    leaf = np.r_[np.zeros(n1, bool), np.ones(100, bool)]
    # node 3's subtree collapses: node 3 becomes a leaf itself
    keep = parents != 1 + 2
    leaf[2] = True
    parents, leaf = parents[keep], leaf[keep]
    descs = np.concatenate([nodes[:n1], nodes[n1:][keep[n1:]]])
    w = rng.uniform(0.1, 3.0, len(parents)).astype(np.float32)
    voc = jbow._build_general(parents, leaf, descs.view(np.uint8).reshape(
        -1, 32), w, 10, 2)
    txt = str(tmp_path / "voc.txt")
    jbow.save_dbow2_text(voc, txt)
    binf = str(tmp_path / "voc.bin")
    jbow.save_dbow2_binary(voc, binf)
    npz = str(tmp_path / "voc_general.npz")
    voc.save(npz)
    return voc, (txt, binf, npz)


def test_word_ids_on_a_loaded_general_tree(tmp_path, rng):
    jvoc, paths = _general_tree(tmp_path, rng)
    q = _desc(rng, 800)
    for path in paths:
        j = jbow.load_vocabulary(path)
        t = tbow.load_vocabulary(path)
        assert isinstance(t, tbow.GeneralVocabulary)
        assert t.n_words == j.n_words
        np.testing.assert_array_equal(t.children, np.asarray(j.children))
        np.testing.assert_array_equal(t.word_id, np.asarray(j.word_id))
        np.testing.assert_array_equal(t.word_weights,
                                      np.asarray(j.word_weights))
        np.testing.assert_array_equal(
            tbow.quantize(t, _twords(q)).numpy(),
            np.asarray(jbow.quantize(j, q)), err_msg=path)


def _stores(n_kf: int, n_kp: int = 64, max_kf: int = 8):
    return (JMapStore(max_kf=max_kf, max_pts=256, n_kp=n_kp),
            TMapStore(max_kf=max_kf, max_pts=256, n_kp=n_kp))


def _add_kf(st, d, mask):
    kf = st.alloc_kf()
    st.kf_mask[kf] = True
    st.kf_kp_desc[kf] = d
    st.kf_kp_mask[kf] = mask
    return kf


def test_sparse_bow_lists_match(rng):
    js, ts = _stores(1, n_kp=512)
    jdb = jkfdb.KeyFrameDatabase(js)
    tdb = tkfdb.KeyFrameDatabase(ts, device="cpu")
    assert jdb.ensure_vocab() and tdb.ensure_vocab()
    d = _desc(rng, 512)
    m = rng.random(512) < 0.8
    jw, jv = jdb.sparse_bow(d, m)
    tw, tv = tdb.sparse_bow(d, m)
    np.testing.assert_array_equal(tw, jw)
    np.testing.assert_array_equal(tv, jv)


def test_twin_keyframe_ranked_first_like_native(rng):
    """tests/test_place_recognition.py's twin setup: the twin of keyframe 0
    ranks it first, with scores equal to the native index's."""
    _need_native()
    js, ts = _stores(4)
    jdb = jkfdb.KeyFrameDatabase(js)
    tdb = tkfdb.KeyFrameDatabase(ts, device="cpu")
    descs = [_desc(rng, 64) for _ in range(3)]
    descs.append(descs[0])
    for d in descs:
        jdb.add(_add_kf(js, d, True))
        tdb.add(_add_kf(ts, d, True))
    assert jdb._inv is not None
    jr = jdb.query_sparse(*jdb._kf_words[3], exclude={3})
    tr = tdb.query_sparse(*tdb._kf_words[3], exclude={3})
    assert tr == jr and tr[0][0] == 0, (tr, jr)


def test_rankings_match_native_on_30_keyframes(rng):
    """30 keyframes of partly shared descriptors (so candidates tie and
    the shared-word prefilter binds), two culled and re-added: every query
    of the database gives the native index's list — ids, scores bit for
    bit and order — and the raw scores and shared counts are equal."""
    _need_native()
    js, ts = (JMapStore(max_kf=32, max_pts=256, n_kp=128),
              TMapStore(max_kf=32, max_pts=256, n_kp=128))
    jdb = jkfdb.KeyFrameDatabase(js)
    tdb = tkfdb.KeyFrameDatabase(ts, device="cpu")
    pool = _desc(rng, 400)
    kept = {}
    for _ in range(30):
        d = pool[rng.integers(0, 400, 128)]
        m = rng.random(128) < 0.9
        kf = _add_kf(js, d, m)
        assert _add_kf(ts, d, m) == kf
        kept[kf] = (d, m)
        jdb.add(kf)
        tdb.add(kf)
    for kf in (4, 11):
        jdb.remove(kf)
        tdb.remove(kf)
        jdb.add(kf)
        tdb.add(kf)
    for kf in range(30):
        jw, jv = jdb._kf_words[kf]
        tw, tv = tdb._kf_words[kf]
        np.testing.assert_array_equal(tw, jw)
        np.testing.assert_array_equal(tv, jv)
        js_, jc = jdb._inv.query(jw, jv, max_kf=32)
        ts_, tc = tdb._inv.query(tw, tv, max_kf=32)
        np.testing.assert_array_equal(ts_.view(np.int32), js_.view(np.int32))
        np.testing.assert_array_equal(tc, jc)
        for kw in (dict(), dict(top_n=30, min_score=0.0),
                   dict(top_n=10, exclude={(kf + 1) % 30})):
            assert (tdb.query_keyframe(kf, **kw)
                    == jdb.query_keyframe(kf, **kw)), (kf, kw)
    d, m = kept[7]
    assert (tdb.relocalization_candidates(d, m)
            == jdb.relocalization_candidates(d, m))


def test_system_takes_a_vocabulary_path(tmp_path, rng):
    """``SystemConfig(loop_closing=True, vocabulary_path=...)`` builds a
    System whose database uses that vocabulary: a DBoW2 text file, a
    general-tree .npz or a regular-tree .npz, as the JAX System loads
    them; without a path the database takes the shipped 100k tree."""
    from plvs_tpu_torch.geometry import cameras as tcam
    from plvs_tpu_torch.slam import System, SystemConfig

    cam = tcam.pinhole(300.0, 300.0, 160.0, 120.0, width=320, height=240,
                       bf=24.0)
    gen, (txt, _, npz_general) = _general_tree(tmp_path, rng)
    regular = str(tmp_path / "voc_regular.npz")
    tbow.train(_desc(rng, 1500), k=8, depth=2, seed=0).save(regular)
    for path, kind, n_words in (
            (txt, tbow.GeneralVocabulary, gen.n_words),
            (npz_general, tbow.GeneralVocabulary, gen.n_words),
            (regular, tbow.Vocabulary, 64)):
        system = System(cam, SystemConfig(loop_closing=True,
                                          vocabulary_path=path),
                        device="cpu")
        assert system.loop_closer is not None
        assert system.loop_closer.kfdb is system.kfdb
        assert isinstance(system.kfdb.voc, kind)
        assert system.kfdb.voc.n_words == n_words
    system = System(cam, SystemConfig(), device="cpu")
    assert system.loop_closer is not None and system.kfdb.voc is None
    assert system.kfdb.ensure_vocab() and system.kfdb.voc.n_words == 100_000


def test_dense_bow_vector_and_l1_score(voc100k, rng):
    """The dense tf-idf vector and the DBoW2 L1 score: the same nonzero
    words, values and scores within 1e-6 (float32 sums over 100k words in
    another order)."""
    j, t = voc100k
    d = _desc(rng, 600)
    m = rng.random(600) < 0.9
    jv = np.asarray(jbow.bow_vector(j, jbow.quantize(j, d), m))
    tv = tbow.bow_vector(t, tbow.quantize(t, _twords(d)),
                         torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(np.nonzero(tv)[0], np.nonzero(jv)[0])
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    d2 = d.copy()
    d2[::2] = _desc(rng, 300)
    jv2 = np.asarray(jbow.bow_vector(j, jbow.quantize(j, d2), m))
    tv2 = tbow.bow_vector(t, tbow.quantize(t, _twords(d2)),
                          torch.from_numpy(m)).numpy()
    for a, b in ((tv, tv), (tv, tv2)):
        got = float(tbow.l1_score(torch.from_numpy(a), torch.from_numpy(b)))
        want = float(jbow.l1_score(a, b))
        np.testing.assert_allclose(got, want, atol=1e-6)
    assert float(tbow.l1_score(torch.from_numpy(tv),
                               torch.from_numpy(tv))) == 1.0


@pytest.mark.parametrize("levels_up", [1, 2, 4])
def test_node_ids_exact(voc100k, rng, levels_up):
    j, t = voc100k
    d = _desc(rng, 300)
    jw = jbow.quantize(j, d)
    tw = tbow.quantize(t, _twords(d))
    np.testing.assert_array_equal(
        tbow.node_ids(t, tw, levels_up).numpy(),
        np.asarray(jbow.node_ids(j, jw, levels_up)))


def test_score_database(voc100k, rng):
    """One query against a [K, W] database: within 1e-6 (float32 sums over
    100k words in another order), the query's own row scoring 1."""
    j, t = voc100k
    rows = []
    for _ in range(5):
        d = _desc(rng, 200)
        rows.append(np.asarray(jbow.bow_vector(j, jbow.quantize(j, d),
                                               np.ones(200, bool))))
    db = np.stack(rows)
    got = tbow.score_database(torch.from_numpy(db[2]),
                              torch.from_numpy(db)).numpy()
    np.testing.assert_allclose(got, np.asarray(jbow.score_database(db[2], db)),
                               atol=1e-6)
    assert abs(got[2] - 1.0) < 1e-6 and (got[[0, 1, 3, 4]] < 0.5).all()


def test_dense_vector_query_like_native(rng):
    """``bow_of_desc`` gives the dense vector ``bow_vector`` gives (within
    1e-6, the same nonzero words); ``query`` with one such vector ranks the
    database as the JAX package's native index does, scores bit for bit."""
    _need_native()
    js, ts = (JMapStore(max_kf=16, max_pts=256, n_kp=128),
              TMapStore(max_kf=16, max_pts=256, n_kp=128))
    jdb = jkfdb.KeyFrameDatabase(js)
    tdb = tkfdb.KeyFrameDatabase(ts, device="cpu")
    pool = _desc(rng, 300)
    for _ in range(12):
        d = pool[rng.integers(0, 300, 128)]
        m = rng.random(128) < 0.9
        kf = _add_kf(js, d, m)
        assert _add_kf(ts, d, m) == kf
        jdb.add(kf)
        tdb.add(kf)
    d = pool[rng.integers(0, 300, 128)]
    m = rng.random(128) < 0.9
    jv, tv = jdb.bow_of_desc(d, m), tdb.bow_of_desc(d, m)
    assert tv.dtype == np.float32 and tv.shape == jv.shape
    np.testing.assert_array_equal(np.nonzero(tv)[0], np.nonzero(jv)[0])
    np.testing.assert_allclose(tv, jv, atol=1e-6)
    for kw in (dict(), dict(top_n=12, min_score=0.0),
               dict(top_n=3, exclude={0, 5})):
        got, want = tdb.query(jv, **kw), jdb.query(jv, **kw)
        assert got == want and len(got) > 0, (kw, got, want)
