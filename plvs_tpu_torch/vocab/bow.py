"""Binary bag-of-words vocabulary: hierarchical k-medians over ORB
descriptors and a batched tree descent.

Counterpart of plvs_tpu/vocab/bow.py: the regular trained ``Vocabulary``
(a flattened k^L tree), the irregular ``GeneralVocabulary`` loaded from
DBoW2 text or binary files, ``train`` (host numpy k-medians), and
``quantize``, the descent of a descriptor batch through the tree on the
descriptors' device: per level one [N, k] Hamming argmin over the current
node's children (an XOR and an integer bit count in plain PyTorch, as the
JAX package computes it with jnp outside any Pallas kernel; argmin keeps
the first minimum like jnp.argmin, so word ids match exactly). Tables are
numpy arrays (uint32 words); ``quantize`` keeps one copy of them per
device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


_POP8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                      axis=1).sum(1).astype(np.uint8)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N,8] x [M,8] uint32 -> [N,M] int Hamming (chunked over N so the
    intermediate xor stays bounded for vocabulary-scale N)."""
    n, m = a.shape[0], b.shape[0]
    out = np.empty((n, m), np.int32)
    step = max(1, (1 << 21) // max(m, 1))  # <=64 MB xor intermediates
    for i in range(0, n, step):
        x = a[i:i + step, None, :] ^ b[None, :, :]
        out[i:i + step] = _POP8[x.view(np.uint8)].sum(-1, dtype=np.int32)
    return out


def _kmedians_binary(desc: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-medians (majority-vote medians) over [N,8] uint32."""
    n = len(desc)
    k = min(k, n)
    centers = desc[rng.choice(n, k, replace=False)]
    bits = np.unpackbits(desc.view(np.uint8), axis=-1)  # [N, 256]
    for _ in range(iters):
        d = _hamming_np(desc, centers)
        assign = d.argmin(axis=1)
        new_centers = []
        for c in range(k):
            sel = assign == c
            if not sel.any():
                new_centers.append(desc[rng.integers(n)])
                continue
            maj = (bits[sel].mean(axis=0) > 0.5).astype(np.uint8)
            new_centers.append(np.packbits(maj).view(np.uint32))
        centers = np.stack(new_centers)
    return centers, assign


class Vocabulary(NamedTuple):
    """Flattened k^L tree. Level l has k^(l+1) nodes stored contiguously."""

    k: int                     # branching factor
    depth: int                 # number of levels below the root
    nodes: np.ndarray          # [n_nodes, 8] uint32 node centroids
    level_offset: tuple        # python ints, offset of each level's nodes
    word_weights: np.ndarray   # [n_words] float32 idf weights
    n_words: int

    def save(self, path: str):
        np.savez(path, k=self.k, depth=self.depth, nodes=self.nodes,
                 level_offset=np.asarray(self.level_offset),
                 word_weights=self.word_weights)

    @staticmethod
    def load(path: str) -> "Vocabulary":
        z = np.load(path)
        return Vocabulary(
            int(z["k"]), int(z["depth"]), np.asarray(z["nodes"], np.uint32),
            tuple(int(x) for x in z["level_offset"]),
            np.asarray(z["word_weights"], np.float32),
            int(z["word_weights"].shape[0]))


def train(descriptors: np.ndarray, k: int = 10, depth: int = 3,
          seed: int = 0) -> Vocabulary:
    """Train a k^depth-word vocabulary with hierarchical binary k-medians
    (host numpy, the JAX package's construction and random stream)."""
    rng = np.random.default_rng(seed)
    desc = np.ascontiguousarray(descriptors.astype(np.uint32))

    nodes_per_level = []
    level_sets = [desc]
    for _ in range(depth):
        centers_this_level = []
        next_sets = []
        for subset in level_sets:
            if len(subset) == 0:
                subset = desc[rng.choice(len(desc), 1)]
            c, assign = _kmedians_binary(subset, k, rng)
            # pad to exactly k centers so the tree stays regular
            if len(c) < k:
                c = np.concatenate([c, np.tile(c[-1:], (k - len(c), 1))])
            centers_this_level.append(c)
            for ci in range(k):
                next_sets.append(subset[assign == ci])
        nodes_per_level.append(np.concatenate(centers_this_level))
        level_sets = next_sets

    offsets = []
    off = 0
    for lv in nodes_per_level:
        offsets.append(off)
        off += len(lv)
    nodes = np.concatenate(nodes_per_level)
    n_words = k ** depth

    # idf weights from the training set
    voc = Vocabulary(k, depth, nodes, tuple(offsets),
                     np.ones((n_words,), np.float32), n_words)
    words = quantize(voc, torch.from_numpy(desc.view(np.int32))).numpy()
    counts = np.bincount(words, minlength=n_words).astype(np.float32)
    n_docs = max(len(desc) / 500.0, 1.0)  # pseudo-documents of 500 feats
    idf = np.log(np.maximum(n_docs, 2.0) / (1.0 + counts / 500.0))
    idf = np.maximum(idf, 0.05).astype(np.float32)
    return voc._replace(word_weights=idf)


class GeneralVocabulary(NamedTuple):
    """Irregular-tree vocabulary (explicit children table) for pre-trained
    DBoW2 vocabularies; leaves keep themselves as their single child so the
    fixed-depth descent holds early-terminating branches."""

    k: int                    # max branching factor
    depth: int                # tree depth (descent iterations)
    nodes: np.ndarray         # [n_nodes, 8] uint32 node descriptors
    children: np.ndarray      # [n_nodes, k] int32; -1 = no child
    word_id: np.ndarray       # [n_nodes] int32; -1 = internal node
    word_weights: np.ndarray  # [n_words] float32 (idf)
    n_words: int

    def save(self, path: str):
        np.savez(path, k=self.k, depth=self.depth, nodes=self.nodes,
                 children=self.children, word_id=self.word_id,
                 word_weights=self.word_weights)

    @staticmethod
    def load(path: str) -> "GeneralVocabulary":
        z = np.load(path)
        return GeneralVocabulary(
            int(z["k"]), int(z["depth"]), np.asarray(z["nodes"], np.uint32),
            np.asarray(z["children"], np.int32),
            np.asarray(z["word_id"], np.int32),
            np.asarray(z["word_weights"], np.float32),
            int(z["word_weights"].shape[0]))


def load_dbow2_text(path: str) -> GeneralVocabulary:
    """Parse a DBoW2 text vocabulary (the ORBvoc.txt format).

    Format (reference: TemplatedVocabulary::loadFromTextFile,
    Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1467-1517): header line
    ``k L scoring weighting``; then one line per non-root node in node-id
    order: ``parent_id is_leaf b0 .. b31 weight`` with 32 descriptor bytes.
    Leaves get word ids in node-id order.
    """
    with open(path, "r") as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaf, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf.append(bool(int(parts[1])))
            descs.append([int(b) for b in parts[2:34]])
            weights.append(float(parts[34]))
    return _build_general(
        np.asarray(parents, np.int64), np.asarray(leaf, bool),
        np.asarray(descs, np.uint8), np.asarray(weights, np.float32), k, L)


def save_dbow2_text(voc: GeneralVocabulary, path: str):
    """Write the DBoW2 text format (round-trips through load_dbow2_text)."""
    nodes = np.asarray(voc.nodes).view(np.uint8).reshape(-1, 32)
    children = np.asarray(voc.children)
    word_id = np.asarray(voc.word_id)
    weights = np.asarray(voc.word_weights)
    n = nodes.shape[0]
    parent = np.zeros(n, np.int32)
    for p in range(n):
        for c in children[p]:
            if c > 0 and c != p and parent[c] == 0:
                parent[c] = p
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.depth} 0 0\n")
        for i in range(1, n):
            is_leaf = int(word_id[i] >= 0)
            wt = weights[word_id[i]] if is_leaf else 0.0
            b = " ".join(str(int(x)) for x in nodes[i])
            f.write(f"{parent[i]} {is_leaf} {b} {wt:.6f}\n")


def _build_general(parents: np.ndarray, leaf: np.ndarray,
                   desc_bytes: np.ndarray, weights: np.ndarray,
                   k: int, L: int) -> GeneralVocabulary:
    """Assemble a GeneralVocabulary from per-node arrays (nodes 1..n in file
    order; vectorized children/word-id table construction)."""
    n = len(parents) + 1  # + root
    db = np.zeros((n, 32), np.uint8)
    db[1:] = desc_bytes
    nodes = db.view(np.uint32)

    children = np.full((n, k), -1, np.int32)
    ids = np.arange(1, n, dtype=np.int32)
    order = np.argsort(parents, kind="stable")
    ps = parents[order]
    # slot of each child within its parent (cumcount per parent)
    first = np.r_[True, ps[1:] != ps[:-1]]
    grp_start = np.maximum.accumulate(np.where(first, np.arange(len(ps)), 0))
    slot = np.arange(len(ps)) - grp_start
    ok = slot < k
    children[ps[ok], slot[ok]] = ids[order][ok]

    word_id = np.full(n, -1, np.int32)
    leaf_ids = ids[leaf]
    word_id[leaf_ids] = np.arange(len(leaf_ids), dtype=np.int32)
    w = weights[leaf]
    # leaves keep themselves as their single child so early-terminating
    # branches survive the fixed-depth batched descent
    children[leaf_ids, 0] = leaf_ids
    return GeneralVocabulary(
        k, L, np.asarray(np.ascontiguousarray(nodes)),
        np.asarray(children), np.asarray(word_id),
        np.asarray(np.asarray(w, np.float32)), int(len(leaf_ids)))


_BIN_NODE_DTYPE = np.dtype([
    ("parent", "<i4"), ("desc", "u1", 32), ("weight", "<f4"), ("leaf", "u1"),
])


def load_dbow2_binary(path: str) -> GeneralVocabulary:
    """Parse a DBoW2 binary vocabulary (the ORBvoc.bin format produced by
    the reference's bin_vocabulary converter; layout per
    TemplatedVocabulary::saveToBinaryFile — header of nb_nodes/size_node/
    k/L/scoring/weighting, then packed 41-byte node records
    [parent i32][32 desc bytes][weight f32][is_leaf u8])."""
    with open(path, "rb") as f:
        head = np.frombuffer(f.read(8), "<u4")
        nb_nodes, size_node = int(head[0]), int(head[1])
        k, L, _scoring, _weighting = np.frombuffer(f.read(16), "<i4")
        if size_node != _BIN_NODE_DTYPE.itemsize:
            raise ValueError(
                f"unsupported DBoW2 binary node size {size_node} "
                f"(expected {_BIN_NODE_DTYPE.itemsize} for ORB)")
        rec = np.frombuffer(f.read(nb_nodes * size_node), _BIN_NODE_DTYPE,
                            count=nb_nodes)
    return _build_general(
        rec["parent"].astype(np.int64), rec["leaf"].astype(bool),
        rec["desc"], rec["weight"].astype(np.float32), int(k), int(L))


def save_dbow2_binary(voc: GeneralVocabulary, path: str):
    """Write the DBoW2 binary format (round-trips through
    load_dbow2_binary; also loadable by the reference)."""
    nodes = np.asarray(voc.nodes).view(np.uint8).reshape(-1, 32)
    children = np.asarray(voc.children)
    word_id = np.asarray(voc.word_id)
    weights = np.asarray(voc.word_weights)
    n = nodes.shape[0]
    parent = np.zeros(n, np.int32)
    for p in range(n):
        for c in children[p]:
            if c > 0 and c != p and parent[c] == 0:
                parent[c] = p
    rec = np.zeros(n - 1, _BIN_NODE_DTYPE)
    rec["parent"] = parent[1:]
    rec["desc"] = nodes[1:]
    leaf = word_id[1:] >= 0
    rec["leaf"] = leaf
    rec["weight"][leaf] = weights[word_id[1:][leaf]]
    with open(path, "wb") as f:
        f.write(np.asarray([n - 1, _BIN_NODE_DTYPE.itemsize],
                           "<u4").tobytes())
        f.write(np.asarray([voc.k, voc.depth, 0, 0], "<i4").tobytes())
        f.write(rec.tobytes())


def load_vocabulary(path: str):
    """Load a vocabulary by extension: .npz (native), .txt (DBoW2 text),
    .bin (DBoW2 binary) — the reference's System loads .bin preferred with
    text fallback (src/System.cc:158-196)."""
    if path.endswith(".bin"):
        return load_dbow2_binary(path)
    if path.endswith(".txt"):
        return load_dbow2_text(path)
    return GeneralVocabulary.load(path) if _is_general_npz(path) \
        else Vocabulary.load(path)


def _is_general_npz(path: str) -> bool:
    try:
        with np.load(path) as z:
            return "children" in z.files
    except Exception:
        return False


# one device copy of each vocabulary table, keyed by the array's identity
# (the array itself is kept so its id cannot be reused)
_DEVICE_TABLES: dict = {}


def _on(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (id(arr), str(device))
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        a = np.ascontiguousarray(arr)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        hit = (arr, torch.from_numpy(a).to(device))
        _DEVICE_TABLES[key] = hit
    return hit[1]


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (as uint32), through a byte table."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    pop = _POP8_T.to(x.device)
    return sum(pop[(x >> s) & 0xFF] for s in (0, 8, 16, 24))


_POP8_T = torch.from_numpy(_POP8.astype(np.int32))


def _child_distances(desc: torch.Tensor, cands: torch.Tensor) -> torch.Tensor:
    """[N, 8] x [N, k, 8] int32 words -> [N, k] Hamming distances."""
    return _popcount32(desc[:, None, :] ^ cands).sum(-1)


def _quantize_general(voc: GeneralVocabulary,
                      desc: torch.Tensor) -> torch.Tensor:
    dev = desc.device
    nodes, children = _on(voc.nodes, dev), _on(voc.children, dev).long()
    idx = torch.zeros((desc.shape[0],), dtype=torch.int64, device=dev)
    big = torch.iinfo(torch.int64).max
    for _ in range(voc.depth):
        ch = children[idx]                              # [N, k]
        d = _child_distances(desc, nodes[ch.clamp(min=0)])
        d = torch.where(ch >= 0, d, big)
        nxt = ch.gather(1, torch.argmin(d, dim=-1)[:, None])[:, 0]
        idx = torch.where(nxt >= 0, nxt, idx)
    return _on(voc.word_id, dev).long()[idx]


def quantize(voc, desc: torch.Tensor) -> torch.Tensor:
    """Batched tree descent: [N, 8] int32 descriptor words -> word ids [N]
    int64, on the descriptors' device."""
    if isinstance(voc, GeneralVocabulary):
        return _quantize_general(voc, desc)
    dev = desc.device
    nodes = _on(voc.nodes, dev)
    idx = torch.zeros((desc.shape[0],), dtype=torch.int64, device=dev)
    ar = torch.arange(voc.k, device=dev)
    for lv in range(voc.depth):
        rows = voc.level_offset[lv] + idx[:, None] * voc.k + ar[None, :]
        best = torch.argmin(_child_distances(desc, nodes[rows]), dim=-1)
        idx = idx * voc.k + best
    return idx


def node_ids(voc: Vocabulary, words: torch.Tensor,
             levels_up: int = 1) -> torch.Tensor:
    """Node id ``levels_up`` levels above each word (the FeatureVector
    nodes that gate a BoW-guided search)."""
    return torch.div(words, voc.k ** levels_up, rounding_mode="floor")


def bow_vector(voc, words: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Dense L1-normalized TF-IDF vector [n_words]."""
    ok = mask & (words >= 0)
    v = torch.zeros((voc.n_words,), dtype=torch.float32, device=words.device)
    v.index_add_(0, words.clamp(min=0), ok.to(torch.float32))
    v = v * _on(voc.word_weights, words.device)
    return v / torch.clamp(v.sum(), min=1e-9)


def l1_score(v1: torch.Tensor, v2: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity in [0, 1]: 1 - 0.5 |v1 - v2|_1."""
    return 1.0 - 0.5 * (v1 - v2).abs().sum(-1)


def score_database(query: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """L1 similarity of one BoW vector [W] against each row of a [K, W]
    database."""
    return 1.0 - 0.5 * (db - query[None, :]).abs().sum(-1)
