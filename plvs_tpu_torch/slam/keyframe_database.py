"""Keyframe database: sparse BoW vectors and an inverted file for place
recognition.

Counterpart of plvs_tpu/slam/keyframe_database.py. Per-keyframe
descriptors descend the vocabulary tree on the device in one batched
``bow.quantize``; the resulting sparse tf-idf word lists feed the host
inverted index below, and queries return the L1 similarity and the shared-
word count of every indexed keyframe, with the 0.8 x max-common-words
prefilter. The JAX package's index is its native C++ ``InvertedIndex``
(plvs_tpu/native/src/plvs_native.cpp); :class:`InvertedIndex` here is a
numpy copy of it that sums each score in the same order in float32, so
its scores are bit-equal and its rankings (a stable sort) the same.

The default vocabulary is the port's copy of the largest shipped tree:
``vocab/data/voc_100k.npz`` (k=10, depth 5) when present, else
``voc_10k.npz``; training from the session's keyframes is the last resort.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..ops import resolve_device
from ..vocab import bow
from .map_store import MapStore

_VOCAB_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "vocab", "data")


def _default_vocab_path() -> str:
    big = os.path.join(_VOCAB_DIR, "voc_100k.npz")
    return big if os.path.exists(big) else os.path.join(
        _VOCAB_DIR, "voc_10k.npz")


_DEFAULT_VOCAB = _default_vocab_path()

# one loaded vocabulary per path for the whole process
_SHARED_VOCABS: dict[str, object] = {}


def _shared_vocab(path: str):
    if path not in _SHARED_VOCABS:
        _SHARED_VOCABS[path] = bow.load_vocabulary(path)
    return _SHARED_VOCABS[path]


class InvertedIndex:
    """Postings lists with DBoW2 L1 scoring (the native index's numpy
    copy). Postings keep insertion order; a keyframe's L1 norm is the
    sequential float32 sum of its |weights|, and a query's score for a
    keyframe is the float32 sum, in query-word order, of |a| + |b| - |a - b|
    over the shared words (a, b the two sides divided by their norms),
    halved — the native loop's arithmetic in its order."""

    def __init__(self, n_words: int):
        self.n_words = n_words
        self._post: dict[int, list] = {}      # word -> [(kf, weight)]
        self._norm: dict[int, np.float32] = {}
        self._arrays: dict[int, tuple] = {}   # word -> (kfs, weights) cache

    def add(self, kf: int, words: np.ndarray, weights: np.ndarray):
        words = np.asarray(words, np.int64)
        weights = np.asarray(weights, np.float32)
        ok = (words >= 0) & (words < self.n_words)
        for w, v in zip(words[ok].tolist(), weights[ok]):
            self._post.setdefault(w, []).append((kf, v))
            self._arrays.pop(w, None)
        s = _seq_sum(np.abs(weights[ok]))
        self._norm[kf] = s if s > 0 else np.float32(1.0)

    def remove(self, kf: int):
        for w, post in self._post.items():
            if any(k == kf for k, _ in post):
                post[:] = [p for p in post if p[0] != kf]
                self._arrays.pop(w, None)
        self._norm.pop(kf, None)

    def _postings(self, w: int):
        arr = self._arrays.get(w)
        if arr is None:
            post = self._post.get(w, ())
            arr = (np.asarray([k for k, _ in post], np.int64),
                   np.asarray([v for _, v in post], np.float32))
            self._arrays[w] = arr
        return arr

    def query(self, words: np.ndarray, weights: np.ndarray, max_kf: int):
        """(scores [max_kf] float32, shared-word counts [max_kf] int32)."""
        words = np.asarray(words, np.int64)
        weights = np.asarray(weights, np.float32)
        scores = np.zeros((max_kf,), np.float32)
        shared = np.zeros((max_kf,), np.int32)
        qs = _seq_sum(np.abs(weights))
        if qs <= 0:
            qs = np.float32(1.0)
        ks, vs, qa = [], [], []
        for i, w in enumerate(words.tolist()):
            if not 0 <= w < self.n_words:
                continue
            k, v = self._postings(w)
            if len(k):
                ks.append(k)
                vs.append(v)
                qa.append(np.full(len(k), weights[i] / qs, np.float32))
        if not ks:
            return scores, shared
        k = np.concatenate(ks)
        keep = k < max_kf
        k = k[keep]
        v = np.concatenate(vs)[keep]
        a = np.concatenate(qa)[keep]
        norm = np.asarray([self._norm[kk] for kk in k.tolist()], np.float32)
        b = v / norm
        term = (np.abs(a) + np.abs(b)) - np.abs(a - b)
        np.add.at(scores, k, term)   # unbuffered, in order: the native sums
        np.add.at(shared, k, 1)
        return scores * np.float32(0.5), shared


def _seq_sum(x: np.ndarray) -> np.float32:
    """Left-to-right float32 sum (np.sum pairs its terms)."""
    if len(x) == 0:
        return np.float32(0.0)
    return np.cumsum(x, dtype=np.float32)[-1]


@dataclasses.dataclass
class KeyFrameDatabase:
    store: MapStore
    voc: object | None = None
    vocab_train_descs: int = 4096
    min_train_descs: int = 1024
    use_default_vocab: bool = True
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._kf_words: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._inv: InvertedIndex | None = None

    # ------------------------------------------------------------------
    def ensure_vocab(self) -> bool:
        if self.voc is not None:
            return True
        if self.use_default_vocab and os.path.exists(_DEFAULT_VOCAB):
            self.voc = _shared_vocab(_DEFAULT_VOCAB)
            return True
        # last resort: train from the session's own keyframes
        st = self.store
        live = np.nonzero(st.kf_mask)[0]
        if len(live) == 0:
            return False
        descs = st.kf_kp_desc[live][st.kf_kp_mask[live]]
        if len(descs) < self.min_train_descs:
            return False
        sel = np.random.default_rng(0).choice(
            len(descs), min(self.vocab_train_descs, len(descs)), replace=False)
        self.voc = bow.train(descs[sel], k=8, depth=3, seed=0)
        return True

    def _index(self) -> InvertedIndex:
        if self._inv is None:
            self._inv = InvertedIndex(self.voc.n_words)
        return self._inv

    # ------------------------------------------------------------------
    def dispatch_quantize(self, desc):
        """Queue the tree descent of [N, 8] descriptors on the database's
        device without reading it back: returns the device word ids (pass
        them, fetched, as ``words``), or None without a vocabulary."""
        if not self.ensure_vocab():
            return None
        if not isinstance(desc, torch.Tensor):
            desc = torch.from_numpy(np.ascontiguousarray(
                np.asarray(desc, np.uint32)).view(np.int32))
        return bow.quantize(self.voc, desc.to(self.device))

    def quantize(self, desc) -> np.ndarray:
        """Word ids of [N, 8] descriptors (uint32 numpy, or int32 words on
        a device), descended on the database's device."""
        return self.dispatch_quantize(desc).cpu().numpy()

    def sparse_bow(self, desc: np.ndarray, mask: np.ndarray, words=None):
        """Quantize descriptors -> sparse L1-normalized tf-idf word list
        (word_ids [S] int32, weights [S] float32)."""
        if words is None:
            words = self.quantize(desc)
        if isinstance(mask, torch.Tensor):
            mask = mask.cpu().numpy()
        words = np.asarray(words)
        words = words[np.asarray(mask, bool) & (words >= 0)]
        if len(words) == 0:
            return (np.zeros((0,), np.int32), np.zeros((0,), np.float32))
        uniq, counts = np.unique(words, return_counts=True)
        idf = np.asarray(self.voc.word_weights)[uniq]
        w = counts.astype(np.float32) * idf
        s = w.sum()
        if s > 0:
            w = w / s
        return uniq.astype(np.int32), w.astype(np.float32)

    # ------------------------------------------------------------------
    def add(self, kf_id: int, words=None) -> bool:
        """Quantize and index a keyframe (``words``: its word ids, when
        already quantized)."""
        if not self.ensure_vocab():
            return False
        st = self.store
        words, weights = self.sparse_bow(
            st.kf_kp_desc[kf_id], st.kf_kp_mask[kf_id], words=words)
        self._kf_words[kf_id] = (words, weights)
        inv = self._index()
        inv.remove(kf_id)   # id reuse after culling
        inv.add(kf_id, words, weights)
        return True

    def remove(self, kf_id: int):
        self._kf_words.pop(kf_id, None)
        if self._inv is not None:
            self._inv.remove(kf_id)

    def rebuild(self):
        """Re-index every live keyframe (after an atlas load)."""
        if not self.ensure_vocab():
            return False
        st = self.store
        self._kf_words.clear()
        self._inv = None
        for k in np.nonzero(st.kf_mask)[0]:
            self.add(int(k))
        return True

    # ------------------------------------------------------------------
    def query_sparse(self, words: np.ndarray, weights: np.ndarray,
                     exclude: set[int] = frozenset(), top_n: int = 5,
                     min_score: float = 0.015,
                     shared_word_filter: bool = True):
        """Score a sparse query against every indexed keyframe: [(kf_id,
        score)] sorted by descending score (stable), after the common-words
        prefilter (candidates must share >= 0.8 x the maximum shared-word
        count)."""
        st = self.store
        if self._inv is None:
            return []
        scores, shared = self._inv.query(words, weights, max_kf=st.max_kf)
        live = np.zeros((st.max_kf,), bool)
        idx = [k for k in self._kf_words if k < st.max_kf]
        live[idx] = True
        live &= st.kf_mask
        for e in exclude:
            if 0 <= e < st.max_kf:
                live[e] = False
        cand = np.nonzero(live & (scores > min_score))[0]
        if len(cand) == 0:
            return []
        if shared_word_filter:
            max_common = shared[cand].max()
            cand = cand[shared[cand] >= 0.8 * max_common]
        order = np.argsort(-scores[cand], kind="stable")
        return [(int(k), float(scores[k])) for k in cand[order][:top_n]]

    def query_keyframe(self, kf_id: int, top_n: int = 5,
                       min_score: float = 0.015,
                       exclude: set[int] = frozenset()):
        """Loop candidates for an indexed keyframe."""
        if kf_id not in self._kf_words:
            return []
        words, weights = self._kf_words[kf_id]
        return self.query_sparse(words, weights, exclude=exclude | {kf_id},
                                 top_n=top_n, min_score=min_score)

    def score_pair(self, kf_a: int, kf_b: int) -> float:
        """L1 similarity between two indexed keyframes."""
        if kf_a not in self._kf_words or kf_b not in self._kf_words:
            return 0.0
        wa, va = self._kf_words[kf_a]
        wb, vb = self._kf_words[kf_b]
        ia = np.isin(wa, wb)
        if not ia.any():
            return 0.0
        ib = np.searchsorted(wb, wa[ia])
        a, b = va[ia], vb[ib]
        return float(0.5 * np.sum(np.abs(a) + np.abs(b) - np.abs(a - b)))

    def relocalization_candidates(self, desc, mask, top_n: int = 5):
        """Candidates for a lost frame (no covisibility gate)."""
        if not self.ensure_vocab():
            return []
        words, weights = self.sparse_bow(desc, mask)
        return self.query_sparse(words, weights, top_n=top_n)
