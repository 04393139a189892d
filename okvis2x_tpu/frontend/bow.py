"""Bag-of-binary-words place recognition.

Replaces DBoW2 (reference: okvis_frontend/src/FBrisk.cpp + `Frontend::DBoW`
wrapper, Frontend.cpp:91-115, query filtering at :605) with a dense
formulation:

  * vocabulary = k binary centroids; word assignment of a frame's
    descriptors is one ±1 bfloat16 matmul + argmin (the k-ary tree
    descent of DBoW2 exists to make CPUs fast; a flat matmul suits an
    accelerator for k ≤ a few thousand);
  * vocabulary training = binary k-means (majority vote centroids) on
    descriptors collected online or offline — no pretrained blob needed;
  * scoring = tf-idf weighted L1/cosine on sparse BoW vectors via a host
    inverted index (tiny, latency-insensitive), exactly DBoW2's scoring
    model.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from okvis2x_tpu.frontend.descriptor import DESC_BITS


def train_vocabulary(
    pm1: jax.Array,  # (N, 384) ±1 descriptors
    k: int = 256,
    iters: int = 8,
    seed: int = 0,
) -> jax.Array:
    """Binary k-means: returns (k, 384) ±1 bf16 centroids.

    Distance = Hamming via matmul; update = majority vote (sign of mean).
    """
    n = pm1.shape[0]
    key = jax.random.PRNGKey(seed)
    idx = jax.random.permutation(key, n)[:k]
    centers = pm1[idx].astype(jnp.float32)

    x = pm1.astype(jnp.float32)

    def step(centers, _):
        dots = x @ centers.T  # (N, k); hamming = (BITS - dots)/2
        assign = jnp.argmax(dots, axis=1)
        onehot = jax.nn.one_hot(assign, k, dtype=jnp.float32)  # (N, k)
        sums = onehot.T @ x  # (k, 384)
        counts = onehot.sum(axis=0)[:, None]
        new = jnp.where(counts > 0, jnp.sign(sums + 1e-6), centers)
        return new, None

    centers, _ = jax.lax.scan(step, centers, None, length=iters)
    return centers.astype(jnp.bfloat16)


def assign_words(pm1: jax.Array, vocab: jax.Array) -> jax.Array:
    """(N,) word ids by max correlation (= min Hamming)."""
    dots = jax.lax.dot_general(
        pm1, vocab,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return jnp.argmax(dots, axis=1).astype(jnp.int32)


class HierVocabulary:
    """k-ary vocabulary tree (2 levels), the DBoW2 structure re-shaped as
    matmuls (≙ reference's pretrained `resources/small_voc.yml.gz`, loaded
    at Frontend.cpp:91-115).

    Descent = two matmuls: branch dots (N, B) pick the subtree, then
    leaf dots (N, B*L) are masked to the chosen subtree's leaves and
    argmax'd — same quantisation path as DBoW2's tree descent, no gathers.
    """

    def __init__(self, branches: jax.Array, leaves: jax.Array):
        self.branches = branches  # (B, 384) ±1 bf16
        self.leaves = leaves  # (B*L, 384) ±1 bf16, leaf b*L+l under b
        self.B = branches.shape[0]
        self.L = leaves.shape[0] // self.B

    @property
    def n_words(self) -> int:
        return self.leaves.shape[0]

    def save(self, path: str):
        """Persist packed (bit-level) to .npz — ~200 KB for 64x64."""
        def pack(pm1):
            bits = (np.asarray(pm1, np.float32) > 0).astype(np.uint8)
            return np.packbits(
                bits, axis=1, bitorder="little"
            ).reshape(bits.shape[0], -1, 4).view(np.uint32)[:, :, 0].reshape(
                bits.shape[0], -1
            )
        np.savez_compressed(
            path, branches=pack(self.branches), leaves=pack(self.leaves),
            B=self.B, L=self.L, version=1,
        )

    @classmethod
    def load(cls, path: str) -> "HierVocabulary":
        z = np.load(path)

        def unpack(words):
            bits = np.unpackbits(
                words.view(np.uint8).reshape(words.shape[0], -1),
                axis=1, bitorder="little",
            ).astype(np.float32)
            return jnp.asarray(bits * 2.0 - 1.0, jnp.bfloat16)

        return cls(unpack(z["branches"]), unpack(z["leaves"]))


def train_vocabulary_hier(
    pm1: jax.Array, branch: int = 64, leaf: int = 64, iters: int = 8,
    seed: int = 0,
) -> HierVocabulary:
    """Hierarchical binary k-means: level-1 k-means over the corpus, then
    an independent k-means inside every branch (≙ DBoW2 vocabulary
    creation)."""
    rng = np.random.default_rng(seed)
    branches = train_vocabulary(pm1, k=branch, iters=iters, seed=seed)
    assign = np.asarray(assign_words(pm1, branches))
    x = np.asarray(pm1, np.float32)
    leaves = np.zeros((branch * leaf, x.shape[1]), np.float32)
    for b in range(branch):
        sub = x[assign == b]
        if len(sub) < leaf:
            # thin branch: sample with replacement so every leaf exists
            extra = x[rng.integers(0, len(x), leaf - len(sub) + leaf)]
            sub = np.concatenate([sub, extra]) if len(sub) else extra
        c = train_vocabulary(
            jnp.asarray(sub), k=leaf, iters=iters, seed=seed + 1 + b
        )
        leaves[b * leaf:(b + 1) * leaf] = np.asarray(c, np.float32)
    return HierVocabulary(branches, jnp.asarray(leaves, jnp.bfloat16))


@jax.jit
def _assign_hier(pm1, branches, leaves, L: int):
    f32 = jnp.float32
    d1 = jax.lax.dot_general(
        pm1, branches, (((1,), (1,)), ((), ())), preferred_element_type=f32
    )
    b = jnp.argmax(d1, axis=1)  # (N,)
    d2 = jax.lax.dot_general(
        pm1, leaves, (((1,), (1,)), ((), ())), preferred_element_type=f32
    )  # (N, B*L)
    leaf_branch = jnp.arange(d2.shape[1]) // L  # (B*L,)
    d2 = jnp.where(leaf_branch[None, :] == b[:, None], d2, -jnp.inf)
    return jnp.argmax(d2, axis=1).astype(jnp.int32)


def assign(pm1: jax.Array, vocab) -> jax.Array:
    """Word assignment for either a flat (k, 384) vocabulary array or a
    HierVocabulary tree."""
    if isinstance(vocab, HierVocabulary):
        return _assign_hier(pm1, vocab.branches, vocab.leaves, vocab.L)
    return assign_words(pm1, vocab)


@jax.jit
def _assign_packed_hier(packed, valid, branches, leaves, L):
    from okvis2x_tpu.frontend.descriptor import unpack_pm1

    return _assign_hier(unpack_pm1(packed, valid), branches, leaves, L)


@jax.jit
def _assign_packed_flat(packed, valid, vocab):
    from okvis2x_tpu.frontend.descriptor import unpack_pm1

    return assign_words(unpack_pm1(packed, valid), vocab)


def assign_packed(packed, valid, vocab) -> jax.Array:
    """Unpack + word assignment fused into one device execution (the
    loop-closure path calls this per keyframe record; eager unpacking cost
    a handful of dispatches per call)."""
    packed = jnp.asarray(packed)
    valid = jnp.asarray(valid)
    if isinstance(vocab, HierVocabulary):
        return _assign_packed_hier(
            packed, valid, vocab.branches, vocab.leaves, vocab.L
        )
    return _assign_packed_flat(packed, valid, vocab)


def n_words(vocab) -> int:
    return vocab.n_words if isinstance(vocab, HierVocabulary) else \
        vocab.shape[0]


class BowDatabase:
    """Host inverted index with tf-idf scoring (≙ DBoW2 Database::query)."""

    def __init__(self, k: int):
        self.k = k
        self.inv: List[Dict[int, float]] = [dict() for _ in range(k)]
        self.frame_tf: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.n_frames = 0
        self.word_df = np.zeros(k, np.int64)  # document frequency

    def _bow_vector(self, words: np.ndarray, valid: np.ndarray):
        w = words[valid]
        ids, counts = np.unique(w, return_counts=True)
        tf = counts / max(len(w), 1)
        return ids, tf

    def _idf(self) -> np.ndarray:
        return np.log(max(self.n_frames, 2) / np.maximum(self.word_df, 1))

    def add(self, frame_id: int, words: np.ndarray, valid: np.ndarray):
        ids, tf = self._bow_vector(words, valid)
        for wid, v in zip(ids, tf):
            self.inv[wid][frame_id] = float(v)
            self.word_df[wid] += 1
        self.frame_tf[frame_id] = (ids, tf)
        self.n_frames += 1

    def query(
        self,
        words: np.ndarray,
        valid: np.ndarray,
        exclude: set = frozenset(),
        top: int = 5,
    ) -> List[Tuple[int, float]]:
        """Returns [(frame_id, score)] best-first — cosine similarity of
        tf-idf vectors under the *current* idf (identical frames score 1.0,
        matching DBoW2's normalised scoring)."""
        if self.n_frames == 0:
            return []
        ids, tf = self._bow_vector(words, valid)
        idf = self._idf()
        q_idf = idf[ids]
        scores: Dict[int, float] = {}
        for wid, v, w_idf in zip(ids, tf, q_idf):
            for fid, u in self.inv[wid].items():
                if fid in exclude:
                    continue
                scores[fid] = scores.get(fid, 0.0) + v * u * w_idf * w_idf
        qn = float(np.linalg.norm(tf * q_idf)) + 1e-12
        out = []
        for fid, s in scores.items():
            f_ids, f_tf = self.frame_tf[fid]
            dn = float(np.linalg.norm(f_tf * idf[f_ids])) + 1e-12
            out.append((fid, s / (qn * dn)))
        out.sort(key=lambda x: -x[1])
        return out[:top]
