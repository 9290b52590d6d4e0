"""Bag-of-binary-words place recognition (port of ``slam/bow.py``).

The vocabulary is K 256-bit binary words (packed (K, 8), int64 holding
the JAX package's uint32 patterns, as every packed descriptor of the
port). Assigning N descriptors is one (N, 256) x (256, K) +/-1 product
and an argmax: exact in f32 with TF32 off, and ``torch.argmax`` takes
the first maximum as ``jnp.argmax`` does. A keyframe's signature is the
L2-normalised term-frequency histogram of its words: integer counts, so
bit-identical to JAX's. The k-medians ``train_vocabulary`` copies the JAX
package's numpy RNG calls, so both draw the same farthest-point seeds.

``detect_loops`` scores keyframe pairs by an f32 product of signatures
whose summation order is the library's: scores may differ from JAX's by
an ulp, which matters only where two candidates tie.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.orb import NUM_BITS, pack_bits, to_signs, unpack_bits


def make_vocabulary(num_words: int = 1024, seed: int = 42, device="cpu") -> torch.Tensor:
    """Deterministic random binary vocabulary, packed (K, 8) int64 words."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 2**32, size=(num_words, 8), dtype=np.uint32)
    return torch.from_numpy(words.astype(np.int64)).to(device)


def assign_words(descriptors: torch.Tensor, vocab: torch.Tensor) -> torch.Tensor:
    """Nearest visual word per descriptor. (N, 8) -> (N,) int64."""
    dot = to_signs(descriptors) @ to_signs(vocab).T  # (N, K), max dot == min Hamming
    return torch.argmax(dot, dim=-1)


def tf_signature(word_ids: torch.Tensor, valid: torch.Tensor, num_words: int) -> torch.Tensor:
    """L2-normalised term-frequency histogram of a keyframe's words
    (leading batch dims allowed)."""
    counts = torch.zeros(word_ids.shape[:-1] + (num_words,), dtype=torch.float32,
                         device=word_ids.device)
    counts.scatter_add_(-1, word_ids, valid.to(torch.float32))
    norm = torch.linalg.norm(counts, dim=-1, keepdim=True)
    return counts / torch.clamp(norm, min=1e-8)


def _to_uint32(words: torch.Tensor) -> np.ndarray:
    """Packed int64 words -> the uint32 patterns JAX holds, on the host."""
    return words.cpu().numpy().astype(np.uint32)


def train_vocabulary(
    descriptors: torch.Tensor, num_words: int = 1024, iters: int = 8, seed: int = 0
) -> torch.Tensor:
    """k-medians (Hamming) vocabulary from a descriptor corpus (N, 8).

    Init: greedy farthest-point seeding on a subsample (numpy, the JAX
    package's RNG calls in its order). Update: each centroid becomes the
    bitwise majority of its members (counts summed as integers); an
    empty cluster keeps its centroid.
    """
    n = descriptors.shape[0]
    rng = np.random.default_rng(seed)

    sub_idx = rng.choice(n, size=min(n, 8 * num_words), replace=False)
    sub = _to_uint32(descriptors)[sub_idx]
    sub_bits = np.unpackbits(sub.view(np.uint8), axis=-1)  # (M, 256)
    chosen = [int(rng.integers(len(sub)))]
    min_d = np.full(len(sub), np.inf)
    for _ in range(min(num_words, len(sub)) - 1):
        d = (sub_bits != sub_bits[chosen[-1]][None]).sum(axis=1)
        min_d = np.minimum(min_d, d)
        chosen.append(int(np.argmax(min_d)))
    centroids = sub[np.array(chosen)]
    if centroids.shape[0] < num_words:  # tiny corpus: repeat
        reps = -(-num_words // centroids.shape[0])
        centroids = np.tile(centroids, (reps, 1))[:num_words]
    centroids = torch.from_numpy(centroids.astype(np.int64)).to(descriptors.device)
    bits = unpack_bits(descriptors)  # (N, 256) int64
    for _ in range(iters):
        ids = assign_words(descriptors, centroids)
        counts = torch.bincount(ids, minlength=num_words)
        sums = torch.zeros((num_words, NUM_BITS), dtype=torch.int64, device=bits.device)
        sums.index_add_(0, ids, bits)
        new_centroids = pack_bits(sums * 2 > counts[:, None])
        centroids = torch.where(counts[:, None] > 0, new_centroids, centroids)
    return centroids


class KeyframeDatabase(NamedTuple):
    """Fixed-shape ring database of keyframe BoW signatures."""

    signatures: torch.Tensor  # (M, K_vocab)
    frame_ids: torch.Tensor  # (M,) int64: SLAM frame index of each entry
    valid: torch.Tensor  # (M,) bool
    ptr: int

    @staticmethod
    def create(capacity: int, num_words: int, device="cpu") -> "KeyframeDatabase":
        return KeyframeDatabase(
            signatures=torch.zeros((capacity, num_words), dtype=torch.float32, device=device),
            frame_ids=torch.full((capacity,), -1, dtype=torch.int64, device=device),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            ptr=0,
        )

    def add(self, signature: torch.Tensor, frame_id: int) -> "KeyframeDatabase":
        i = self.ptr
        sigs, fids, valid = self.signatures.clone(), self.frame_ids.clone(), self.valid.clone()
        sigs[i], fids[i], valid[i] = signature, frame_id, True
        return self._replace(signatures=sigs, frame_ids=fids, valid=valid,
                             ptr=(i + 1) % valid.shape[0])

    def query(self, signature: torch.Tensor, current_frame_id: int,
              min_frame_gap: int = 30) -> Tuple[int, float]:
        """Best-matching stored keyframe outside the temporal exclusion
        window: (frame_id, score), frame_id -1 if none scores above 0."""
        scores = self.signatures @ signature
        eligible = self.valid & ((current_frame_id - self.frame_ids) >= min_frame_gap)
        scores = torch.where(eligible, scores, torch.full_like(scores, -1.0))
        best = int(torch.argmax(scores))
        score = float(scores[best])
        return (int(self.frame_ids[best]) if score > 0 else -1), score


def keyframe_signature(descriptors: torch.Tensor, valid: torch.Tensor,
                       vocab: torch.Tensor) -> torch.Tensor:
    """Descriptors (N, 8) + validity -> BoW signature (K_vocab,)."""
    return tf_signature(assign_words(descriptors, vocab), valid, vocab.shape[0])


def detect_loops(
    per_frame_desc: torch.Tensor,
    per_frame_valid: torch.Tensor,
    keyframe_idx: np.ndarray,
    vocab: torch.Tensor,
    min_score: float = 0.35,
    min_frame_gap: int = 30,
):
    """Offline loop detection over a finished sequence's keyframes.

    per_frame_desc (F, N, 8) / valid (F, N); keyframe_idx: frame indices
    that are keyframes. Returns [(frame_i, frame_j, score)] for every
    pair with j at least ``min_frame_gap`` frames before i and a score of
    at least ``min_score``, in row-major (i, j) order.
    """
    kf = np.asarray(keyframe_idx)
    idx = torch.as_tensor(kf, dtype=torch.int64, device=per_frame_desc.device)
    desc, valid = per_frame_desc[idx], per_frame_valid[idx]
    sigs = torch.stack([keyframe_signature(d, v, vocab) for d, v in zip(desc, valid)])
    s = (sigs @ sigs.T).cpu().numpy()  # (Kf, Kf)
    gap_ok = (kf[:, None] - kf[None, :]) >= min_frame_gap
    hit = np.tril(gap_ok & (s >= min_score), -1)
    aa, bb = np.nonzero(hit)
    return [(int(kf[a]), int(kf[b]), float(s[a, b])) for a, b in zip(aa, bb)]


class BowIndex:
    """Incremental BoW keyframe index for online loop closure.

    Buffers keyframe descriptors until ``min_train_keyframes`` have
    arrived, then trains the vocabulary once and freezes it; computes
    each keyframe's signature once (kept on the host, as numpy); scores
    only new keyframes against the stored history per query.
    """

    def __init__(self, num_words: int = 1024, min_train_keyframes: int = 12,
                 vocab: torch.Tensor | None = None):
        self.num_words = num_words
        self.min_train_keyframes = min_train_keyframes
        self.vocab = vocab
        self._buffer: list = []  # [(desc, valid, frame_id)] before the vocabulary
        self.signatures: list = []  # numpy (K_vocab,) per indexed keyframe
        self.frame_ids: list = []

    def add_keyframe(self, desc: torch.Tensor, valid: torch.Tensor, frame_id: int) -> None:
        self._buffer.append((desc, valid, int(frame_id)))
        self._drain()

    def _train(self) -> None:
        corpus = torch.cat([d[v] for d, v, _ in self._buffer])
        if len(corpus) >= 64:
            num_words = int(min(self.num_words, max(64, len(corpus) // 4)))
            self.vocab = train_vocabulary(corpus, num_words=num_words)

    def _drain(self) -> None:
        if self.vocab is None:
            if len(self._buffer) + len(self.frame_ids) < self.min_train_keyframes:
                return
            self._train()
            if self.vocab is None:
                return
        for desc, valid, fid in self._buffer:
            self.signatures.append(keyframe_signature(desc, valid, self.vocab).cpu().numpy())
            self.frame_ids.append(fid)
        self._buffer.clear()

    def force_train(self) -> bool:
        """Train the vocabulary now from whatever is buffered, ignoring
        ``min_train_keyframes`` (the end-of-stream path for sequences too
        short to reach the normal corpus). True if a vocabulary exists
        afterwards."""
        if self.vocab is None and self._buffer:
            self._train()
        self._drain()
        return self.vocab is not None

    def new_candidates(self, num_new: int, min_score: float = 0.35, min_frame_gap: int = 30,
                       per_keyframe: int | None = 3):
        """Score the last ``num_new`` indexed keyframes against all older
        ones: [(frame_new, frame_old, score)], best first, at most
        ``per_keyframe`` partners per new keyframe (numpy, as in JAX)."""
        K = len(self.frame_ids)
        if K < 2 or num_new <= 0:
            return []
        num_new = min(num_new, K)
        sigs = np.stack(self.signatures)
        fids = np.asarray(self.frame_ids)
        s = sigs[K - num_new:] @ sigs.T  # (num_new, K)
        out = []
        for r in range(num_new):
            a = K - num_new + r
            ok = (fids[a] - fids[:a]) >= min_frame_gap
            mine = [(int(fids[a]), int(fids[b]), float(s[r, b]))
                    for b in np.nonzero(ok & (s[r, :a] >= min_score))[0]]
            mine.sort(key=lambda t: -t[2])
            out.extend(mine[:per_keyframe] if per_keyframe else mine)
        out.sort(key=lambda t: -t[2])
        return out
