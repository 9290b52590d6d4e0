"""Port parity: ``slam/bow.py`` of semantic_slam_master_tpu_torch against
the JAX package's on the CPU, on seeded random descriptors.

Tolerances: vocabulary words, word ids and ``train_vocabulary``'s
centroids exact (+/-1 products of 256 terms are exact in f32, the argmax
takes the first maximum in both, the k-medians update sums integers, and
the farthest-point seeding copies the JAX package's numpy RNG calls);
signatures within 1e-6 (integer counts over an f32 norm); ``detect_loops``
and ``BowIndex.new_candidates`` give the same (frame_i, frame_j) lists in
the same order, scores within 1e-6. Their order sorts by score, so a tie
between two candidates' f32 scores could decide it: the fixtures place
each revisit at its own overlap so that no two candidates tie."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.slam import bow as jbow
from semantic_slam_master_tpu_torch.slam import bow as tbow


def _desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def _t(words):
    return torch.from_numpy(np.asarray(words).astype(np.int64))


def test_make_vocabulary_matches_jax():
    for k, seed in ((64, 42), (1024, 42), (100, 7)):
        np.testing.assert_array_equal(tbow.make_vocabulary(k, seed).numpy(),
                                      np.asarray(jbow.make_vocabulary(k, seed)).astype(np.int64))


@pytest.mark.parametrize("num_words", [16, 256])
def test_assign_words_and_signature_match_jax(num_words):
    rng = np.random.default_rng(num_words)
    vocab = np.asarray(jbow.make_vocabulary(num_words, seed=3))
    desc = _desc(rng, 500)
    desc[:16] = vocab[:16]  # descriptors equal to a word map to it
    valid = rng.random(500) < 0.8
    j_ids = np.asarray(jbow.assign_words(jnp.asarray(desc), jnp.asarray(vocab)))
    t_ids = tbow.assign_words(_t(desc), _t(vocab)).numpy()
    np.testing.assert_array_equal(t_ids, j_ids)
    j_sig = np.asarray(jbow.keyframe_signature(jnp.asarray(desc), jnp.asarray(valid), jnp.asarray(vocab)))
    t_sig = tbow.keyframe_signature(_t(desc), torch.from_numpy(valid), _t(vocab)).numpy()
    np.testing.assert_allclose(t_sig, j_sig, atol=1e-6, rtol=0)
    # a batch of keyframes at once, as detect_loops may use it
    t_batch = tbow.tf_signature(torch.stack([torch.from_numpy(t_ids)] * 2),
                                torch.from_numpy(np.stack([valid, ~valid])), num_words).numpy()
    np.testing.assert_allclose(t_batch[0], j_sig, atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        t_batch[1], np.asarray(jbow.tf_signature(jnp.asarray(j_ids), jnp.asarray(~valid), num_words)),
        atol=1e-6, rtol=0)


def test_empty_signature_is_zero():
    vocab = tbow.make_vocabulary(32)
    sig = tbow.keyframe_signature(vocab[:5], torch.zeros(5, dtype=torch.bool), vocab)
    assert float(sig.abs().sum()) == 0.0


@pytest.mark.parametrize("n,num_words,iters", [(3000, 64, 8), (40, 64, 3), (900, 128, 5)])
def test_train_vocabulary_matches_jax(n, num_words, iters):
    rng = np.random.default_rng(n)
    proto = _desc(rng, 12)
    flips = rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)
    corpus = proto[rng.integers(0, 12, size=n)] ^ (flips & flips >> 3 & np.uint32(0x11111111))
    j = np.asarray(jbow.train_vocabulary(jnp.asarray(corpus), num_words=num_words, iters=iters))
    t = tbow.train_vocabulary(_t(corpus), num_words=num_words, iters=iters)
    assert t.dtype == torch.int64 and t.shape == (num_words, 8)
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))


def _revisits(rng, num_frames=40, n=80):
    """Frames of random descriptors in which frame f >= 24 revisits frame
    f - 24 with an overlap that differs per frame (no two scores tie)."""
    frames = [_desc(rng, n) for _ in range(num_frames)]
    for f in range(24, num_frames):
        keep = 30 + 3 * (f - 24)
        frames[f][:keep] = frames[f - 24][:keep]
    valid = rng.random((num_frames, n)) < 0.95
    return np.stack(frames), valid


def test_detect_loops_matches_jax():
    rng = np.random.default_rng(11)
    desc, valid = _revisits(rng)
    vocab = np.asarray(jbow.make_vocabulary(256, seed=5))
    kf = np.arange(0, 40, 1)
    j = jbow.detect_loops(jnp.asarray(desc), jnp.asarray(valid), kf, jnp.asarray(vocab),
                          min_score=0.3, min_frame_gap=10)
    t = tbow.detect_loops(_t(desc), torch.from_numpy(valid), kf, _t(vocab), min_score=0.3,
                          min_frame_gap=10)
    assert len(j) >= 10
    assert [(a, b) for a, b, _ in t] == [(a, b) for a, b, _ in j]
    np.testing.assert_allclose([s for *_, s in t], [s for *_, s in j], atol=1e-6)


def test_keyframe_database_matches_jax():
    rng = np.random.default_rng(2)
    vocab = np.asarray(jbow.make_vocabulary(128))
    descs = [_desc(rng, 40) for _ in range(5)]
    v = np.ones(40, bool)
    jdb = jbow.KeyframeDatabase.create(capacity=4, num_words=128)
    tdb = tbow.KeyframeDatabase.create(capacity=4, num_words=128)
    for fid, d in zip([0, 10, 20, 30, 40], descs):  # five into four slots: the ring wraps
        jdb = jdb.add(jbow.keyframe_signature(jnp.asarray(d), jnp.asarray(v), jnp.asarray(vocab)), fid)
        tdb = tdb.add(tbow.keyframe_signature(_t(d), torch.from_numpy(v), _t(vocab)), fid)
    for q, cur, gap in ((1, 45, 30), (2, 45, 20), (0, 45, 30), (3, 35, 100)):
        sig = jbow.keyframe_signature(jnp.asarray(descs[q]), jnp.asarray(v), jnp.asarray(vocab))
        jf, js = jdb.query(sig, current_frame_id=cur, min_frame_gap=gap)
        tf, ts = tdb.query(torch.from_numpy(np.asarray(sig)), current_frame_id=cur, min_frame_gap=gap)
        assert tf == int(jf)
        assert abs(ts - float(js)) <= 1e-6


def test_bow_index_matches_jax():
    """Keyframes arrive one by one; the vocabulary trains once the
    twelfth arrives; each pass scores the newest keyframes."""
    rng = np.random.default_rng(4)
    desc, valid = _revisits(rng, num_frames=40, n=60)
    j_idx, t_idx = jbow.BowIndex(), tbow.BowIndex()
    for f in range(40):
        j_idx.add_keyframe(desc[f], valid[f], f)
        t_idx.add_keyframe(_t(desc[f]), torch.from_numpy(valid[f]), f)
        assert t_idx.frame_ids == j_idx.frame_ids
        if f % 5 == 4 and j_idx.vocab is not None:
            j = j_idx.new_candidates(5, min_score=0.25, min_frame_gap=10)
            t = t_idx.new_candidates(5, min_score=0.25, min_frame_gap=10)
            assert [(a, b) for a, b, _ in t] == [(a, b) for a, b, _ in j]
            np.testing.assert_allclose([s for *_, s in t], [s for *_, s in j], atol=1e-6)
    np.testing.assert_array_equal(t_idx.vocab.numpy(), np.asarray(j_idx.vocab).astype(np.int64))
    np.testing.assert_allclose(np.stack(t_idx.signatures), np.stack(j_idx.signatures), atol=1e-6)
    assert len(j_idx.new_candidates(40, min_score=0.25, min_frame_gap=10)) >= 5


def test_bow_index_force_train_matches_jax():
    rng = np.random.default_rng(8)
    desc, valid = _revisits(rng, num_frames=6, n=60)
    j_idx, t_idx = jbow.BowIndex(), tbow.BowIndex()
    for f in range(6):
        j_idx.add_keyframe(desc[f], valid[f], f)
        t_idx.add_keyframe(_t(desc[f]), torch.from_numpy(valid[f]), f)
    assert t_idx.vocab is None and j_idx.vocab is None
    assert t_idx.force_train() and j_idx.force_train()
    np.testing.assert_array_equal(t_idx.vocab.numpy(), np.asarray(j_idx.vocab).astype(np.int64))
    assert t_idx.frame_ids == j_idx.frame_ids == list(range(6))
