"""Port parity on the CPU for the slice's semantic and learned paths:
``extract_features(weight_map=...)`` (a full-resolution map; the
quarter-resolution map and ``detect(score_weight=...)`` are in
tests/test_torch_semantic.py), ``extract_learned_features``, SLAM on float descriptors, and the
``run-slam --frontend learned --semantics model`` / ``--dynamic
--semantics gt`` CLI end to end.

Tolerances, and why: the ORB pyramid is an ulp off JAX's (ROADMAP
Queue 3), so as in tests/test_torch_frontend.py a keypoint "coincides"
when its slot holds the same detection within 1e-3 px, >= 98% must, and
their semantic weights are then identical. SLAM on float
descriptors takes ±1/16 unpacked ORB bits as unit 256-d descriptors, so
every cosine is a multiple of 1/256, exact in any summation order, and
keyframes and matches must be identical and poses within 1e-3 m /
1e-3 rad (solver arithmetic, as in tests/test_torch_slam.py)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.models import frontend as jfrontend
from semantic_slam_master_tpu.models import segmenter as jseg
from semantic_slam_master_tpu.ops import orb as jorb
from semantic_slam_master_tpu.slam import system as jsystem
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.cli import evaluate_cli, run_slam_cli
from semantic_slam_master_tpu_torch.models import frontend as tfrontend
from semantic_slam_master_tpu_torch.models import segmenter as tseg
from semantic_slam_master_tpu_torch.slam import system as tsystem
from semantic_slam_master_tpu_torch.slam import tracking as ttracking

FRAMES = 8


@pytest.fixture(scope="module")
def dynamic_frames():
    seq = synthetic.make_dynamic_sequence(num_frames=FRAMES, scale=0.5)
    fr = [seq.frame(i) for i in range(FRAMES)]
    rgb = np.stack([f["rgb"] for f in fr]).astype(np.float32)
    gray = (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]).astype(np.float32)
    depth = np.stack([f["depth"] for f in fr]).astype(np.float32)
    labels = np.stack([f["labels"] for f in fr])
    return seq, rgb, gray, depth, labels


@pytest.fixture(scope="module")
def jax_weighted(dynamic_frames):
    """JAX's ORB features of every frame with the GT class-weight map."""
    _, _, gray, depth, labels = dynamic_frames
    wmap = np.asarray(jseg.class_weights_map(jnp.asarray(labels)))
    feats = jax.jit(lambda g, d, w: jtracking.extract_features(g, d, num_keypoints=400, weight_map=w))(
        jnp.asarray(gray), jnp.asarray(depth), jnp.asarray(wmap)
    )
    return wmap, jax.device_get(feats)


def check_weighted(got, ref, expect_dynamic=True):
    got = convert.frame_features_to_numpy(got)
    coincide = (np.abs(got["xy"] - ref.xy).max(-1) <= 1e-3) & (got["valid"] == ref.valid)
    assert coincide[ref.valid].mean() >= 0.98, coincide[ref.valid].mean()
    np.testing.assert_array_equal(got["sem_weight"][coincide], np.asarray(ref.sem_weight)[coincide])
    # An ulp of the pyramid can move a blurred pixel across a quantisation
    # step and flip one descriptor bit.
    same_desc = (got["desc"] == np.asarray(ref.desc)).all(-1)[coincide].mean()
    assert same_desc >= 0.99, same_desc
    assert (got["sem_weight"] == 1.0).any()
    assert (got["sem_weight"] < 0.1).any() == expect_dynamic


def test_extract_features_with_full_res_weight_map(dynamic_frames, jax_weighted):
    _, _, gray, depth, _ = dynamic_frames
    wmap, ref = jax_weighted
    got = ttracking.extract_features(torch.from_numpy(gray), torch.from_numpy(depth), num_keypoints=400,
                                     weight_map=torch.from_numpy(wmap))
    check_weighted(got, ref)


def test_extract_learned_features_matches_jax(dynamic_frames):
    """The adapter around a tiny f32 frontend (seeded flax weights,
    converted), with a full-resolution weight map multiplying the
    confidence."""
    _, rgb, _, depth, labels = dynamic_frames
    rgb, depth = rgb[:2, :224, :304], depth[:2, :224, :304]
    wmap = np.asarray(jseg.class_weights_map(jnp.asarray(labels[:2, :224, :304])))
    jm = jfrontend.tiny_frontend(subpatch_refine=True, dtype=jnp.float32)
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 224, 304, 3))))
    ref = jax.device_get(jax.jit(
        lambda r, d, w: jtracking.extract_learned_features(jm, variables, r, d, weight_map=w)
    )(jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(wmap)))
    tm = tfrontend.tiny_frontend(subpatch_refine=True, dtype=torch.float32)
    tm.load_state_dict(convert.frontend_state_dict(variables))
    got = ttracking.extract_learned_features(tm.eval(), torch.from_numpy(rgb), torch.from_numpy(depth),
                                             weight_map=torch.from_numpy(wmap))
    assert np.abs(got.xy.numpy() - ref.xy).max() <= 1e-3
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_array_equal(got.depth.numpy(), ref.depth)
    np.testing.assert_allclose(got.desc.numpy(), ref.desc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sem_weight.numpy(), ref.sem_weight, rtol=0, atol=1e-5)
    assert got.desc.dtype == torch.float32 and got.desc.shape == (2, 64, 32)


@pytest.fixture(scope="module")
def float_run(dynamic_frames, jax_weighted):
    seq = dynamic_frames[0]
    feats = jtracking.FrameFeatures(*[jnp.asarray(x) for x in jax_weighted[1]])
    # Unit 256-d float descriptors from the packed words: every cosine is
    # a multiple of 1/256, exact in any order of summation.
    desc = jorb.unpack_bits(feats.desc).astype(jnp.float32) * (2.0 / 16.0) - 1.0 / 16.0
    feats = feats._replace(desc=desc)
    cfg = jsystem.SlamConfig(num_landmarks=1024, window_size=4, ba_iters=3)
    out = jsystem.run_slam(jax.random.PRNGKey(3), feats, seq.cam, cfg)
    return seq, jax.device_get(feats), jax.device_get(out)


def test_run_slam_on_float_descriptors_matches_jax(float_run):
    seq, jfeats, jout = float_run
    feats = convert.frame_features(jfeats)
    assert feats.desc.dtype == torch.float32
    keys = jax.random.split(jax.random.PRNGKey(3), FRAMES)
    u = np.stack([np.zeros((64, 3), np.float32)] + [np.asarray(jax.random.uniform(k, (64, 3))) for k in keys[1:]])
    cfg = tsystem.SlamConfig(num_landmarks=1024, window_size=4, ba_iters=3)
    out = tsystem.run_slam(torch.from_numpy(u), feats, convert.camera(seq.cam), cfg)
    np.testing.assert_array_equal(out.is_keyframe.numpy(), np.asarray(jout.is_keyframe))
    np.testing.assert_array_equal(out.num_matches.numpy(), np.asarray(jout.num_matches))
    np.testing.assert_array_equal(out.num_inliers.numpy(), np.asarray(jout.num_inliers))
    assert out.num_matches[1:].min() > 50
    P, Q = out.poses_wc.numpy(), np.asarray(jout.poses_wc)
    np.testing.assert_allclose(P[:, :3, 3], Q[:, :3, 3], atol=1e-3)
    rel = np.einsum("fji,fjk->fik", P[:, :3, :3].astype(np.float64), Q[:, :3, :3])
    angles = np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert angles.max() < 1e-3, angles


def test_match_features_dispatches_on_dtype():
    cfg = tsystem.SlamConfig()
    words = torch.randint(0, 2**32, (5, 8), dtype=torch.int64)
    m = tsystem.match_features(words, words, torch.ones(5, dtype=torch.bool), torch.ones(5, dtype=torch.bool), cfg)
    assert m.valid.all() and torch.equal(m.idx2, torch.arange(5))
    desc = torch.nn.functional.normalize(torch.randn(5, 16), dim=-1)
    m = tsystem.match_features(desc, desc, torch.ones(5, dtype=torch.bool), torch.ones(5, dtype=torch.bool), cfg)
    assert m.valid.all() and torch.equal(m.idx2, torch.arange(5))
    state = tsystem.init_map(cfg, "cpu", desc_dim=16, desc_dtype=torch.float32)
    assert state.descriptors.dtype == torch.float32 and state.descriptors.shape == (2048, 16)


def _run_cli(tmp_path, *extra):
    args = ["--synthetic", "--synthetic-frames", "6", "--synthetic-scale", "0.5", "--num-landmarks", "512",
            "--window-size", "3", "--ba-iters", "2", "--device", "cpu", "--output-dir", str(tmp_path), *extra]
    assert run_slam_cli.main(args) == 0
    assert evaluate_cli.main(["--trajectories", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "results.json").read_text())
    (name, r), = res.items()
    return name, r


def test_cli_learned_frontend_with_segmenter(tmp_path, capsys):
    name, r = _run_cli(tmp_path, "--frontend", "learned", "--train-config", "configs/train_tiny_synthetic.yaml",
                       "--semantics", "model")
    out = capsys.readouterr()
    assert "weights seeded from training.seed 0" in out.err  # the tiny config's seed
    assert "weights seeded from 0 as the JAX CLI seeds them" in out.err
    assert "'frontend': 'learned'" in out.out and "'finite_poses': True" in out.out
    assert r["status"] == "success" and np.isfinite(r["ate"]["rmse"])


def test_cli_dynamic_with_gt_semantics(tmp_path, capsys):
    name, r = _run_cli(tmp_path, "--dynamic", "--semantics", "gt", "--num-keypoints", "300")
    assert name == "synthetic_room_dynamic" and r["status"] == "success"
    assert r["ate"]["rmse"] < 0.05, r["ate"]
    assert "'semantics': 'gt'" in capsys.readouterr().out


def test_segmenter_weight_maps_are_quarter_resolution():
    rgb = np.random.default_rng(0).random((3, 64, 96, 3), dtype=np.float32)
    model = tseg.SemanticSegmenter(generator=torch.Generator().manual_seed(0)).eval()
    w = run_slam_cli.semantic_weight_maps(rgb, None, "model", torch.device("cpu"), model)
    assert w.shape == (3, 16, 24) and w.dtype == torch.float32
    assert set(np.unique(w.numpy())) <= set(np.float32(tseg.DEFAULT_CLASS_WEIGHTS))
