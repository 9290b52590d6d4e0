"""The port's scale-out layer in one process (``parallel/tp.py``,
``slam/parallel.py``) against the JAX package's.

- ``spec_for_path`` gives JAX's spec on every leaf of the tiny frontend's
  tree and of configs/train_tiny_synthetic.yaml's (selector, refiner,
  estimator, offset head, batch statistics), the paths compared as
  ``tp._path_str`` writes them; ``shard_tree`` really shards ``fc1`` /
  ``qkv`` (blocks of rows of the port's (out, in) weights: the column
  split) and ``fc2`` / ``proj`` (blocks of columns: the row split).
- The fleet on ``test_fleet_slam.py``'s fake features (S=8, F=6, 128
  landmark slots, 16 hypotheses, 8 inliers): equal to the port's own
  ``run_slam`` of each sequence bit for bit, and to the JAX fleet on the
  8 virtual devices within ``tests/test_torch_slam.py``'s tolerances for
  ``run_slam`` (keyframes, matches and inliers equal; translations within
  1e-3 m, rotations within 1e-3 rad). S that does not divide by the data
  axis raises before any collective.

The spawned multi-rank runs are in ``test_torch_parallel_dist.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.core.camera import TUM_FR2
from semantic_slam_master_tpu.models import frontend as jfrontend
from semantic_slam_master_tpu.parallel import mesh as jmesh
from semantic_slam_master_tpu.parallel import tp as jtp
from semantic_slam_master_tpu.slam import parallel as jfleet
from semantic_slam_master_tpu.slam import system as jsystem
from semantic_slam_master_tpu.train import config as jconfig
from semantic_slam_master_tpu.train import trainer as jtrainer
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.core import prng
from semantic_slam_master_tpu_torch.models import frontend as tfrontend
from semantic_slam_master_tpu_torch.parallel import mesh as tmesh
from semantic_slam_master_tpu_torch.parallel import tp
from semantic_slam_master_tpu_torch.slam import parallel as tfleet
from semantic_slam_master_tpu_torch.slam import system as tsystem
from semantic_slam_master_tpu_torch.train import config as tconfig
from test_fleet_slam import _fake_features


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Small tensors: one intra-op thread (six test workers share the host)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TINY = "configs/train_tiny_synthetic.yaml"


def _trees(kind):
    """(JAX {path: spec}, port {path: spec}) of one model's variables."""
    if kind == "tiny_frontend":
        jm, tm = jfrontend.tiny_frontend(subpatch_refine=True), tfrontend.tiny_frontend(subpatch_refine=True)
    else:
        jm = jtrainer.build_model(jconfig.load_config(TINY))
        tm = tconfig.build_model(tconfig.load_config(TINY).model)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    want = {}

    def visit(path, leaf):
        ps = jtp._path_str(path).rstrip("/")
        want[ps] = tuple(jtp.spec_for_path(ps, leaf.ndim))

    jax.tree_util.tree_map_with_path(visit, shapes)
    got = {tp.flax_path(k, v.shape): spec for (k, v), spec in
           zip(tm.state_dict().items(), tp.tree_shardings(tm.state_dict()).values())}
    return want, got, tm


@pytest.mark.parametrize("kind", ["tiny_frontend", "tiny_synthetic"])
def test_spec_for_path_matches_jax_on_every_leaf(kind):
    want, got, _ = _trees(kind)
    assert set(got) == set(want)
    assert got == want
    sharded = {p for p, s in want.items() if s}
    # the refiner's residual blocks and the estimator are sharded too
    assert any("/refiner/" in p for p in sharded) and any("/estimator/" in p for p in sharded)


def test_shard_tree_really_shards():
    """Model coordinate 1 of 4 (no collective is needed to cut blocks)."""
    _, _, tm = _trees("tiny_frontend")
    sd = tm.state_dict()
    mesh = tmesh.Mesh(num_data=1, num_model=4, model_rank=1)
    blocks = tp.shard_tree(sd, mesh)
    found_col = found_row = 0
    for k, v in sd.items():
        b = blocks[k]
        if k.startswith("backbone.blocks.") and k.endswith((".fc1.weight", ".qkv.weight")):
            n = v.shape[0] // 4
            assert torch.equal(b, v[n : 2 * n]), k
            found_col += k.endswith(".fc1.weight")
        elif k.startswith("backbone.blocks.") and k.endswith((".fc2.weight", ".proj.weight")):
            n = v.shape[1] // 4
            assert torch.equal(b, v[:, n : 2 * n]), k
            found_row += k.endswith(".fc2.weight")
        elif k.endswith((".fc1.bias", ".qkv.bias")):
            assert b.shape == (v.shape[0] // 4,), k
        elif k.endswith((".fc2.bias", ".proj.bias")) or not tp.tree_shardings({k: v})[k]:
            assert b is v, k
    assert found_col == 2 and found_row == 2  # one per block, as JAX's test


S, F = 8, 6
CFG = dict(num_landmarks=128, num_hypotheses=16, min_inliers=8)


@pytest.fixture(scope="module")
def fleet_inputs():
    feats = _fake_features(jax.random.PRNGKey(0), S, F)
    jkeys = jax.random.split(jax.random.PRNGKey(1), S)
    return feats, jkeys, convert.frame_features(feats), prng.split(prng.PRNGKey(1), S)


def test_fleet_equals_each_sequences_run_slam(fleet_inputs):
    _, jkeys, feats, keys = fleet_inputs
    assert np.array_equal(keys, np.asarray(jkeys))
    cfg = tsystem.SlamConfig(**CFG)
    out = tfleet.run_slam_fleet(keys, feats, convert.camera(TUM_FR2), cfg)
    assert out.poses_wc.shape == (S, F, 4, 4)
    for s in range(S):
        u = torch.from_numpy(prng.key_slam_uniforms(keys[s], F, cfg.num_hypotheses))
        one = tsystem.run_slam(u, tsystem.FrameFeatures(*[x[s] for x in feats]), convert.camera(TUM_FR2), cfg)
        for a, b in zip(out, one):
            assert torch.equal(a[s], b)
        dx = out.poses_wc[s, -1, 0, 3] - out.poses_wc[s, 0, 0, 3]
        assert dx > 0.0, f"sequence {s} did not move +x"


def test_fleet_matches_jax_fleet(fleet_inputs):
    jfeats, jkeys, feats, keys = fleet_inputs
    jout = jfleet.run_slam_fleet(jkeys, jfeats, TUM_FR2, jsystem.SlamConfig(**CFG), jmesh.make_mesh())
    out = tfleet.run_slam_fleet(keys, feats, convert.camera(TUM_FR2), tsystem.SlamConfig(**CFG))
    for name in ("is_keyframe", "num_matches", "num_inliers"):
        np.testing.assert_array_equal(getattr(out, name).numpy(), np.asarray(getattr(jout, name)), err_msg=name)
    P, Q = out.poses_wc.numpy().astype(np.float64), np.asarray(jout.poses_wc, np.float64)
    np.testing.assert_allclose(P[..., :3, 3], Q[..., :3, 3], atol=1e-3)  # metres
    R = np.einsum("...ji,...jk->...ik", P[..., :3, :3], Q[..., :3, :3])
    angles = np.arccos(np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1))
    assert angles.max() < 1e-3, angles  # radians


def test_fleet_requires_divisible_sequences(fleet_inputs):
    _, _, feats, keys = fleet_inputs
    three = tsystem.FrameFeatures(*[x[:3] for x in feats])
    with pytest.raises(ValueError, match="3 sequences over a data axis of 2"):
        tfleet.run_slam_fleet(keys[:3], three, convert.camera(TUM_FR2), tsystem.SlamConfig(**CFG),
                              tmesh.Mesh(num_data=2))
