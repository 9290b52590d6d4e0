"""The committed trained checkpoints through the port: ``artifacts/
frontend_tiny`` (``configs/train_tiny_synthetic.yaml``) and ``artifacts/
segmenter``, restored by the JAX package (``trainer.restore_checkpoint``
into the state ``trainer.create_train_state`` builds, with its
``model.init`` jitted; ``seg_trainer.load_checkpoint``), converted by
``convert.py`` (also through an ``.npz``), and run by both packages on
synthetic frames. Then SLAM on the trained frontend's float features.

Tolerances, as in tests/test_torch_models.py: at f32 keypoints agree
slot by slot within 1e-3 px and descriptors within 1e-5; at bf16 (the
checkpoints' working dtype) each JAX keypoint has a port keypoint within
0.05 px for >= 95% of them, with descriptor cosine >= 0.99 where a slot
holds the same keypoint, and >= 99.5% of the segmenter's labels agree
(f32: all). SLAM given JAX's features: keyframes identical, poses within
1e-3 m / 1e-3 rad."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.data import synthetic
from semantic_slam_master_tpu.models import segmenter as jseg
from semantic_slam_master_tpu.slam import system as jsystem
from semantic_slam_master_tpu.slam import tracking as jtracking
from semantic_slam_master_tpu.train import config as jconfig
from semantic_slam_master_tpu.train import seg_trainer, trainer
from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.models import segmenter as tseg
from semantic_slam_master_tpu_torch.slam import system as tsystem
from semantic_slam_master_tpu_torch.slam import tracking as ttracking
from semantic_slam_master_tpu_torch.train import config as tconfig

REPO = Path(__file__).resolve().parents[1]
CONFIG = REPO / "configs" / "train_tiny_synthetic.yaml"
FRONTEND = REPO / "artifacts" / "frontend_tiny" / "best_model"
SEGMENTER = REPO / "artifacts" / "segmenter" / "best_model"
FRAMES = 6


@pytest.fixture(scope="module")
def frontend_variables():
    cfg = jconfig.load_config(str(CONFIG))
    model = trainer.build_model(cfg)
    rng, init_rng = jax.random.split(jax.random.PRNGKey(cfg.training.seed))
    size = cfg.model.input_size
    variables = jax.jit(model.init)(init_rng, jnp.zeros((1, size, size, 3)))
    keys = trainer.TRAINABLE_WITH_BACKBONE if cfg.training.train_backbone else trainer.TRAINABLE
    trainable, frozen = trainer.split_params(variables["params"], keys)
    tx = trainer.build_optimizer(cfg, 1)
    state = trainer.TrainState(
        step=jnp.asarray(0, jnp.int32), trainable=trainable, frozen=frozen,
        batch_stats=variables.get("batch_stats", {}), opt_state=tx.init(trainable), rng=rng,
    )
    state, _ = trainer.restore_checkpoint(str(FRONTEND), state)
    variables = {"params": trainer.merge_params(state.trainable, state.frozen), "batch_stats": state.batch_stats}
    return model, jax.device_get(variables)


@pytest.fixture(scope="module")
def frames():
    seq = synthetic.make_sequence(num_frames=FRAMES, scale=0.5)
    fr = [seq.frame(i) for i in range(FRAMES)]
    rgb = np.stack([f["rgb"] for f in fr]).astype(np.float32)
    depth = np.stack([f["depth"] for f in fr]).astype(np.float32)
    return seq, rgb, depth


def _port_frontend(variables, dtype, tmp_path=None):
    tm = tconfig.build_model(tconfig.load_model_config(CONFIG), dtype=dtype)
    source = variables
    if tmp_path is not None:
        source = tmp_path / "frontend.npz"
        convert.save_npz(source, variables)
    tm.load_state_dict(convert.frontend_state_dict(source))
    return tm.eval()


@pytest.fixture(scope="module")
def jax_features(frontend_variables, frames):
    model, variables = frontend_variables
    _, rgb, depth = frames
    out = {}
    for name, dt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        m = model.clone(dtype=dt)
        out[name] = jax.device_get(jax.jit(
            lambda r, d: jtracking.extract_learned_features(m, variables, r, d)
        )(jnp.asarray(rgb), jnp.asarray(depth)))
    return out


def test_trained_frontend_f32(frontend_variables, frames, jax_features, tmp_path):
    _, variables = frontend_variables
    _, rgb, depth = frames
    ref = jax_features["f32"]
    got = ttracking.extract_learned_features(
        _port_frontend(variables, torch.float32, tmp_path), torch.from_numpy(rgb), torch.from_numpy(depth)
    )
    assert np.abs(got.xy.numpy() - ref.xy).max() <= 1e-3
    np.testing.assert_array_equal(got.valid.numpy(), ref.valid)
    np.testing.assert_allclose(got.desc.numpy(), ref.desc, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.sem_weight.numpy(), ref.sem_weight, rtol=0, atol=1e-5)
    # The trained offset head moves keypoints off the 16 px patch centres.
    assert (np.abs(((ref.xy - 8.0) / 16.0) - np.round((ref.xy - 8.0) / 16.0)) > 0.01).mean() > 0.5


def test_trained_frontend_bf16(frontend_variables, frames, jax_features):
    _, variables = frontend_variables
    _, rgb, depth = frames
    ref = jax_features["bf16"]
    got = ttracking.extract_learned_features(
        _port_frontend(variables, torch.bfloat16), torch.from_numpy(rgb), torch.from_numpy(depth)
    )
    a, b = ref.xy, got.xy.numpy()
    nearest = np.sqrt(((a[:, :, None] - b[:, None]) ** 2).sum(-1)).min(-1)
    assert (nearest <= 0.05).mean() >= 0.95, (nearest <= 0.05).mean()
    same = np.abs(a - b).max(-1) <= 0.05
    cos = (got.desc.numpy() * ref.desc).sum(-1)
    assert same.mean() >= 0.2 and cos[same].min() >= 0.99, (same.mean(), cos[same].min())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_trained_segmenter(frames, dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    _, rgb, _ = frames
    params = seg_trainer.load_checkpoint(SEGMENTER)
    jm = jseg.SemanticSegmenter(dtype=jdt)
    ref = np.asarray(jax.jit(lambda x: jm.apply({"params": params}, x, full_res=False))(jnp.asarray(rgb[:4])))
    tm = tseg.SemanticSegmenter(dtype=tdt)
    tm.load_state_dict(convert.segmenter_state_dict(params))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(rgb[:4]), full_res=False).numpy()
    agree = (got.argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= (1.0 if dtype == "f32" else 0.995), agree
    assert len(np.unique(ref.argmax(-1))) >= 3  # a trained map, not one class


def test_slam_on_trained_learned_features(frames, jax_features):
    """SLAM on the trained frontend's float features (JAX's, converted)."""
    seq, _, _ = frames
    jfeats = jax_features["bf16"]
    cfg_j = jsystem.SlamConfig(num_landmarks=1024, window_size=4, ba_iters=3)
    jout = jax.device_get(jsystem.run_slam(
        jax.random.PRNGKey(1), jtracking.FrameFeatures(*[jnp.asarray(x) for x in jfeats]), seq.cam, cfg_j
    ))
    keys = jax.random.split(jax.random.PRNGKey(1), FRAMES)
    u = np.stack([np.zeros((64, 3), np.float32)] + [np.asarray(jax.random.uniform(k, (64, 3))) for k in keys[1:]])
    cfg = tsystem.SlamConfig(num_landmarks=1024, window_size=4, ba_iters=3)
    out = tsystem.run_slam(torch.from_numpy(u), convert.frame_features(jfeats), convert.camera(seq.cam), cfg)
    np.testing.assert_array_equal(out.is_keyframe.numpy(), np.asarray(jout.is_keyframe))
    assert out.num_inliers[1:].min() >= 15
    P, Q = out.poses_wc.numpy(), np.asarray(jout.poses_wc)
    np.testing.assert_allclose(P[:, :3, 3], Q[:, :3, 3], atol=1e-3)
    rel = np.einsum("fji,fjk->fik", P[:, :3, :3].astype(np.float64), Q[:, :3, :3])
    angles = np.arccos(np.clip((np.trace(rel, axis1=1, axis2=2) - 1) / 2, -1, 1))
    assert angles.max() < 1e-3, angles
