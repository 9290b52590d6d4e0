"""The port's training config (``train/config.py``): its ``ModelConfig``
equals the JAX package's for every config of the repo (the port's own
backbone fields, ``PORT_MODEL_FIELDS``, aside), unknown keys warn, and
``build_model`` sizes the frontend as the JAX one does."""

from pathlib import Path

import numpy as np
import pytest
import torch

from semantic_slam_master_tpu.train import config as jconfig
from semantic_slam_master_tpu_torch.train import config as tconfig

REPO = Path(__file__).resolve().parents[1]
CONFIGS = sorted((REPO / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_model_config_equals_jax(path):
    ref = jconfig.load_config(str(path)).model
    got = tconfig.load_model_config(path)
    assert set(vars(got)) - set(vars(ref)) == set(tconfig.PORT_MODEL_FIELDS)
    shared = [k for k in vars(got) if k not in tconfig.PORT_MODEL_FIELDS]
    assert {k: getattr(got, k) for k in shared} == {k: getattr(ref, k) for k in shared}


def test_unknown_keys_warn(tmp_path):
    p = tmp_path / "c.yaml"
    p.write_text("model:\n  backbone_dim: 96\n  not_a_key: 3\n")
    with pytest.warns(UserWarning, match="not_a_key"):
        cfg = tconfig.load_model_config(p)
    assert cfg.backbone_dim == 96 and cfg.num_keypoints == 500


def test_build_model_sizes_match_jax_config():
    """The full ViT-S/16 recipe: parameter count per module equals the
    flax model's (counted from the JAX package's shapes)."""
    import jax
    import jax.numpy as jnp

    from semantic_slam_master_tpu.train import trainer

    path = REPO / "configs" / "train_vits_synthetic_long.yaml"
    jm = trainer.build_model(jconfig.load_config(str(path)))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    jcount = {k: sum(int(np.prod(x.shape)) for x in jax.tree.leaves(v)) for k, v in shapes["params"].items()}
    tm = tconfig.build_model(tconfig.load_model_config(path), generator=torch.Generator().manual_seed(0))
    tcount = {k: sum(p.numel() for p in m.parameters()) for k, m in tm.named_children() if m is not None}
    assert tcount == jcount
    assert tm.subpatch_refine and tm.num_keypoints == 500
    assert tm.backbone.embed_dim == 384 and len(tm.backbone.blocks) == 12
