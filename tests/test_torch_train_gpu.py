"""The port's train steps on the card against the same steps on the CPU,
from identical weights and batches (tiny widths, f32). Imports neither
JAX nor the JAX package, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_train_gpu.py

Every test skips where ``torch.cuda.is_available()`` is False.

Tolerances, and why: TF32 is off on both devices, but cuBLAS, cuDNN and
the reductions sum in other orders than the CPU's, and ``torch.gather``'s
backward adds with atomics on the card, so loss figures agree within 1e-4
relative and parameters after two steps within 0.5 of the summed
learning rate everywhere and 1e-2 of it for 99% of the entries (Adam
turns gradient noise into a full step where the exact gradient is 0).
"""


import numpy as np
import pytest
import torch

from semantic_slam_master_tpu_torch import convert
from semantic_slam_master_tpu_torch.cli import train_cli
from semantic_slam_master_tpu_torch.ops.kernels import gather_patches as kgather
from semantic_slam_master_tpu_torch.train import config as tconfig
from semantic_slam_master_tpu_torch.train import seg_trainer
from semantic_slam_master_tpu_torch.train import trainer

pytestmark = pytest.mark.gpu

OVERRIDES = {"model": {"input_size": 64, "num_keypoints": 12, "selector_hidden": 16, "descriptor_dim": 16,
                       "refiner_hidden": 32, "refiner_layers": 3, "estimator_hidden": 16, "backbone_dim": 32,
                       "backbone_depth": 2, "backbone_heads": 2, "backbone_pos_grid": 8},
             "dataset": {"synthetic_frames": 5, "synthetic_worlds": 2}, "training": {"batch_size": 2, "epochs": 2}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _run(cfg, device, batches):
    model, state = trainer.create_train_state(cfg, 4, device=device, dtype=torch.float32)
    step = trainer.make_train_step(model, cfg, trainer.build_optimizer(cfg, 4, trainer.flax_order(state.trainable)))
    outs = []
    for b in batches:
        state, out = step(state, trainer.to_device(b, device))
        outs.append({k: float(v) for k, v in out.items()})
    return outs, trainer.checkpoint_tree(model, state)


def test_train_step_card_vs_cpu(cuda):
    cfg = tconfig.load_config("configs/train_tiny_synthetic.yaml", OVERRIDES)
    batches = list(train_cli._synthetic_pair_batches(cfg, 0)(1))[:2]
    before = kgather.gather_patches.launches
    card, card_state = _run(cfg, cuda, batches)
    assert kgather.gather_patches.launches - before == 2 * len(batches)
    cpu, cpu_state = _run(cfg, "cpu", batches)
    for c, g in zip(cpu, card):
        assert g["skipped"] == c["skipped"] == 0.0
        for k in c:
            np.testing.assert_allclose(g[k], c[k], rtol=1e-4, atol=1e-6, err_msg=k)
    sched = trainer.build_optimizer(cfg, 4).schedule
    lr_sum = float(sched(0)) + float(sched(1))
    errs = np.concatenate([np.abs(card_state[k].astype(np.float64) - cpu_state[k]).ravel() / lr_sum
                           for k in cpu_state if k.startswith("params/")])
    assert errs.max() <= 0.5 and np.quantile(errs, 0.99) <= 1e-2
    for k in cpu_state:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(card_state[k], cpu_state[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_segmenter_step_card_vs_cpu(cuda):
    gen = seg_trainer.synthetic_label_batches(2, (32, 48), seed=0, num_frames=4)
    batches = [next(gen) for _ in range(2)]
    results = []
    for device in (cuda, torch.device("cpu")):
        model = seg_trainer.seg_mod.SemanticSegmenter(width=8, dtype=torch.float32).to(device)
        tx = seg_trainer.make_optimizer(3e-3, 2)
        opt = tx.init(dict(model.named_parameters()))
        step = seg_trainer.make_train_step(model, tx)
        outs = []
        for b in batches:
            opt, m = step(opt, {k: torch.from_numpy(v).to(device) for k, v in b.items()})
            outs.append({k: float(v) for k, v in m.items()})
        results.append((outs, convert.segmenter_tree(model.state_dict())))
    (g_out, g_sd), (c_out, c_sd) = results
    for g, c in zip(g_out, c_out):
        np.testing.assert_allclose(g["loss"], c["loss"], rtol=1e-4)
    lr_sum = 3e-3 * 2
    errs = np.concatenate([np.abs(g_sd[k].astype(np.float64) - c_sd[k]).ravel() / lr_sum for k in c_sd])
    assert errs.max() <= 0.5 and np.quantile(errs, 0.99) <= 1e-2
