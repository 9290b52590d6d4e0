"""The ``model:`` section of a training YAML (port of the model part of
``train/config.py``), its ``training.seed``, and ``build_model``
(``train/trainer.py``).

The YAML is read with PyYAML's ``safe_load``, as the JAX loader reads it
(PyYAML is a dependency of the project, and the card's machine has it).
Unknown keys are ignored with a warning, as the JAX loader does.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from pathlib import Path

import torch
import yaml

from ..models.frontend import LearnedFrontend


@dataclass
class ModelConfig:
    backbone: str = "vit_small_patch16_dinov3.lvd1689m"
    input_size: int = 448
    num_keypoints: int = 500
    selector_hidden: int = 256
    selector_layers: int = 3
    descriptor_dim: int = 128
    refiner_hidden: int = 384
    refiner_layers: int = 4
    estimator_hidden: int = 128
    backbone_depth: int = 12
    backbone_dim: int = 384
    backbone_heads: int = 6
    backbone_pos_grid: int = 28
    subpatch_refine: bool = False


def load_model_config(path) -> ModelConfig:
    """``ModelConfig`` from the ``model:`` section of a training YAML."""
    raw = (yaml.safe_load(Path(path).read_text()) or {}).get("model") or {}
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(raw) - known)
    if unknown:
        warnings.warn(f"{path}: ignoring unknown model keys {unknown}")
    return ModelConfig(**{k: v for k, v in raw.items() if k in known})


def load_training_seed(path=None) -> int:
    """``training.seed`` of a training YAML (0, the JAX ``TrainingConfig``
    default, without one): the seed the JAX trainer initialises the
    frontend's weights from."""
    if path is None:
        return 0
    raw = (yaml.safe_load(Path(path).read_text()) or {}).get("training") or {}
    return int(raw.get("seed", 0))


def build_model(m: ModelConfig, dtype=torch.bfloat16, device=None,
                generator: torch.Generator | None = None) -> LearnedFrontend:
    """The ``LearnedFrontend`` a ``ModelConfig`` describes."""
    return LearnedFrontend(
        embed_dim=m.backbone_dim,
        depth=m.backbone_depth,
        num_heads=m.backbone_heads,
        pos_grid=m.backbone_pos_grid,
        selector_hidden=m.selector_hidden,
        refiner_hidden=m.refiner_hidden,
        refiner_layers=m.refiner_layers,
        descriptor_dim=m.descriptor_dim,
        estimator_hidden=m.estimator_hidden,
        num_keypoints=m.num_keypoints,
        subpatch_refine=m.subpatch_refine,
        dtype=dtype,
        device=device,
        generator=generator,
    )
