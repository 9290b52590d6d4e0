"""The training configuration (port of ``train/config.py``): one
dataclass tree whose YAML keys are the reference's, ``load_config`` /
``to_dict``, the ``model:`` section alone for the inference CLIs, and
``build_model`` (``train/trainer.py``).

The YAML is read with PyYAML's ``safe_load``, as the JAX loader reads it
(PyYAML is a dependency of the project, and the card's machine has it).
Unknown keys are ignored with a warning, as the JAX loader does.
``training.mesh_data`` / ``mesh_model`` shape the trainer's
``('data', 'model')`` mesh (``parallel/mesh.py``); a run whose process
group does not hold that many ranks raises in ``train.trainer.fit``.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

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


@dataclass
class AugmentationConfig:
    enabled: bool = True
    brightness: float = 0.2
    contrast: float = 0.2
    hue: float = 0.1
    saturation: float = 0.2
    gaussian_blur: float = 0.3


@dataclass
class DatasetConfig:
    root: str = "data/tum_rgbd"
    train_sequences: List[str] = field(default_factory=lambda: [
        "rgbd_dataset_freiburg1_desk", "rgbd_dataset_freiburg1_room", "rgbd_dataset_freiburg3_walking_static"])
    val_sequences: List[str] = field(default_factory=lambda: ["rgbd_dataset_freiburg1_plant"])
    test_sequences: List[str] = field(default_factory=lambda: [
        "rgbd_dataset_freiburg3_long_office_household", "rgbd_dataset_freiburg3_walking_xyz"])
    frame_spacing: int = 1
    max_frames: Optional[int] = None
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)
    synthetic: bool = False
    synthetic_frames: int = 64
    synthetic_worlds: int = 3


@dataclass
class LossConfig:
    weights: Dict[str, float] = field(default_factory=lambda: {
        "desc": 8.0, "repeat": 0.3, "variance": 0.5, "peakiness": 0.1, "activation": 0.05,
        "edge": 0.3, "sparsity": 0.3, "calibration": 0.3, "expected_error": 0.02})
    desc_temperature: float = 0.10
    repeat_threshold: float = 2.0
    target_variance: float = 0.22
    sparsity_target: float = 0.35
    edge_threshold: float = 0.1
    sparsity_penalty: float = 2.0
    # InfoNCE positives from the GT depth + pose warp (synthetic recipe).
    gt_supervision: bool = False
    gt_match_radius: float = 6.0
    # Safe-radius, cross-image and hardest-negative mining (needs GT).
    hard_negatives: bool = False
    safe_radius: float = 12.0
    cross_image_negatives: bool = True
    hard_margin: float = 0.2


@dataclass
class TrainingConfig:
    epochs: int = 60
    batch_size: int = 4
    lr: float = 1e-4
    lr_min: float = 1e-6
    weight_decay: float = 1e-4
    grad_clip: float = 1.0
    num_workers: int = 4
    warmup_epochs: int = 3
    val_interval: int = 1
    save_interval: int = 5
    save_dir: str = "checkpoints"
    mesh_data: Optional[int] = None
    mesh_model: int = 1
    steps_per_epoch: Optional[int] = None
    seed: int = 0
    train_backbone: bool = False


@dataclass
class LoggingConfig:
    use_wandb: bool = False
    project: str = "semantic-slam-tpu"
    run_name: str = "run"
    log_interval: int = 50


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    logging: LoggingConfig = field(default_factory=LoggingConfig)


def _update_dataclass(obj, data: dict, path: str = "") -> None:
    for key, value in data.items():
        if not hasattr(obj, key):
            warnings.warn(f"[config] ignoring unknown key {path}{key}")
            continue
        current = getattr(obj, key)
        if dataclasses.is_dataclass(current) and isinstance(value, dict):
            _update_dataclass(current, value, path=f"{path}{key}.")
            continue
        # YAML reads "1e-4" as a string: coerce to the field's number type.
        if isinstance(current, float) and isinstance(value, (str, int)):
            value = float(value)
        elif isinstance(current, int) and not isinstance(current, bool) and isinstance(value, str):
            value = int(float(value))
        setattr(obj, key, value)


def load_config(path=None, overrides: dict | None = None) -> Config:
    """A ``Config`` from a reference-format YAML file and dict overrides."""
    cfg = Config()
    if path is not None:
        _update_dataclass(cfg, yaml.safe_load(Path(path).read_text()) or {})
    if overrides:
        _update_dataclass(cfg, overrides)
    return cfg


def to_dict(cfg: Config) -> dict:
    return dataclasses.asdict(cfg)


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
