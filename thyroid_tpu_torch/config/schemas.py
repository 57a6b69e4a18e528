"""Typed (pydantic) validation schemas for the config tree (counterpart
of thyroid_tpu/config/schemas.py, the same models and validators).

Nothing on the experiment path imports this module: `config/__init__.py`
loads it only when one of its names is asked for, so the experiment runs
where pydantic is not installed. The trainer fields keep the JAX
package's names (mesh axes, `remat`, `donate_state`), which the port's
Trainer accepts or refuses as its own docstring says.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from pydantic import BaseModel, Field, field_validator
from pydantic_core.core_schema import ValidationInfo


class PathsConfig(BaseModel):
    data_dir: str = "data/"
    output_dir: str = "outputs/"
    log_dir: str = "logs/"
    checkpoint_dir: str = "checkpoints/"


class BaseModelConfig(BaseModel):
    name: str = Field(..., description="model variant, e.g. resnet50, swin_tiny")
    architecture: str = Field(..., description="'cnn', 'vit' or 'ensemble'")
    pretrained: bool = False
    num_classes: int = 2
    img_size: Optional[int] = None
    in_channels: int = 1
    extra_params: Dict[str, Any] = Field(default_factory=dict)

    model_config = {"extra": "allow"}


class OptimizerParams(BaseModel):
    name: str = "adamw"
    lr: float = 1e-4
    weight_decay: float = 1e-5
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8


class SchedulerParams(BaseModel):
    name: Optional[str] = "cosine"      # cosine | step | constant | None
    eta_min: Optional[float] = 0.0
    warmup_epochs: int = 0
    warmup_steps: int = 0
    step_size: Optional[int] = None
    gamma: Optional[float] = None


class TrainerConfig(BaseModel):
    """JAX runtime knobs — the TPU-native analogue of pl.Trainer args
    (reference: configs/trainer/default.yaml, src/config/schemas.py:67-95)."""

    max_epochs: int = 150
    min_epochs: int = 1
    max_steps: int = -1
    precision: str = "bf16"             # "bf16" | "f32" — compute dtype
    deterministic: bool = True
    gradient_clip_val: Optional[float] = 1.0
    gradient_clip_algorithm: str = "norm"
    accumulate_grad_batches: int = 1
    log_every_n_steps: int = 50
    check_val_every_n_epoch: int = 1
    limit_train_batches: float = 1.0
    limit_val_batches: float = 1.0
    enable_checkpointing: bool = True
    enable_progress_bar: bool = True
    # Mesh layout (replaces strategy/devices/num_nodes):
    mesh_shape: Optional[Dict[str, int]] = None   # e.g. {"data": 8} / {"data": 4, "model": 2}
    data_axis: str = "data"
    model_axis: Optional[str] = None              # set to enable fsdp/tensor sharding
    remat: bool = False                           # jax.checkpoint the blocks
    donate_state: bool = True

    @field_validator("precision")
    @classmethod
    def _precision_valid(cls, v: str) -> str:
        if v not in ("bf16", "f32", "16-mixed", "32-true"):
            raise ValueError("precision must be bf16/f32 (or PL aliases 16-mixed/32-true)")
        return {"16-mixed": "bf16", "32-true": "f32"}.get(v, v)


class TrainingConfig(BaseModel):
    """Training-content config (loss/opt/monitoring) — reference
    src/config/schemas.py:49 + configs/training/base.yaml."""

    epochs: int = 100
    batch_size: int = 32
    monitor_metric: str = "val_acc"
    monitor_mode: str = "max"
    early_stopping_patience: Optional[int] = 10
    save_top_k: int = 3
    save_last: bool = True
    label_smoothing: float = 0.0
    optimizer_params: OptimizerParams = Field(default_factory=OptimizerParams)
    scheduler_params: Optional[SchedulerParams] = Field(default_factory=SchedulerParams)
    layer_decay: Optional[float] = None           # layer-wise lr decay (ViT)
    ema_decay: Optional[float] = None
    # batch MixUp/CutMix (reference: vit_transforms.py:396-462)
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    mixup_prob: float = 1.0

    model_config = {"extra": "allow"}

    @field_validator("monitor_mode")
    @classmethod
    def _mode_valid(cls, v: str) -> str:
        if v not in ("min", "max"):
            raise ValueError('monitor_mode must be "min" or "max"')
        return v


class DatasetConfig(BaseModel):
    """Reference: src/config/schemas.py:117 — same split/quality contract."""

    name: str = "cars_thyroid"
    data_path: str = Field(..., description="root dir containing normal/ and cancerous/")
    use_kfold: bool = False
    split_dir: Optional[str] = "data/splits"
    fold: Optional[int] = None
    split_file_prefix: Optional[str] = "split_fold_"
    split_file: Optional[str] = None
    val_split_ratio: float = 0.2
    test_split_ratio: Optional[float] = None
    random_seed: int = 42
    batch_size: int = 32
    num_workers: int = 0                 # host threads for decode prefetching
    img_size: int = 224
    channels: int = 1
    mean: List[float] = Field(default_factory=lambda: [0.5])
    std: List[float] = Field(default_factory=lambda: [0.5])
    apply_augmentations: bool = False
    augmentation_level: str = "medium"   # none|light|medium|heavy
    quality_preprocessing: bool = False
    quality_report_path: Optional[str] = None
    extreme_dark_threshold: float = 150.0
    low_contrast_threshold: float = 80.0
    artifact_ratio_threshold: float = 30.0
    artifact_percentile: float = 99.9
    synthetic: bool = False              # generate a deterministic synthetic corpus
    synthetic_size: int = 450
    synthetic_difficulty: float = 0.0    # 0 = separable, ~0.65 ≈ 0.85-0.9 acc
    synthetic_label_noise: float = 0.0   # P(image drawn from the other class)

    @field_validator("mean", "std", mode="before")
    @classmethod
    def _mean_std_match_channels(cls, v: Any, info: ValidationInfo) -> List[float]:
        channels = info.data.get("channels", 1) if info.data else 1
        if isinstance(v, (int, float)):
            v = [float(v)]
        if isinstance(v, list) and len(v) == 3 and channels == 1:
            v = [v[0]]
        if not isinstance(v, list) or len(v) != channels:
            raise ValueError(f"{info.field_name} must have {channels} entries, got {v}")
        return [float(x) for x in v]


class KFoldConfig(BaseModel):
    """Reference: src/experiment/config.py:11 (KFoldConfig dataclass)."""

    num_folds: int = 5
    split_dir: str = "data/splits"
    split_file_prefix: str = "split_fold_"
    is_primary_kfold_experiment: bool = False
    shuffle: bool = True
    random_seed: int = 42


class DistillationConfig(BaseModel):
    """Reference: distillation node consumed by
    src/training/lightning_modules.py:742-988."""

    enabled: bool = True
    temperature: float = 4.0
    alpha: float = 0.7
    distillation_type: str = "soft"      # soft (KL) | hard (CE on argmax)
    progressive: bool = False
    alpha_schedule: Optional[List[List[float]]] = None  # [[epoch, alpha], ...]
    teacher_checkpoint: Optional[str] = None
    teacher_model: Optional[Dict[str, Any]] = None
    teacher_checkpoints: Optional[List[str]] = None     # ensemble teacher
    teacher_weights: Optional[List[float]] = None


class AblationParameterConfig(BaseModel):
    """Reconstructed from usage in the reference (which imports but never
    defines it — reference: src/experiment/ablation_experiment.py:74-75)."""

    path: str
    values: List[Any]


class AblationConfig(BaseModel):
    parameter_space: List[AblationParameterConfig] = Field(default_factory=list)
    base_config_path: Optional[str] = None
    name_pattern: str = "ablation_{ablation_count}_{ablation_suffix}"
    is_primary_ablation_experiment: bool = False


class ExperimentConfig(BaseModel):
    """Reference: src/experiment/config.py:28 (ExperimentConfig dataclass)."""

    name: str = "experiment"
    output_dir: str = "outputs"
    model: Dict[str, Any] = Field(default_factory=dict)
    dataset: Dict[str, Any] = Field(default_factory=dict)
    trainer: Dict[str, Any] = Field(default_factory=dict)
    training_content: Dict[str, Any] = Field(default_factory=dict)
    kfold: Optional[Dict[str, Any]] = None
    ablation: Optional[Dict[str, Any]] = None
    distillation: Optional[Dict[str, Any]] = None
    student_model: Optional[Dict[str, Any]] = None
    experiment_class_path: Optional[str] = None
    params: Dict[str, Any] = Field(default_factory=dict)
    seed: int = 42


class MainAppConfig(BaseModel):
    paths: PathsConfig = Field(default_factory=PathsConfig)
    model: BaseModelConfig
    training: TrainingConfig = Field(default_factory=TrainingConfig)
