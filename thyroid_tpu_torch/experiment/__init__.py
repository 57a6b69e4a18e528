"""Experiments (counterpart of thyroid_tpu/experiment): the k-fold sweep
(sequential or stacked, with distillation), the ablation sweep, the
all-models sweep and the manager that composes their config."""
from .ablation_experiment import AblationExperiment
from .all_models_experiment import AllModelsFullKFoldExperiment
from .base_experiment import BaseExperiment
from .kfold_experiment import KFoldExperiment
from .manager import ExperimentManager, launch_experiment

__all__ = ["AblationExperiment", "AllModelsFullKFoldExperiment",
           "BaseExperiment", "KFoldExperiment", "ExperimentManager",
           "launch_experiment"]
