"""Experiments (counterpart of thyroid_tpu/experiment): the k-fold sweep
and the manager that composes its config. The ablation and all-models
experiments are not ported (ROADMAP Queue 1)."""
from .base_experiment import BaseExperiment
from .kfold_experiment import KFoldExperiment
from .manager import ExperimentManager, launch_experiment

__all__ = ["BaseExperiment", "KFoldExperiment", "ExperimentManager",
           "launch_experiment"]
