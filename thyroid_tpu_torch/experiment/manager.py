"""Experiment manager and command-line entry point (counterpart of
thyroid_tpu/experiment/manager.py).

The composed config's `experiment` node is merged into the root groups (a
`config_group` inside a model node loads that model YAML first), the
`augmentation` group's level is carried into the dataset group, and the
experiment is built: the class named by `experiment_class_path`, else
AblationExperiment for a primary ablation node (one with a parameter
space, unless `is_primary_ablation_experiment` says otherwise), else
KFoldExperiment. It runs on the card:

    python -m thyroid_tpu_torch.experiment.manager model=cnn/efficientnet_b0 \
        dataset=synthetic augmentation=no_aug trainer.max_epochs=1 \
        kfold.num_folds=2
"""
from __future__ import annotations

import importlib
import sys
from typing import Any, Optional, Sequence

from ..config import compose
from ..config.loader import load_model_config
from ..config.node import ConfigNode
from ..models.registry import cfg_get
from ..ops.platform import DeviceLike
from ..parallel.mesh import join_from_env
from ..utils.logging import get_logger
from .ablation_experiment import AblationExperiment
from .base_experiment import BaseExperiment
from .kfold_experiment import KFoldExperiment

logger = get_logger(__name__)


class ExperimentManager:
    """Builds and runs the experiment of a composed config on `device`
    (the card unless the CPU is asked for)."""

    def __init__(self, config: ConfigNode, device: DeviceLike = None):
        self.config = config
        self.device = device

    def experiment_config(self) -> ConfigNode:
        """The tree the experiment gets: the experiment node merged in,
        `name` set, the augmentation level in the dataset group. Without
        an experiment node it is `self.config`, updated in place."""
        cfg = self.config
        exp_node = cfg_get(cfg, "experiment", None)
        if exp_node is not None:
            merged = cfg.copy()
            # every key of the experiment node is merged; the four groups
            # below merge into the root's, any other key replaces
            keys = list(exp_node.keys()) if hasattr(exp_node, "keys") else []
            for key in keys:
                v = cfg_get(exp_node, key, None)
                if v is None:
                    continue
                group = cfg_get(v, "config_group", None) if hasattr(v, "get") else None
                if group is not None:
                    base = load_model_config(str(group))
                    base.merge({k2: v2 for k2, v2 in v.items()
                                if k2 != "config_group"})
                    v = base
                if key in ("kfold", "training", "trainer", "dataset") and \
                        key in merged and hasattr(merged[key], "merge"):
                    merged[key] = merged[key].copy()
                    merged[key].merge(v)
                else:
                    merged[key] = v
            cfg = merged
        cfg.setdefault("name", cfg_get(cfg, "experiment_name", None)
                       or cfg_get(cfg_get(cfg, "model", {}), "name", "experiment"))
        # the `augmentation` config group selects the level
        aug_level = cfg_get(cfg_get(cfg, "augmentation", {}) or {}, "level", None)
        if aug_level is not None and "dataset" in cfg:
            cfg["dataset"]["augmentation_level"] = aug_level
            cfg["dataset"]["apply_augmentations"] = aug_level != "none"
        return cfg

    def build_experiment(self) -> BaseExperiment:
        """`experiment_class_path`'s class (called with the config and
        `device=`), else AblationExperiment or KFoldExperiment."""
        cfg = self.experiment_config()
        class_path = cfg_get(cfg, "experiment_class_path", None)
        if class_path:
            module_name, _, cls_name = str(class_path).rpartition(".")
            cls = getattr(importlib.import_module(module_name), cls_name)
            return cls(cfg, device=self.device)
        ablation = cfg_get(cfg, "ablation", None)
        if ablation is not None and cfg_get(
                ablation, "is_primary_ablation_experiment",
                bool(cfg_get(ablation, "parameter_space", None))):
            return AblationExperiment(cfg, device=self.device)
        return KFoldExperiment(cfg, device=self.device)

    def run(self) -> Any:
        experiment = self.build_experiment()
        logger.info("dispatching %s", type(experiment).__name__)
        return experiment.execute()


def launch_experiment(overrides: Optional[Sequence[str]] = None,
                      config_name: str = "config",
                      config_dir: Optional[str] = None,
                      device: DeviceLike = None) -> Any:
    """compose(config_name, overrides) → ExperimentManager(...).run();
    the overrides default to the command line's arguments. Under torchrun
    the process joins the group first (over NCCL on the card, gloo on the
    CPU), so that the corpus, the fold files and the summaries are
    written by rank 0 alone."""
    join_from_env(device)
    cfg = compose(config_name=config_name,
                  overrides=overrides if overrides is not None else sys.argv[1:],
                  config_dir=config_dir)
    return ExperimentManager(cfg, device=device).run()


if __name__ == "__main__":
    launch_experiment()
