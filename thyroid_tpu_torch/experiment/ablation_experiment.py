"""Ablation sweep (counterpart of thyroid_tpu/experiment/ablation_experiment.py):
the cartesian product of `ablation.parameter_space` ([{path, values}]), each
combination a deep copy of the config with its dotted-path overrides; per
run `create_data_loaders`, `Trainer.fit` and `test` on the best checkpoint;
a run that raises is recorded as an "error" row and the sweep goes on;
`ablation_summary.json` names the best run by test accuracy. Everything
runs on `device` (the card unless the CPU is asked for).
"""
from __future__ import annotations

import copy
import itertools
import json
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from ..config.node import ConfigNode
from ..data.pipeline import create_data_loaders
from ..models import cnn, ensemble, vit  # noqa: F401  (register the model families)
from ..models.registry import ModelRegistry, cfg_get
from ..ops.platform import DeviceLike, resolve_device
from ..parallel.mesh import is_lead_process
from ..training.engine import Trainer
from ..utils.logging import get_logger
from .base_experiment import BaseExperiment

logger = get_logger(__name__)


class AblationExperiment(BaseExperiment):
    def __init__(self, config: Any, device: DeviceLike = None):
        super().__init__(config)
        ablation = cfg_get(config, "ablation", {}) or {}
        self.parameter_space = [
            {"path": cfg_get(p, "path"), "values": list(cfg_get(p, "values"))}
            for p in (cfg_get(ablation, "parameter_space", []) or [])
        ]
        self.name_pattern = str(cfg_get(ablation, "name_pattern",
                                        "ablation_{ablation_count}_{ablation_suffix}"))
        self.run_results: List[Dict[str, Any]] = []
        self.summary: Dict[str, Any] = {}
        self.device = resolve_device(device)

    def setup(self) -> None:
        name = cfg_get(self.config, "name", "ablation")
        self.output_dir = Path(cfg_get(self.config, "output_dir", "outputs")) / str(name)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        if not self.parameter_space:
            raise ValueError("ablation.parameter_space is empty")

    def combinations(self) -> List[Dict[str, Any]]:
        paths = [p["path"] for p in self.parameter_space]
        values = [p["values"] for p in self.parameter_space]
        return [dict(zip(paths, combo)) for combo in itertools.product(*values)]

    def _apply_overrides(self, overrides: Dict[str, Any]) -> ConfigNode:
        base = self.config.to_dict() if hasattr(self.config, "to_dict") \
            else copy.deepcopy(dict(self.config))
        node = ConfigNode(base)
        for path, value in overrides.items():
            node.update_path(path, value)
        return node

    def run_single(self, count: int, overrides: Dict[str, Any]) -> Dict[str, Any]:
        cfg = self._apply_overrides(overrides)
        suffix = "_".join(f"{p.split('.')[-1]}={v}" for p, v in overrides.items())
        run_name = self.name_pattern.format(ablation_count=count,
                                            ablation_suffix=suffix)
        run_dir = self.output_dir / run_name
        model_cfg = cfg_get(cfg, "model", {})
        dataset_cfg = cfg_get(cfg, "dataset", {})
        training_cfg = cfg_get(cfg, "training_content", None) or \
            cfg_get(cfg, "training", {})
        trainer_cfg = cfg_get(cfg, "trainer", {})
        arch = str(cfg_get(model_cfg, "architecture", "cnn"))
        if hasattr(dataset_cfg, "to_dict"):
            dataset_cfg = dataset_cfg.to_dict()
        dataset_cfg = dict(dataset_cfg)
        dataset_cfg["img_size"] = int(cfg_get(model_cfg, "img_size", None)
                                      or dataset_cfg.get("img_size", 224))
        bs = cfg_get(training_cfg, "batch_size", None)
        if bs:
            dataset_cfg["batch_size"] = int(bs)
        pipelines = create_data_loaders(
            dataset_cfg, augment_mode="vit" if arch == "vit" else "standard",
            model_config=model_cfg, device=self.device)
        trainer = Trainer(
            ModelRegistry.create_model(model_cfg), model_cfg, training_cfg,
            trainer_cfg, steps_per_epoch=pipelines["train"].steps_per_epoch(),
            output_dir=run_dir, device=self.device)
        fit = trainer.fit(pipelines["train"], pipelines["val"])
        test_metrics = trainer.test(pipelines["test"],
                                    checkpoint=fit.best_checkpoint)
        return {"run": run_name, "overrides": overrides, **test_metrics,
                "best_val_metric": fit.best_metric,
                "epochs_trained": fit.stopped_epoch + 1}

    def run(self) -> Dict[str, Any]:
        for count, overrides in enumerate(self.combinations(), start=1):
            logger.info("ablation run %d: %s", count, overrides)
            try:
                self.run_results.append(self.run_single(count, overrides))
            except Exception as e:  # the sweep goes on
                logger.exception("ablation run %d failed", count)
                self.run_results.append({"error": str(e), "run": count,
                                         "overrides": overrides})
        self.summarize()
        return self.summary

    def summarize(self) -> None:
        valid = [r for r in self.run_results if "error" not in r]
        best = max(valid, key=lambda r: r.get("test_acc", -np.inf), default=None)
        self.summary = {
            "num_runs": len(self.run_results),
            "num_successful": len(valid),
            "best_run": best,
            "all_runs": self.run_results,
            "parameter_space": self.parameter_space,
        }

    def log_results(self) -> None:
        if not is_lead_process():
            return
        path = self.output_dir / "ablation_summary.json"
        with open(path, "w") as f:
            json.dump(self.summary, f, indent=4, default=str)
        logger.info("ablation summary written to %s", path)
