"""All-models k-fold sweep (counterpart of
thyroid_tpu/experiment/all_models_experiment.py): the model YAMLs under
configs/model/{cnn,vit} (config/loader.list_model_configs, templates
excluded), or `model_names`; per model the composed config with that
model, quality preprocessing forced on and the model's input size, run
as a KFoldExperiment on `device`; per model the test accuracy's
average, spread, extremes and best fold (`_aggregate_model`), and only
the best fold's best checkpoint kept (`_prune_checkpoints`);
`all_models_summary.json`. Reach it with
`experiment_class_path=thyroid_tpu_torch.experiment.all_models_experiment.AllModelsFullKFoldExperiment`;
there the config's `model_names` list, when set, limits the sweep.
"""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from ..config.loader import list_model_configs, load_model_config
from ..config.node import ConfigNode
from ..models.registry import cfg_get
from ..ops.platform import DeviceLike
from ..parallel.mesh import barrier, is_lead_process
from ..utils.logging import get_logger
from .base_experiment import BaseExperiment
from .kfold_experiment import KFoldExperiment

logger = get_logger(__name__)


class AllModelsFullKFoldExperiment(BaseExperiment):
    def __init__(self, config: Any, config_dir: Optional[str] = None,
                 model_names: Optional[List[str]] = None,
                 device: DeviceLike = None):
        super().__init__(config)
        self.config_dir = config_dir
        if model_names is None and cfg_get(config, "model_names", None):
            model_names = [str(n) for n in cfg_get(config, "model_names")]
        self.model_names = model_names
        self.model_results: Dict[str, Any] = {}
        self.device = device

    def setup(self) -> None:
        self.output_dir = Path(cfg_get(self.config, "output_dir", "outputs")) \
            / "all_models_kfold"
        self.output_dir.mkdir(parents=True, exist_ok=True)
        if self.model_names is None:
            self.model_names = list_model_configs(self.config_dir)
        logger.info("sweeping %d models: %s", len(self.model_names),
                    self.model_names)

    def _model_experiment_config(self, model_option: str) -> ConfigNode:
        base = self.config.to_dict() if hasattr(self.config, "to_dict") \
            else copy.deepcopy(dict(self.config))
        cfg = ConfigNode(base)
        cfg["model"] = load_model_config(model_option, self.config_dir).to_dict()
        # quality preprocessing forced on, the model's input size, one
        # output tree for every model
        if "dataset" in cfg:
            cfg["dataset"]["quality_preprocessing"] = True
            cfg["dataset"]["img_size"] = cfg["model"].get("img_size", 224)
        cfg["output_dir"] = str(self.output_dir)
        cfg["name"] = cfg["model"].get("name", model_option)
        return cfg

    def run(self) -> Dict[str, Any]:
        for option in self.model_names:
            name = option.split("/")[-1]
            logger.info("===== model %s =====", name)
            try:
                exp = KFoldExperiment(self._model_experiment_config(option),
                                      device=self.device)
                results = exp.execute()
                self.model_results[name] = self._aggregate_model(name, results)
                self._prune_checkpoints(exp, results)
            except Exception as e:  # the sweep goes on
                logger.exception("model %s failed", name)
                self.model_results[name] = {"error": str(e)}
        return self.model_results

    @staticmethod
    def _aggregate_model(name: str, results: Dict[str, Any]) -> Dict[str, Any]:
        folds = [r for r in results.get("raw_fold_results", [])
                 if "error" not in r]
        accs = [r["test_acc"] for r in folds
                if isinstance(r.get("test_acc"), (int, float))]
        out = {
            "model": name,
            "num_successful_folds": len(folds),
            "avg_accuracy": float(np.mean(accs)) if accs else None,
            "std_accuracy": float(np.std(accs)) if accs else None,
            "max_accuracy": float(np.max(accs)) if accs else None,
            "min_accuracy": float(np.min(accs)) if accs else None,
            "avg_test_auc": results.get("avg_test_auc"),
            "per_fold": folds,
        }
        if accs:
            out["best_fold"] = int(folds[int(np.argmax(accs))]["fold"])
        return out

    def _prune_checkpoints(self, exp: KFoldExperiment,
                           results: Dict[str, Any]) -> None:
        """Keep only the best fold's best checkpoint (as
        `{model}/best_checkpoint`); remove the fold directories (rank 0
        under torchrun, the others waiting)."""
        folds = [r for r in results.get("raw_fold_results", [])
                 if "error" not in r and "best_checkpoint" in r]
        if not folds:
            return
        if not is_lead_process():
            barrier()
            return
        best = max(folds, key=lambda r: r.get("test_acc", -np.inf))
        best_ckpt = Path(best["best_checkpoint"])
        keep_dir = exp.output_dir / "best_checkpoint"
        if best_ckpt.exists():
            if keep_dir.exists():
                shutil.rmtree(keep_dir)
            shutil.copytree(best_ckpt, keep_dir)
        for fold in range(1, exp.num_folds + 1):
            shutil.rmtree(exp.output_dir / f"fold_{fold}", ignore_errors=True)
        barrier()

    def log_results(self) -> None:
        if not is_lead_process():
            return
        path = self.output_dir / "all_models_summary.json"
        with open(path, "w") as f:
            json.dump(self.model_results, f, indent=4, default=str)
        ranked = sorted(
            [(k, v.get("avg_accuracy")) for k, v in self.model_results.items()
             if isinstance(v, dict) and v.get("avg_accuracy") is not None],
            key=lambda kv: kv[1], reverse=True)
        logger.info("all-models leaderboard: %s", ranked)
