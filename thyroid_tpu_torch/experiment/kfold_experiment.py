"""K-fold cross-validation experiment (counterpart of
thyroid_tpu/experiment/kfold_experiment.py).

- setup: the fold split files are generated from the corpus when missing
  (in the dataset's split_dir, which wins over the kfold group's);
- per fold: the dataset config gets the fold's split file, each split is
  decoded into a DevicePipeline (create_data_loaders), the model is built
  from the registry, the teacher from the distillation node when it is
  enabled (create_teacher_from_config), `Trainer.fit` trains it and
  `Trainer.test` evaluates the best checkpoint; the fold's row holds the
  test metrics, the best epoch's val metrics, the epochs trained and the
  wall time;
- `kfold.stacked`: every fold at once (training/stacked.py), falling back
  to the sequential sweep when the folds' splits differ in shape;
- a fold that raises is logged and recorded as {"error", "fold"}, and the
  sweep goes on;
- aggregation: avg_/std_ over the finite numbers of the successful folds,
  over the union of their keys; log_results writes
  kfold_summary_<prefix>.json, with the student and teacher names and the
  student's parameter count under distillation.

Everything runs on `device` (the card unless the CPU is asked for).

Over slices (`kfold.num_slices` > 1, parallel/multislice.py): this
process runs the folds `partition_folds` gives `kfold.slice_index` (round
robin) and writes kfold_summary_<prefix>_slice<i>.json with `slice_index`
and `num_slices`; `merge_slice_summaries` of the slice files is the
one-process summary. Under torchrun (`trainer.mesh_shape`), every rank
runs every fold data-parallel, and only rank 0 writes the split files and
the summary.
"""
from __future__ import annotations

import copy
import json
import time
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

from ..data.corpus import generate_kfold_splits
from ..data.dataset import CARSThyroidDataset
from ..data.pipeline import DevicePipeline, create_data_loaders
from ..models import cnn, ensemble, vit  # noqa: F401  (register the model families)
from ..models.base import num_parameters
from ..models.registry import ModelRegistry, cfg_get
from ..ops.platform import DeviceLike, resolve_device
from ..training.checkpoint import create_teacher_from_config
from ..parallel.mesh import barrier, is_lead_process, lead_value
from ..parallel.multislice import partition_folds
from ..training.engine import Trainer
from ..utils.logging import get_logger
from .base_experiment import BaseExperiment

logger = get_logger(__name__)


class KFoldExperiment(BaseExperiment):
    def __init__(self, config: Any, device: DeviceLike = None):
        super().__init__(config)
        self.kfold_config = cfg_get(config, "kfold", {}) or {}
        self.fold_results: List[Dict[str, Any]] = []
        self.aggregated_results: Dict[str, Any] = {}
        self.model_config = cfg_get(config, "student_model", None) or \
            cfg_get(config, "model", {})
        self.dataset_config = cfg_get(config, "dataset", {})
        self.trainer_config = cfg_get(config, "trainer", {})
        self.training_config = cfg_get(config, "training_content", None) or \
            cfg_get(config, "training", {})
        self.distillation_config = cfg_get(config, "distillation", None)
        self.num_folds = int(cfg_get(self.kfold_config, "num_folds", 5))
        self.num_slices = int(cfg_get(self.kfold_config, "num_slices", 1))
        self.slice_index = int(cfg_get(self.kfold_config, "slice_index", 0))
        self.device = resolve_device(device)

    def _distilling(self) -> bool:
        return bool(self.distillation_config) and \
            bool(cfg_get(self.distillation_config, "enabled", True))

    def _teacher(self):
        """The distillation teacher on the device, or None."""
        if not self._distilling():
            return None
        return create_teacher_from_config(self.distillation_config,
                                          device=self.device)

    # ------------------------------------------------------------------
    def setup(self) -> None:
        name = cfg_get(self.model_config, "name", "model")
        self.output_dir = Path(cfg_get(self.config, "output_dir", "outputs")) / str(name)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self._ensure_split_files()

    def _split_dir(self) -> str:
        """Fold files live with the corpus: the dataset's split_dir wins
        over the kfold group's, so that fold indices of one corpus never
        select frames of another."""
        ds = cfg_get(self.dataset_config, "split_dir", None)
        if ds:
            return str(ds)
        return str(cfg_get(self.kfold_config, "split_dir", "data/splits"))

    def _ensure_split_files(self) -> None:
        """Generate the rotating fold files when any is missing."""
        split_dir = Path(self._split_dir())
        prefix = cfg_get(self.kfold_config, "split_file_prefix", "split_fold_")
        # rank 0's view decides, so every rank takes the same branch (and
        # meets the corpus's barrier inside CARSThyroidDataset)
        missing = lead_value([n for n in range(1, self.num_folds + 1)
                              if not (split_dir / f"{prefix}{n}.json").exists()])
        if not missing:
            return
        ds = CARSThyroidDataset(self.dataset_config, split="all")
        if is_lead_process():        # rank 0 writes them, the others wait
            generate_kfold_splits(
                ds.all_labels, self.num_folds, split_dir,
                random_seed=int(cfg_get(self.kfold_config, "random_seed", 42)),
                prefix=prefix)
            logger.info("generated %d fold split files in %s", self.num_folds,
                        split_dir)
        barrier()

    # ------------------------------------------------------------------
    def _fold_dataset_config(self, fold: int) -> Dict[str, Any]:
        cfg = copy.deepcopy(self.dataset_config.to_dict()
                            if hasattr(self.dataset_config, "to_dict")
                            else dict(self.dataset_config))
        prefix = cfg_get(self.kfold_config, "split_file_prefix", "split_fold_")
        cfg["split_file"] = str(Path(self._split_dir()) / f"{prefix}{fold}.json")
        cfg["use_kfold"] = True
        cfg["fold"] = fold
        # training.batch_size takes precedence over the dataset default
        bs = cfg_get(self.training_config, "batch_size", None)
        if bs:
            cfg["batch_size"] = int(bs)
        return cfg

    def _build_pipelines(self, fold: int) -> Dict[str, DevicePipeline]:
        dcfg = self._fold_dataset_config(fold)
        arch = str(cfg_get(self.model_config, "architecture", "cnn"))
        augment_mode = "vit" if arch == "vit" else "standard"
        # the model's input size wins over the dataset's
        dcfg["img_size"] = int(cfg_get(self.model_config, "img_size", None)
                               or dcfg.get("img_size", 224))
        return create_data_loaders(dcfg, augment_mode=augment_mode,
                                   model_config=self.model_config,
                                   device=self.device)

    def run_fold(self, fold: int) -> Dict[str, Any]:
        t0 = time.time()
        pipelines = self._build_pipelines(fold)
        model = ModelRegistry.create_model(self.model_config)
        trainer = Trainer(
            model,
            self.model_config,
            self.training_config,
            self.trainer_config,
            steps_per_epoch=pipelines["train"].steps_per_epoch(),
            output_dir=self.output_dir / f"fold_{fold}",
            teacher_fn=self._teacher(),
            distillation_config=self.distillation_config,
            device=self.device,
        )
        fit = trainer.fit(pipelines["train"], pipelines["val"],
                          extra_ckpt_metadata={"fold": fold})
        test_metrics = trainer.test(pipelines["test"],
                                    checkpoint=fit.best_checkpoint)
        result: Dict[str, Any] = {"fold": fold, **test_metrics}
        # val_* metrics of the best epoch, the one whose checkpoint the
        # test metrics describe
        result.update({k: v for k, v in self._best_epoch_row(fit).items()
                       if k.startswith("val_")})
        result["best_val_metric"] = fit.best_metric
        result["epochs_trained"] = fit.stopped_epoch + 1
        result["train_time_s"] = time.time() - t0
        if fit.best_checkpoint is not None:
            result["best_checkpoint"] = str(fit.best_checkpoint)
        return result

    def _best_epoch_row(self, fit) -> Dict[str, Any]:
        """History row of the monitored-best epoch (else the last)."""
        if not fit.history:
            return {}
        monitor = str(cfg_get(self.training_config, "monitor_metric", "val_acc"))
        mode = str(cfg_get(self.training_config, "monitor_mode", "max"))
        rows = [r for r in fit.history if monitor in r]
        if not rows:
            return fit.history[-1]
        pick = max if mode == "max" else min
        return pick(rows, key=lambda r: r[monitor])

    def run_stacked(self, folds) -> None:
        """Every fold at once (training/stacked.py); one row a fold, its
        wall time the sweep's share."""
        from ..training.stacked import StackedKFoldTrainer

        t0 = time.time()
        pipes = [self._build_pipelines(f) for f in folds]
        st = StackedKFoldTrainer(
            self.model_config, self.training_config, self.trainer_config,
            [p["train"] for p in pipes], [p["val"] for p in pipes],
            [p["test"] for p in pipes],
            output_dir=self.output_dir / "stacked",
            teacher_fn=self._teacher(),
            distillation_config=self.distillation_config,
            device=self.device,
        )
        results = st.fit()
        wall = time.time() - t0
        for f, r in zip(folds, results):
            row = {"fold": f, **{k: v for k, v in r.items() if k != "history"}}
            row["train_time_s"] = wall / max(1, len(folds))
            self.fold_results.append(row)

    def run(self) -> Dict[str, Any]:
        folds = list(range(1, self.num_folds + 1))
        if self.num_slices > 1:
            folds = partition_folds(self.num_folds, self.num_slices,
                                    self.slice_index)
            logger.info("slice %d/%d runs folds %s", self.slice_index,
                        self.num_slices, folds)
        if cfg_get(self.kfold_config, "stacked", False):
            from ..training.stacked import StackedShapeError

            try:
                self.run_stacked(folds)
                self.aggregate_results()
                return self.aggregated_results
            except StackedShapeError as e:
                logger.warning("stacked k-fold unavailable (%s); falling "
                               "back to the sequential sweep", e)
        for fold in folds:
            logger.info("===== fold %d/%d =====", fold, self.num_folds)
            try:
                self.fold_results.append(self.run_fold(fold))
            except Exception as e:  # the sweep goes on
                logger.exception("fold %d failed", fold)
                self.fold_results.append({"error": str(e), "fold": fold})
        self.aggregate_results()
        return self.aggregated_results

    # ------------------------------------------------------------------
    def aggregate_results(self) -> None:
        valid = [r for r in self.fold_results if "error" not in r]
        if not valid:
            self.aggregated_results = {"status": "All folds failed or no metrics",
                                       "raw_fold_results": self.fold_results}
            return
        aggregated: Dict[str, Any] = {}
        # the union of the folds' keys: a metric only some folds have
        # still gets its average
        keys: list = []
        for r in valid:
            for key in r:
                if key not in keys:
                    keys.append(key)
        for key in keys:
            values = [r[key] for r in valid
                      if isinstance(r.get(key), (int, float))
                      and np.isfinite(r.get(key))]
            if values:
                aggregated[f"avg_{key}"] = float(np.mean(values))
                aggregated[f"std_{key}"] = float(np.std(values))
        aggregated["num_successful_folds"] = len(valid)
        aggregated["total_folds"] = self.num_folds
        aggregated["raw_fold_results"] = self.fold_results
        self.aggregated_results = aggregated

    def log_results(self) -> None:
        name = cfg_get(self.config, "name",
                       cfg_get(self.model_config, "name", "experiment"))
        prefix = cfg_get(self.kfold_config, "experiment_name_prefix", name)
        self.aggregated_results["experiment_name"] = str(name)
        self.aggregated_results["model_name"] = str(prefix)
        if self._distilling():
            res = self.aggregated_results
            res["family"] = "distilled_vit"
            res["student_model_name"] = str(cfg_get(self.model_config, "name",
                                                    "unknown_student"))
            res["teacher_model_name"] = str(cfg_get(
                self.distillation_config, "teacher_model_name",
                cfg_get(cfg_get(self.distillation_config, "teacher_model", {})
                        or {}, "name", "unknown_teacher")))
            try:
                res["student_param_count"] = num_parameters(
                    ModelRegistry.create_model(self.model_config))
            except Exception:
                res["student_param_count"] = "N/A"
        suffix = f"_slice{self.slice_index}" if self.num_slices > 1 else ""
        if suffix:
            self.aggregated_results["slice_index"] = self.slice_index
            self.aggregated_results["num_slices"] = self.num_slices
        if not is_lead_process():
            return
        path = self.output_dir / f"kfold_summary_{prefix}{suffix}.json"
        with open(path, "w") as f:
            json.dump(self.aggregated_results, f, indent=4, default=str)
        logger.info("k-fold summary written to %s", path)
