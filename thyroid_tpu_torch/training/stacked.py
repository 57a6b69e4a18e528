"""Fold-stacked k-fold training (counterpart of
thyroid_tpu/training/stacked.py): k folds of one model config trained
together, one epoch of every fold per outer epoch.

The JAX package vmaps one epoch program over a fold axis. The port keeps
the semantics and not the mechanism (torch.func.vmap batches neither the
hand-written kernels' autograd Functions nor BatchNorm's in-place running
statistics): it holds k fold states on the device, one Trainer a fold,
each built and seeded as a sequential fold's Trainer is (parameters,
optimizer moments, EMA, BatchNorm statistics, generators), and steps them
in lockstep, step i of every fold before step i + 1 of any. Where JAX
gives every fold the same epoch key, the port's folds share the seed, so
fold f takes exactly the steps a sequential Trainer takes on fold f.

Semantics kept from the JAX package:
- every fold runs the same epochs; early stopping acts on the mean
  monitored metric over the folds (no `min_epochs`);
- each fold keeps its own best epoch: its parameters, EMA, statistics and
  step are snapshotted on the device for the folds that improved, and the
  test pass and the checkpoint export run on those per-fold-best states;
- with EMA on, evaluation and export use the shadow weights;
- equal split shapes across folds (StackedShapeError otherwise, and the
  k-fold experiment falls back to its sequential sweep).
One difference: JAX's stacked program always runs whole epochs, while the
port's folds honour `limit_{train,val,test}_batches` and `max_steps` as a
sequential Trainer does.

On a mesh (`mesh=`, or the trainer config's `mesh_shape`: a process mesh)
with a `slice_axis`, the folds go to the slices in contiguous blocks
(parallel/multislice.py fold_block: 6 folds on 2 slices, 0-2 and 3-5, as
JAX's P(slice) blocks them); each rank holds its slice's folds' Trainers,
each data-parallel over the rest of the mesh through this rank (its
slice's data line). Once an epoch every rank's val metrics are gathered
(the host read JAX makes of the stacked metrics) so that the mean over
all folds stops every slice alike; no training collective crosses a
slice. fit returns every fold's row, in fold order, on every rank; each
slice's first rank writes its folds' checkpoints. Without a slice axis
every fold trains on the whole mesh.
"""
from __future__ import annotations

import time
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.registry import ModelRegistry, cfg_get
from ..ops.platform import DeviceLike, resolve_device
from ..parallel.collectives import all_gather_objects
from ..parallel.mesh import Mesh, create_mesh, default_backend
from ..parallel.multislice import fold_block
from ..utils.logging import get_logger
from .checkpoint import save_checkpoint
from .engine import Trainer

logger = get_logger(__name__)

# the state a fold's best epoch keeps for the test pass and the export
SNAPSHOT = ("params", "ema_params", "batch_stats")


class StackedShapeError(ValueError):
    """Fold splits have unequal shapes: stacking impossible."""


def _geometry(pipes) -> set:
    return {(tuple(p.cache.shape), tuple(p.labels.shape)) for p in pipes}


class StackedKFoldTrainer:
    """Train k folds of one model config together; `train_pipelines`,
    `val_pipelines` and `test_pipelines` hold one DevicePipeline a fold,
    of equal shapes. Every loss mode works, a teacher shared by the
    folds."""

    def __init__(self, model_config: Any, training_config: Any,
                 trainer_config: Any, train_pipelines: List[Any],
                 val_pipelines: List[Any],
                 test_pipelines: Optional[List[Any]] = None,
                 output_dir: str | Path = "outputs",
                 teacher_fn: Optional[Callable] = None,
                 distillation_config: Any = None, mesh: Any = None,
                 device: DeviceLike = None, slice_axis: str = "slice"):
        self.k = len(train_pipelines)
        if self.k < 1:
            raise ValueError("need at least one fold")
        for pipes in (train_pipelines, val_pipelines, test_pipelines or []):
            shapes = _geometry(pipes)
            if len(shapes) > 1:
                raise StackedShapeError(
                    f"fold shapes differ: {sorted(map(str, shapes))}; the "
                    "stacked k-fold needs k | corpus size: use the "
                    "sequential path")
        self.model_config = model_config
        self.training_config = training_config
        self.trainer_config = trainer_config
        self.teacher_fn = teacher_fn
        self.distillation_config = distillation_config
        self.device = resolve_device(device)
        self._init_mesh(mesh, slice_axis)
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.train_pipelines = train_pipelines
        self.val_pipelines = val_pipelines
        self.test_pipelines = test_pipelines
        self._init_folds()

    def _init_mesh(self, mesh: Any, slice_axis: str) -> None:
        """This rank's folds (`self.folds`, 0-based) and the mesh their
        Trainers train on."""
        shape = cfg_get(self.trainer_config, "mesh_shape", None)
        if mesh is None and shape:
            mesh = create_mesh({str(a): int(n) for a, n in dict(shape).items()},
                               backend=default_backend(self.device))
        if mesh is not None and (not isinstance(mesh, Mesh)
                                 or not mesh.is_process_mesh):
            raise TypeError("StackedKFoldTrainer(mesh=) takes a process mesh "
                            f"(parallel.create_mesh(shape)), got {mesh!r}")
        self.mesh, self.fold_mesh = mesh, None
        self.folds = list(range(self.k))
        self.is_lead = True
        if mesh is None:
            return
        rest = [a for a in mesh.axis_names if a != slice_axis]
        if slice_axis in mesh.shape:
            self.folds = fold_block(self.k, mesh.shape[slice_axis],
                                    mesh.index(slice_axis))
            if not self.folds:
                raise ValueError(f"{self.k} folds leave slice "
                                 f"{mesh.index(slice_axis)} of "
                                 f"{mesh.shape[slice_axis]} without a fold")
        self.fold_mesh = mesh.submesh(rest) if rest else None
        self.is_lead = self.fold_mesh is None or self.fold_mesh.is_lead()

    def _init_folds(self) -> None:
        """One Trainer for each of this rank's folds, each as a sequential
        fold's (same seed), on the fold mesh (the mesh the Trainers take
        explicitly, never the config's mesh_shape)."""
        tcfg = self.trainer_config
        if cfg_get(tcfg, "mesh_shape", None):
            tcfg = dict(tcfg.to_dict() if hasattr(tcfg, "to_dict") else tcfg)
            tcfg["mesh_shape"] = None
        self.trainers = [
            Trainer(ModelRegistry.create_model(self.model_config),
                    self.model_config, self.training_config, tcfg,
                    steps_per_epoch=self.train_pipelines[0].steps_per_epoch(),
                    output_dir=self.output_dir, teacher_fn=self.teacher_fn,
                    distillation_config=self.distillation_config,
                    mesh=self.fold_mesh, device=self.device)
            for _ in self.folds]
        self.cfg = self.trainers[0].cfg
        self.use_ema = self.trainers[0].state.ema_params is not None

    # ------------------------------------------------------------------
    def _mine(self, pipelines: List[Any]) -> List[Any]:
        return [pipelines[f] for f in self.folds]

    def _every_fold(self, mine: List[Any]) -> List[Any]:
        """Per-fold values of this rank's folds → every fold's, in fold
        order (gathered over the mesh)."""
        if self.mesh is None:
            return mine
        merged: Dict[int, Any] = {}
        for part in all_gather_objects(dict(zip(self.folds, mine)),
                                       self.mesh.group(self.mesh.axis_names)):
            merged.update(part)
        return [merged[f] for f in range(self.k)]

    def train_epoch(self, epoch: int) -> List[Dict[str, float]]:
        """One epoch of this rank's folds, in lockstep → each fold's
        train_*."""
        runs = [t.train_steps(p, epoch)
                for t, p in zip(self.trainers, self._mine(self.train_pipelines))]
        last = None
        for last in zip(*runs):
            pass
        return list(last)

    def eval_epoch(self, pipelines: List[Any], prefix: str = "val_",
                   limit_fraction: Optional[float] = None
                   ) -> List[Dict[str, float]]:
        """Each of this rank's folds' state on its pipeline (the EMA
        weights where EMA is on)."""
        return [t.eval_epoch(p, prefix, use_ema=self.use_ema,
                             limit_fraction=limit_fraction)
                for t, p in zip(self.trainers, self._mine(pipelines))]

    # ------------------------------------------------------------------
    def reset(self, train_pipelines: List[Any], val_pipelines: List[Any],
              test_pipelines: Optional[List[Any]] = None) -> None:
        """Swap in new fold data of the same geometry and restart every
        fold from the initial state; other shapes raise
        StackedShapeError."""
        want = _geometry(self.train_pipelines[:1])
        got = _geometry(train_pipelines)
        if want != got or len(train_pipelines) != self.k:
            raise StackedShapeError(
                f"reset needs identical fold geometry: had {want} x{self.k}, "
                f"got {got} x{len(train_pipelines)}")
        self.train_pipelines = train_pipelines
        self.val_pipelines = val_pipelines
        self.test_pipelines = test_pipelines
        self._init_folds()

    # ------------------------------------------------------------------
    def export_fold_checkpoints(self, root: str | Path, model_name: str,
                                model_config: Any = None,
                                extra_metadata: Optional[Dict[str, Any]] = None
                                ) -> List[Path]:
        """Each fold's (post-fit best) state as a checkpoint in the
        sequential layout `{root}/{name}/fold_{f}/checkpoints/{name}-best.ckpt`,
        the EMA weights where EMA is on (what the evaluation scored); on a
        mesh each slice's first rank writes its folds' and every rank
        returns every fold's path."""
        root = Path(root)
        paths = [root / model_name / f"fold_{f + 1}" / "checkpoints"
                 / f"{model_name}-best.ckpt" for f in range(self.k)]
        for f, t in zip(self.folds, self.trainers):
            if not self.is_lead:
                break
            st = t.state
            state = SimpleNamespace(
                params=st.ema_params if st.ema_params is not None else st.params,
                batch_stats=st.batch_stats, step=st.step, layout=st.layout)
            meta = {"model_name": model_name, "fold": f + 1,
                    "stacked_export": True}
            if model_config is not None:
                meta["model_config"] = model_config.to_dict() \
                    if hasattr(model_config, "to_dict") else dict(model_config)
            if extra_metadata:
                meta.update(extra_metadata)
            paths[f].parent.mkdir(parents=True, exist_ok=True)
            save_checkpoint(paths[f], state, metadata=meta)
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group(self.mesh.axis_names))
        return paths

    # ------------------------------------------------------------------
    def _snapshot(self, f: int) -> Dict[str, Any]:
        st = self.trainers[self.folds.index(f)].state
        snap: Dict[str, Any] = {"step": st.step}
        for key in SNAPSHOT:
            named = getattr(st, key)
            snap[key] = None if named is None else \
                {n: t.detach().clone() for n, t in named.items()}
        return snap

    @torch.no_grad()
    def _restore(self, f: int, snap: Dict[str, Any]) -> None:
        st = self.trainers[self.folds.index(f)].state
        for key in SNAPSHOT:
            if snap[key] is not None:
                named = getattr(st, key)
                for n, t in snap[key].items():
                    named[n].copy_(t)
        st.step = snap["step"]

    def fit(self) -> List[Dict[str, Any]]:
        """Run the stacked sweep → one row a fold: the best epoch's val_*
        metrics, test_* of the per-fold-best state, best_val_metric,
        best_epoch, epochs_trained, stacked and the history."""
        monitor = self.cfg.monitor_metric
        mode = self.cfg.monitor_mode
        patience = self.cfg.early_stopping_patience
        sign = 1.0 if mode == "max" else -1.0
        best_vec = np.full((self.k,), -np.inf)
        best_epoch_vec = np.full((self.k,), -1, dtype=int)
        snaps: Dict[int, Optional[Dict[str, Any]]] = {f: None for f in self.folds}
        best_mean = None
        bad = 0
        history: List[List[Dict[str, float]]] = []
        for epoch in range(self.trainers[0].epochs):
            t0 = time.time()
            fold_metrics = self.train_epoch(epoch)
            val_metrics = self.eval_epoch(self.val_pipelines, "val_")
            for fm, vm in zip(fold_metrics, val_metrics):
                fm.update(vm)
                fm["epoch"] = epoch
                fm["time_s"] = time.time() - t0
            fold_metrics = self._every_fold(fold_metrics)
            history.append(fold_metrics)
            raw_vals = np.array(
                [np.nan if m.get(monitor) is None else float(m[monitor])
                 for m in fold_metrics])
            vals = raw_vals[np.isfinite(raw_vals)]
            mean_v = float(np.mean(vals)) if vals.size else None
            logger.info("stacked epoch %d: mean %s=%s", epoch, monitor,
                        None if mean_v is None else round(mean_v, 4))
            # each fold's own improvement (NaN compares false)
            with np.errstate(invalid="ignore"):
                fold_improved = sign * raw_vals > best_vec
            best_vec = np.where(fold_improved, sign * raw_vals, best_vec)
            best_epoch_vec = np.where(fold_improved, epoch, best_epoch_vec)
            for f in np.flatnonzero(fold_improved):
                if int(f) in snaps:
                    snaps[int(f)] = self._snapshot(int(f))
            # early stopping on the mean monitored metric
            mean_improved = mean_v is not None and (
                best_mean is None or
                (mean_v > best_mean if mode == "max" else mean_v < best_mean))
            if mean_improved:
                best_mean, bad = mean_v, 0
            else:
                bad += 1
            if patience and bad >= patience:
                logger.info("stacked early stop at epoch %d", epoch)
                break
        for f, snap in snaps.items():
            if snap is not None:
                self._restore(f, snap)

        test_metrics = None
        if self.test_pipelines:
            test_metrics = self._every_fold(self.eval_epoch(
                self.test_pipelines, "test_",
                limit_fraction=self.cfg.limit_test_batches))
        last = history[-1] if history else [{} for _ in range(self.k)]
        results: List[Dict[str, Any]] = []
        for f in range(self.k):
            be = int(best_epoch_vec[f])
            best_row_f = history[be][f] if 0 <= be < len(history) else last[f]
            r: Dict[str, Any] = {k: v for k, v in best_row_f.items()
                                 if k.startswith("val_")}
            if test_metrics is not None:
                r.update(test_metrics[f])
            r["best_val_metric"] = best_row_f.get(monitor)
            r["best_epoch"] = be
            r["epochs_trained"] = len(history)
            r["stacked"] = True
            r["history"] = [row[f] for row in history]
            results.append(r)
        return results
