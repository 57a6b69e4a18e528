"""Training engine (counterpart of thyroid_tpu/training/engine.py), loss
modes "ce", "deit" and "distillation".

`Trainer(model, model_config, training_config, trainer_config,
steps_per_epoch).fit(train_pipeline, val_pipeline)` then
`Trainer.test(pipeline, checkpoint=best)`, as `scripts/train.py` drives the
JAX engine. A train step is: forward with `train=True` (DropPath and
dropout draw from the trainer's generator on the device; BatchNorm
normalises with the batch's statistics and updates its running ones in
place, the state JAX installs with the step), the loss, backward (the Swin
attention through its backward kernel), clip, the optimizer (AdamW or SGD)
with the schedule and layer decay, every `accumulate_grad_batches`
mini-steps, EMA of the parameters, and a metric update that stays on the
device. Evaluation runs the `train=False` (serving) forward under
`torch.no_grad` with the parameters (or their EMA) and the running
statistics; every model's eval forward gives one logits tensor (DeiT the
mean of its heads, Inception without its auxiliary head), so the JAX eval
step's `outputs[0]` of a tuple has no counterpart.

The loss, as JAX's `_train_step_impl` takes it, with `ce` the
cross-entropy with label smoothing and sample weights:
- a plain output: ce(logits);
- loss mode "deit" (a config named deit_*) with DeiT's training tuple
  (cls, dist): 0.5·ce(cls) + 0.5·ce(dist), the metrics on (cls + dist) / 2;
- any other tuple (Inception v3's auxiliary head): ce(main) + 0.4·ce(aux),
  the metrics on main;
- loss mode "distillation" (a `teacher_fn` given): the frozen teacher's
  logits of the step's images, computed before the student's forward,
  and losses.distillation_loss with α of the epoch (`progressive_alpha`
  where the distillation node sets `progressive`, else its `alpha`) and
  its temperature and type; the metrics on the class head (a DeiT
  student's first output), and the metric state also sums class_loss,
  distillation_loss and teacher_agreement.
With `mixup_alpha` or `cutmix_alpha` above 0 the batch is mixed first
(ops/augment.py mixup_cutmix, gated by `mixup_prob`; never under
distillation: in `fit` by the pipeline, `epoch(mix=)`, in a direct
`train_step` call by the step) and `ce` is λ·CE(y_a) + (1 − λ)·CE(y_b); the metrics stay
on the original labels.

Differences from the JAX engine: the per-step loop is the only loop
(`scan_epoch` is accepted; the JAX package documents its epoch scan as
equal to this loop); the epoch permutation, DropPath and dropout, the
batch augmentation and MixUp/CutMix draw from `torch.Generator`s seeded
with `TrainerConfig.seed`, so their random streams are not JAX's; the
initial weights come from the port's own initialisers unless `variables`
(or `params`) carries a JAX tree in. The two TrainerConfig fields the JAX
engine never reads (`log_every_n_steps`, `deterministic`) are left out.

On a mesh (`mesh=`, or `mesh_shape` in the trainer config: a process
mesh, parallel/mesh.py, one process a device, launched by torchrun) the
Trainer trains data-parallel over `data_axis`, as JAX's jitted step does
over its sharded batch: each rank takes its rows of every global batch
(DevicePipeline.epoch with the Trainer's `batch_sharding`); every rank
draws what one process draws for the global batch (the epoch order, the
augmentation, MixUp/CutMix on the global batch (the pipeline's
`epoch(mix=)`), the dropout and DropPath masks through a `RowShard`) and
keeps its rows; BatchNorm takes
the global batch's statistics (layers.BatchNorm `group`); each rank's
loss is its share of the global batch's mean (its weight sum over the
global one), so the gradients summed over the data axis (the
optimizer's `sync`, at the accumulation boundary under MultiSteps) are
the global batch's; the metric sums are summed over the data axis and
the scores gathered, so early stopping and the top-k checkpoints decide
alike on every rank. A `model_axis` of size > 1 adds FSDP over it
(parallel/collectives.py GradSync): the optimizer state and the update
of each ≥2-D parameter are split on the dim JAX's `fsdp_param_sharding`
picks, the batch is replicated over it. Only the optimizer state is
sharded (ZeRO-1): the parameters and gradients stay whole on every rank,
where JAX's mesh shards the parameters too. The mesh's first rank writes the
logs, history and checkpoints (whole: the moments gathered), the others
wait for it; a checkpoint of either kind resumes on either.

Attention-map logging (`log_attention_every_n_epochs` > 0) draws, every
that many epochs, the first 4 validation images over the class-token
heatmap of the last captured attention map (`attention_maps` computes
them on the device, `_log_attention_maps` draws on the host). JAX wraps
it in `except Exception` and logs failures at debug level; here a model
whose last map is not one per image (Swin's windows, a CNN's none) is
skipped by JAX's shape rule and any other failure raises, and a Trainer
asked to log raises at construction when matplotlib cannot be imported.
"""
from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from ..models import cnn, ensemble, vit  # noqa: F401  (register the model families)
from ..models.from_jax import jax_layout, load_jax_variables
from ..models.import_torch import maybe_load_pretrained
from ..models.layers import BatchNorm, RowShard
from ..models.registry import ModelRegistry, cfg_get
from ..ops.augment import apply_mixup_cutmix, draw_mixup_cutmix
from ..ops.platform import DeviceLike, resolve_device
from ..parallel.collectives import GradSync, all_reduce_, gather_rows
from ..parallel.mesh import Mesh, batch_sharding, create_mesh, default_backend
from ..utils.observe import MetricLogger, StepTimer
from .checkpoint import (BestCheckpointManager, load_checkpoint, load_payload,
                         save_checkpoint, variables_of)
from .configs import VIT_OPTIMIZER_PARAMS
from .losses import (classification_outputs_to_logits, cross_entropy,
                     distillation_loss, mixed_cross_entropy,
                     progressive_alpha)
from .metrics import (finalize_metric_state, update_metric_state,
                      zero_metric_state)
from .schedules import build_optimizer, build_schedule
from .train_state import TrainState

logger = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    max_epochs: int = 100
    min_epochs: int = 1
    max_steps: int = -1
    precision: str = "bf16"
    gradient_clip_val: Optional[float] = 1.0
    gradient_clip_algorithm: str = "norm"
    accumulate_grad_batches: int = 1
    scan_epoch: bool = True     # accepted; the port always runs the step loop
    check_val_every_n_epoch: int = 1
    limit_train_batches: float = 1.0
    limit_val_batches: float = 1.0
    limit_test_batches: float = 1.0
    enable_checkpointing: bool = True
    mesh_shape: Optional[Dict[str, int]] = None
    data_axis: str = "data"
    model_axis: Optional[str] = None    # set for FSDP over that mesh axis
    monitor_metric: str = "val_acc"
    monitor_mode: str = "max"
    early_stopping_patience: Optional[int] = 10
    log_attention_every_n_epochs: int = 0
    save_top_k: int = 3
    save_last: bool = True
    seed: int = 42

    @classmethod
    def from_config(cls, trainer_cfg: Any, training_cfg: Any) -> "TrainerConfig":
        kw = {}
        for f_ in cls.__dataclass_fields__:
            v = cfg_get(trainer_cfg, f_, None)
            if v is None:
                v = cfg_get(training_cfg, f_, None)
            if v is not None:
                kw[f_] = v
        if kw.get("mesh_shape"):
            kw["mesh_shape"] = {str(k): int(v) for k, v in dict(kw["mesh_shape"]).items()}
        return cls(**kw)


@dataclass
class FitResult:
    best_metric: Optional[float]
    best_checkpoint: Optional[Path]
    history: List[Dict[str, float]] = field(default_factory=list)
    stopped_epoch: int = 0


def _limit_batches(limit, full: int) -> int:
    """Lightning `limit_{train,val,test}_batches` semantics: an int is a
    batch count (0 disables), a float a fraction of the epoch."""
    if isinstance(limit, bool) or limit is None:
        return full
    if isinstance(limit, int):
        return min(full, max(0, limit))
    if float(limit) < 1.0:
        return max(1, int(full * float(limit)))
    return full


class Trainer:
    """Builds the optimizer and state from the configs and runs
    fit/validate/test on `device` (the card unless the CPU is asked for).
    `variables`, a JAX variable tree ({"params", "batch_stats"}), or
    `params`, a bare parameter tree for a model without BatchNorm,
    replaces the seeded initial weights; without either, the model
    config's `pretrained` / `pretrained_path` warm-start them from a local
    torch checkpoint (models.import_torch.maybe_load_pretrained), as the
    JAX Trainer's create_and_init does."""

    def __init__(self, model: torch.nn.Module, model_config: Any,
                 training_config: Any, trainer_config: Any = None,
                 steps_per_epoch: int = 10, output_dir: str | Path = "outputs",
                 teacher_fn: Optional[Callable] = None,
                 distillation_config: Any = None,
                 loss_mode: Optional[str] = None, mesh: Any = None,
                 params: Optional[Mapping[str, Any]] = None,
                 device: DeviceLike = None,
                 variables: Optional[Mapping[str, Any]] = None):
        if params is not None and variables is not None:
            raise ValueError("pass params or variables, not both")
        self.device = resolve_device(device)
        self.model_config = model_config
        self.training_config = training_config
        self.cfg = TrainerConfig.from_config(trainer_config, training_config)
        if self.cfg.log_attention_every_n_epochs:
            try:
                import matplotlib  # noqa: F401
            except ImportError as e:
                raise ImportError("log_attention_every_n_epochs needs "
                                  "matplotlib to draw the maps") from e
        # trainer.precision drives the compute dtype: rebuild the model in
        # bf16 unless the model config pins a dtype (params stay float32)
        if self.cfg.precision == "bf16" and cfg_get(model_config, "dtype", None) is None:
            mc = model_config.to_dict() if hasattr(model_config, "to_dict") \
                else dict(model_config)
            mc["dtype"] = "bf16"
            model = ModelRegistry.create_model(mc)
            self.model_config = mc
        self.model = model
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)

        self.teacher_fn = teacher_fn
        self.distillation_config = distillation_config
        if loss_mode is None:
            name = str(cfg_get(model_config, "name", ""))
            if teacher_fn is not None:
                loss_mode = "distillation"
            else:
                loss_mode = "deit" if name.startswith("deit") else "ce"
        if loss_mode == "distillation" and teacher_fn is None:
            raise ValueError('loss_mode="distillation" needs a teacher_fn')
        self.loss_mode = loss_mode
        self._aux_keys = (
            ("class_loss", "distillation_loss", "teacher_agreement")
            if loss_mode == "distillation" else ())
        self.label_smoothing = float(
            cfg_get(training_config, "label_smoothing",
                    cfg_get(cfg_get(training_config, "loss", {}) or {},
                            "label_smoothing", 0.0)) or 0.0)
        self.mixup_alpha = float(cfg_get(training_config, "mixup_alpha", 0.0) or 0.0)
        self.cutmix_alpha = float(cfg_get(training_config, "cutmix_alpha", 0.0) or 0.0)
        self.mixup_prob = float(cfg_get(training_config, "mixup_prob", 1.0) or 1.0)
        opt = cfg_get(training_config, "optimizer_params", {}) or {}
        if not opt and str(cfg_get(self.model_config, "architecture", "")) == "vit":
            opt = dict(VIT_OPTIMIZER_PARAMS)
        sched = cfg_get(training_config, "scheduler_params", {}) or {}
        epochs = int(cfg_get(training_config, "epochs", self.cfg.max_epochs))
        self.epochs = min(epochs, self.cfg.max_epochs)
        self.schedule = build_schedule(
            base_lr=float(cfg_get(opt, "lr", 1e-4)),
            steps_per_epoch=steps_per_epoch,
            epochs=self.epochs,
            warmup_epochs=int(cfg_get(sched, "warmup_epochs", 0) or 0),
            warmup_steps=int(cfg_get(sched, "warmup_steps", 0) or 0),
            eta_min=float(cfg_get(sched, "eta_min", 0.0) or 0.0),
            kind=cfg_get(sched, "name", "cosine"),
            step_size=cfg_get(sched, "step_size", None),
            gamma=cfg_get(sched, "gamma", None),
        )

        # weights drawn on the CPU, so a seed gives the same model anywhere;
        # weights carried in, or else the config's warm start, replace
        # them before the optimizer, EMA and layer-decay state are built
        self.model.to("cpu")
        self.model.init_weights(torch.Generator().manual_seed(self.cfg.seed))
        if params is not None:
            variables = {"params": params}
        if variables is not None:
            load_jax_variables(self.model, variables)
        else:
            maybe_load_pretrained(self.model_config, self.model)
        self.model.to(self.device)
        self._init_mesh(mesh)
        depth = int(cfg_get(model_config, "depth", 0) or 0) or \
            len(tuple(cfg_get(model_config, "depths", ()) or ())) or 12
        tx = build_optimizer(
            dict(self.model.named_parameters()), self.schedule,
            weight_decay=float(cfg_get(opt, "weight_decay", 1e-5)),
            beta1=float(cfg_get(opt, "beta1", 0.9)),
            beta2=float(cfg_get(opt, "beta2", 0.999)),
            eps=float(cfg_get(opt, "eps", 1e-8)),
            gradient_clip_val=self.cfg.gradient_clip_val,
            gradient_clip_algorithm=self.cfg.gradient_clip_algorithm,
            layer_decay=cfg_get(training_config, "layer_decay", None),
            num_layers=depth,
            accumulate_steps=self.cfg.accumulate_grad_batches,
            name=str(cfg_get(opt, "name", "adamw")),
        )
        tx.sync = self.sync
        ema_decay = cfg_get(training_config, "ema_decay", None)
        self.ema_decay = float(ema_decay) if ema_decay else None
        self.state = TrainState(self.model, tx, ema=self.ema_decay is not None)
        # the epoch permutations (CPU); the DropPath and dropout draws, and
        # the batch augmentation and MixUp/CutMix draws (device)
        self.perm_generator = torch.Generator().manual_seed(self.cfg.seed)
        self.dropout_generator = torch.Generator(device=self.device) \
            .manual_seed(self.cfg.seed)
        self.aug_generator = torch.Generator(device=self.device) \
            .manual_seed(self.cfg.seed)
        self._dropout_draws = self.dropout_generator if self.mesh is None \
            else RowShard(self.dropout_generator, self.batch_sharding.index,
                          self.batch_sharding.count)
        self._global_step = 0

    def _init_mesh(self, mesh: Any) -> None:
        """Data-parallel (and FSDP) state on `mesh`, else the config's
        `mesh_shape` (create_mesh over the torch.distributed world)."""
        self.mesh = self.sync = self.batch_sharding = None
        self.is_lead = True
        if mesh is None and self.cfg.mesh_shape:
            mesh = create_mesh(self.cfg.mesh_shape,
                               backend=default_backend(self.device))
        if mesh is None:
            return
        if not isinstance(mesh, Mesh) or not mesh.is_process_mesh:
            raise TypeError("Trainer(mesh=) takes a process mesh "
                            f"(parallel.create_mesh(shape)), got {mesh!r}")
        self.mesh = mesh
        self.batch_sharding = batch_sharding(mesh, self.cfg.data_axis)
        self.data_group = mesh.group((self.cfg.data_axis,))
        self.is_lead = mesh.is_lead()
        self.sync = GradSync(mesh, self.cfg.data_axis, self.cfg.model_axis,
                             dict(self.model.named_parameters()),
                             jax_layout(self.model))
        if self.batch_sharding.count > 1:
            for m in self.model.modules():
                if isinstance(m, BatchNorm):
                    m.group, m.group_size = self.data_group, \
                        self.batch_sharding.count

    def _global(self, x: torch.Tensor) -> torch.Tensor:
        """The global batch from every rank's rows."""
        sh = self.batch_sharding
        return gather_rows(x, self.data_group, sh.index, sh.count)

    def _loss_share(self, weights: Optional[torch.Tensor], n: int) -> torch.Tensor:
        """This rank's share of the global batch's weight (1 / the data
        axis size for equal unweighted shards)."""
        local = weights.float().sum() if weights is not None else \
            torch.tensor(float(n), device=self.device)
        total = local.clone()
        dist.all_reduce(total, group=self.data_group)
        return local / torch.clamp(total, min=1e-6)

    def _barrier(self) -> None:
        if self.mesh is not None:
            dist.barrier(group=self.mesh.group(self.mesh.axis_names))

    # ------------------------------------------------------------------
    def loss_and_grads(self, images: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor],
                       labels_b: Optional[torch.Tensor] = None,
                       lam: Optional[torch.Tensor] = None,
                       teacher_logits: Optional[torch.Tensor] = None,
                       alpha=None):
        """One training forward and backward → (loss, metric logits, {name:
        grad}, {aux name: scalar}); the forward updates the BatchNorm
        statistics in place. With `labels_b` and `lam` (a mixed batch) `ce`
        is the mixed CE; in loss mode "distillation" the loss is
        distillation_loss against `teacher_logits` at `alpha` and the aux
        dict holds its three terms (else it is empty)."""
        outputs = self.model(images, train=True,
                             generator=self._dropout_draws)

        def ce(lgts):
            if labels_b is None:
                return cross_entropy(lgts, labels, self.label_smoothing, weights)
            return mixed_cross_entropy(lgts, labels, labels_b, lam,
                                       self.label_smoothing, weights)

        aux: Dict[str, torch.Tensor] = {}
        if self.loss_mode == "distillation":
            dcfg = self.distillation_config or {}
            loss, aux = distillation_loss(
                outputs, teacher_logits, labels, alpha=alpha,
                temperature=float(cfg_get(dcfg, "temperature", 4.0)),
                distillation_type=str(cfg_get(dcfg, "distillation_type", "soft")),
                label_smoothing=self.label_smoothing, weights=weights)
            aux = {k: v.detach() for k, v in aux.items()}
            logits = outputs[0] if isinstance(outputs, tuple) else outputs
        elif self.loss_mode == "deit" and isinstance(outputs, tuple):
            loss = 0.5 * ce(outputs[0]) + 0.5 * ce(outputs[1])
            logits = classification_outputs_to_logits(outputs)
        elif isinstance(outputs, tuple):          # Inception's aux head
            main, aux_logits = outputs
            loss = ce(main) + 0.4 * ce(aux_logits)
            logits = main
        else:
            loss, logits = ce(outputs), outputs
        names = list(self.state.params)
        params = [self.state.params[n] for n in names]
        # a parameter outside the loss (Swin's uncertainty head, the ViT
        # patch-quality head) gets a zero gradient, as jax.grad gives it: it
        # still moves Adam's moments and the decoupled weight decay
        scaled = loss if self.mesh is None else \
            loss * self._loss_share(weights, images.shape[0])
        grads = torch.autograd.grad(scaled, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        return loss.detach(), logits.detach(), dict(zip(names, grads)), aux

    def _mixes(self) -> bool:
        return (self.mixup_alpha > 0 or self.cutmix_alpha > 0) \
            and self.loss_mode != "distillation"

    def _mix(self, x: torch.Tensor, y: torch.Tensor):
        """MixUp/CutMix of a batch, drawn from the augmentation stream →
        (mixed images, second labels, λ)."""
        params = draw_mixup_cutmix(self.aug_generator, x.shape,
                                   self.mixup_alpha, self.cutmix_alpha,
                                   self.mixup_prob)
        x, _, labels_b, lam = apply_mixup_cutmix(x, y, params)
        return x, labels_b, lam

    def train_step(self, mstate: Dict[str, torch.Tensor], images: torch.Tensor,
                   labels: torch.Tensor, weights: Optional[torch.Tensor],
                   alpha=None, mixed=None):
        """[MixUp/CutMix,] [the teacher's logits,] forward, loss, backward,
        clip, optimizer, EMA, metric update → (new metric state, P(class
        1) scores); the metrics read the original labels. `alpha` is the
        distillation weight (a float32 scalar tensor, as JAX's step takes
        it; the epoch's by default). `mixed` (second labels, λ) says the
        images are mixed already, as train_steps has the pipeline mix
        them (`epoch(mix=)`); a direct call mixes here, on one process."""
        labels_b = lam = teacher_logits = None
        if mixed is not None:
            labels_b, lam = mixed
        elif self._mixes():
            if self.mesh is not None:
                raise ValueError("on a mesh MixUp/CutMix mixes the global "
                                 "batch: pass the pipeline's (label_b, lam) "
                                 "as `mixed`")
            images, labels_b, lam = self._mix(images, labels)
        if self.loss_mode == "distillation":
            teacher_logits = self.teacher_fn(images)
            if alpha is None:
                alpha = self._alpha_tensor(0)
        loss, logits, grads, aux = self.loss_and_grads(
            images, labels, weights, labels_b, lam, teacher_logits, alpha)
        self.state.apply_gradients(grads, ema_decay=self.ema_decay)
        probs = torch.softmax(logits.float(), dim=-1)
        return update_metric_state(mstate, probs, labels, weights, loss=loss,
                                   aux=aux)

    @torch.no_grad()
    def eval_step(self, variables: Dict[str, torch.Tensor],
                  mstate: Dict[str, torch.Tensor], images: torch.Tensor,
                  labels: torch.Tensor, weights: Optional[torch.Tensor]):
        outputs = functional_call(self.model, variables, (images,),
                                  {"train": False})
        loss = cross_entropy(outputs, labels, self.label_smoothing, weights)
        probs = torch.softmax(outputs.float(), dim=-1)
        return update_metric_state(mstate, probs, labels, weights, loss=loss)

    # ------------------------------------------------------------------
    def _alpha_for_epoch(self, epoch: int) -> float:
        """The distillation weight α of `epoch` (0 outside distillation)."""
        dcfg = self.distillation_config or {}
        if self.loss_mode != "distillation":
            return 0.0
        if cfg_get(dcfg, "progressive", False):
            return progressive_alpha(epoch, cfg_get(dcfg, "alpha_schedule", None),
                                     float(cfg_get(dcfg, "alpha", 0.7)))
        return float(cfg_get(dcfg, "alpha", 0.7))

    def _alpha_tensor(self, epoch: int) -> torch.Tensor:
        return torch.tensor(self._alpha_for_epoch(epoch), dtype=torch.float32,
                            device=self.device)

    def train_epoch(self, pipeline, epoch: int) -> Dict[str, float]:
        """One epoch with no per-step host read: metric state, scores and
        labels stay on the device until finalize_metric_state."""
        *_, metrics = self.train_steps(pipeline, epoch)
        return metrics

    def train_steps(self, pipeline, epoch: int
                    ) -> Iterator[Optional[Dict[str, float]]]:
        """train_epoch a step at a time: yields None after each step, then
        the epoch's metrics (the stacked k-fold trainer steps its folds'
        epochs in lockstep through it)."""
        alpha = self._alpha_tensor(epoch)
        mstate = zero_metric_state(self._aux_keys, device=self.device)
        scores: List = []
        lbls: List = []
        wts: List = []
        max_batches = _limit_batches(self.cfg.limit_train_batches,
                                     pipeline.steps_per_epoch())
        if 0 < self.cfg.max_steps:
            max_batches = min(max_batches,
                              self.cfg.max_steps - self._global_step)
        # the pipeline mixes each global batch (one process's mix, on a
        # mesh before a rank keeps its rows)
        mix = self._mix if self._mixes() else None
        for i, batch in enumerate(pipeline.epoch(self.perm_generator,
                                                 self.aug_generator,
                                                 mix=mix, **self._shard_kw())):
            if i >= max_batches or (0 < self.cfg.max_steps <= self._global_step):
                break
            mixed = None if mix is None else (batch.label_b, batch.lam)
            mstate, score1 = self.train_step(mstate, batch.image, batch.label,
                                             batch.weight, alpha, mixed)
            scores.append(score1)
            lbls.append(batch.label)
            wts.append(batch.weight)
            self._global_step += 1
            yield None
        yield self._finalize(mstate, scores, lbls, wts, "train_")

    def _shard_kw(self) -> Dict[str, Any]:
        return {} if self.mesh is None else {"sharding": self.batch_sharding}

    def _finalize(self, mstate, scores, lbls, wts, prefix: str) -> Dict[str, float]:
        """finalize_metric_state of the global batch: on a mesh the sums
        are summed over the data axis and the scores, labels and weights
        gathered."""
        if self.mesh is not None:
            keys = list(mstate)
            sums = torch.stack([mstate[k].float() for k in keys])
            dist.all_reduce(sums, group=self.data_group)
            mstate = dict(zip(keys, sums.unbind()))
            if scores:
                # one float32 gather (labels are exact in float32)
                rows = torch.stack([torch.cat([t.reshape(-1).float() for t in ts])
                                    for ts in (scores, lbls, wts)], dim=1)
                rows = self._global(rows)
                scores, lbls, wts = [rows[:, 0]], [rows[:, 1].long()], [rows[:, 2]]
        return finalize_metric_state(mstate, scores, lbls, wts, prefix=prefix)

    def eval_epoch(self, pipeline, prefix: str = "val_",
                   use_ema: bool = False,
                   limit_fraction: Optional[float] = None) -> Dict[str, float]:
        mstate = zero_metric_state(device=self.device)
        scores: List = []
        lbls: List = []
        wts: List = []
        variables = self.state.variables(use_ema=use_ema)
        if limit_fraction is None:
            limit_fraction = self.cfg.limit_val_batches
        n_eval = _limit_batches(limit_fraction, pipeline.steps_per_epoch())
        for i, batch in enumerate(pipeline.epoch(**self._shard_kw())):
            if i >= n_eval:
                break
            mstate, score1 = self.eval_step(variables, mstate, batch.image,
                                            batch.label, batch.weight)
            scores.append(score1)
            lbls.append(batch.label)
            wts.append(batch.weight)
        return self._finalize(mstate, scores, lbls, wts, prefix)

    def fit(self, train_pipeline, val_pipeline=None,
            extra_ckpt_metadata: Optional[Dict[str, Any]] = None) -> FitResult:
        model_name = str(cfg_get(self.model_config, "name", "model"))
        ckpt_mgr = None
        if self.cfg.enable_checkpointing:
            ckpt_mgr = BestCheckpointManager(
                self.output_dir / "checkpoints", model_name,
                monitor=self.cfg.monitor_metric, mode=self.cfg.monitor_mode,
                save_top_k=self.cfg.save_top_k, save_last=self.cfg.save_last,
                write=self.is_lead)
        history: List[Dict[str, float]] = []
        metric_logger = MetricLogger(self.output_dir / "logs") \
            if self.is_lead else None
        step_timer = StepTimer()
        patience = self.cfg.early_stopping_patience
        bad_epochs = 0
        best = None
        stopped = 0
        try:
            for epoch in range(self.epochs):
                t0 = time.time()
                metrics = self.train_epoch(train_pipeline, epoch)
                if val_pipeline is not None and \
                        (epoch + 1) % self.cfg.check_val_every_n_epoch == 0:
                    metrics.update(self.eval_epoch(val_pipeline, "val_"))
                n_att = self.cfg.log_attention_every_n_epochs
                if n_att and val_pipeline is not None and self.is_lead \
                        and (epoch + 1) % n_att == 0:
                    self._log_attention_maps(metric_logger, val_pipeline, epoch)
                metrics["epoch"] = epoch
                metrics["lr"] = float(self.schedule(self._global_step))
                metrics["time_s"] = time.time() - t0
                step_timer.tick()
                metrics.update(step_timer.stats())
                if metric_logger is not None:
                    metric_logger.log(metrics, step=epoch)
                history.append(metrics)
                logger.info("epoch %d: %s", epoch,
                            {k: round(v, 4) for k, v in metrics.items()
                             if isinstance(v, float)})
                monitored = metrics.get(self.cfg.monitor_metric)
                if ckpt_mgr is not None and monitored is not None:
                    mc = self.model_config.to_dict() if hasattr(
                        self.model_config, "to_dict") else dict(self.model_config)
                    meta = {"model_config": mc, **(extra_ckpt_metadata or {})}
                    improved = ckpt_mgr.step(self.state, metrics, epoch, meta)
                    self._barrier()
                    if improved:
                        bad_epochs = 0
                        best = monitored
                    else:
                        bad_epochs += 1
                elif monitored is not None:
                    improved = best is None or (
                        monitored > best if self.cfg.monitor_mode == "max"
                        else monitored < best)
                    if improved:
                        best, bad_epochs = monitored, 0
                    else:
                        bad_epochs += 1
                stopped = epoch
                if patience and bad_epochs >= patience and \
                        epoch + 1 >= self.cfg.min_epochs:
                    logger.info("early stopping at epoch %d", epoch)
                    break
                if 0 < self.cfg.max_steps <= self._global_step:
                    break
        finally:
            if metric_logger is not None:
                metric_logger.close()
        if self.is_lead:
            with open(self.output_dir / "history.json", "w") as f:
                json.dump(history, f, indent=2)
        return FitResult(
            best_metric=best if best is not None else (
                ckpt_mgr.best_metric if ckpt_mgr else None),
            best_checkpoint=ckpt_mgr.best_path if ckpt_mgr else None,
            history=history,
            stopped_epoch=stopped,
        )

    def attention_maps(self, val_pipeline):
        """(images (n, S, S, C), labels (n,), class-token heatmaps) of the
        first n ≤ 4 images of the validation pipeline's first batch, from
        the last captured attention map under the current parameters; None
        where that map is not one per image (JAX's skip rule: Swin's
        window maps, a CNN's none)."""
        from ..analysis.attention import (cls_attention_heatmap,
                                          collect_attention_maps)
        from ..analysis.evaluation import eval_batches

        batch = next(iter(eval_batches(val_pipeline)))
        images = batch.image[:4]
        maps = collect_attention_maps(self.model, self.state.variables(), images)
        if not maps or maps[-1].shape[0] != len(images):
            return None
        has_cls = str(cfg_get(self.model_config, "name", "")).startswith(
            ("vit", "deit"))
        heatmaps = [cls_attention_heatmap(maps[-1][i:i + 1], has_cls=has_cls)
                    for i in range(len(images))]
        return (images.float().cpu().numpy(), batch.label[:4].cpu().numpy(),
                heatmaps)

    def _log_attention_maps(self, metric_logger: MetricLogger, val_pipeline,
                            epoch: int) -> None:
        """Draw attention_maps as a figure: the images over their
        heatmaps, logged as the "attention_maps" image of the epoch."""
        found = self.attention_maps(val_pipeline)
        if found is None:
            return
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        images, labels, heatmaps = found
        fig, axes = plt.subplots(2, len(images),
                                 figsize=(2.6 * len(images), 5.2))
        axes = np.atleast_2d(axes)
        for i in range(len(images)):
            axes[0, i].imshow(images[i].squeeze(), cmap="gray")
            axes[0, i].set_title(f"label {int(labels[i])}", fontsize=9)
            axes[1, i].imshow(heatmaps[i], cmap="inferno")
            for r in (0, 1):
                axes[r, i].axis("off")
        fig.suptitle(f"attention maps — epoch {epoch}")
        metric_logger.log_image("attention_maps", fig, step=epoch)

    def save_state(self, path: str | Path) -> Path:
        """The full training state (params, batch_stats, opt_state, EMA, step)
        for an exact resume. On a mesh every rank calls it: the state is
        made whole (FSDP's blocks gathered, the accumulated gradients
        summed over the data axis) and the mesh's first rank writes it."""
        opt_state = self.state.opt_state.state_dict()
        if self.mesh is not None:
            opt_state = self._whole_opt_state(opt_state)
        path = Path(path).absolute()
        if self.is_lead:
            save_checkpoint(path, self.state, include_opt_state=True,
                            opt_state=opt_state)
        self._barrier()
        return path

    def _whole_opt_state(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        params = self.state.params
        if "acc" in sd:                       # MultiSteps
            acc = {n: t.clone() for n, t in sd["acc"].items()}
            all_reduce_(list(acc.values()), self.data_group)
            inner = self.sync.full_state(sd["inner"], params) \
                if self.sync.fsdp else sd["inner"]
            return {**sd, "inner": inner, "acc": acc}
        return self.sync.full_state(sd, params) if self.sync.fsdp else sd

    def _blocked_opt_state(self, sd: Dict[str, Any]) -> Dict[str, Any]:
        """A whole optimizer state → this rank's: FSDP's blocks, the
        accumulated gradients on the data axis's first rank (their sum
        over the axis is what the boundary reduces)."""
        if "acc" in sd:
            first = self.batch_sharding.index == 0
            acc = {n: t if first else torch.zeros_like(t)
                   for n, t in sd["acc"].items()}
            inner = self.sync.block_state(sd["inner"]) \
                if self.sync.fsdp else sd["inner"]
            return {**sd, "inner": inner, "acc": acc}
        return self.sync.block_state(sd) if self.sync.fsdp else sd

    def resume_from(self, path: str | Path) -> None:
        """Restore a state saved by save_state (on a mesh or not: the
        checkpoint is whole); a plain model checkpoint (no opt_state)
        warm-starts the parameters and statistics only."""
        payload = load_payload(path)
        load_jax_variables(self.model, variables_of(payload))
        self.state.step = int(payload.get("step", 0))
        if payload.get("opt_state") is not None:
            opt_state = payload["opt_state"]
            if self.mesh is not None:
                opt_state = self._blocked_opt_state(opt_state)
            self.state.opt_state.load_state_dict(opt_state)
        if self.state.ema_params is not None:
            # an older checkpoint without EMA restarts the shadow from the
            # restored parameters
            src = payload.get("ema_params") or self.state.params
            with torch.no_grad():
                for n, e in self.state.ema_params.items():
                    e.copy_(src[n])
        self._global_step = self.state.step

    def test(self, pipeline, checkpoint: Optional[str | Path] = None,
             prefix: str = "test_") -> Dict[str, float]:
        """Evaluate, first loading `checkpoint`'s parameters and statistics
        when given."""
        if checkpoint is not None:
            variables, _ = load_checkpoint(checkpoint)
            load_jax_variables(self.model, variables)
        return self.eval_epoch(pipeline, prefix=prefix,
                               limit_fraction=self.cfg.limit_test_batches)
