"""Checkpoints and best-checkpoint tracking (counterpart of
thyroid_tpu/training/checkpoint.py).

A checkpoint is a directory, named as in the JAX package, holding
`state.pt` (written by `torch.save`) and, when given, the `metadata.json`
sidecar. `state.pt` holds {params, batch_stats, step} (batch_stats empty
for a model without BatchNorm, as the JAX package stores it) and, for an
exact resume, opt_state and ema_params. params and batch_stats are JAX
trees (the JAX leaf names and layouts, conv kernels HWIO) of float32
tensors, so `models/from_jax.py:load_jax_variables` fills a model from
them. The format is not orbax's: the JAX package cannot read these
checkpoints, nor this one the JAX package's. `restore_ensemble` fills an
ensemble's members from such checkpoints, and the teacher side
(`load_teacher`, `make_teacher_fn`, `make_ensemble_teacher_fn`,
`create_teacher_from_config`) builds a frozen distillation teacher from
them: each member built from its own model config (float32 where the
config names no dtype, as in JAX, whatever the student's precision), in
eval mode, its parameters taking no gradient.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import cnn, ensemble, vit  # noqa: F401  (register the model families)
from ..models.from_jax import jax_tree, load_jax_variables
from ..models.registry import ModelRegistry, cfg_get
from ..ops.platform import DeviceLike, resolve_device

STATE_FILE = "state.pt"


def _cpu(tree):
    """`tree` (nested dicts) with every tensor copied to the CPU."""
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    return tree.detach().cpu().clone() if isinstance(tree, torch.Tensor) else tree


def save_checkpoint(path: str | Path, state: Any,
                    metadata: Optional[Dict[str, Any]] = None,
                    include_opt_state: bool = False,
                    opt_state: Optional[Dict[str, Any]] = None) -> Path:
    """Save params, batch_stats and step (+ metadata.json). With
    `include_opt_state` the optimizer state (counts, moments or trace and
    the accumulated gradients, by port parameter name; `opt_state` when
    given, else the state's own) and the EMA shadow are stored too, for
    an exact resume."""
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    payload: Dict[str, Any] = {
        "params": jax_tree(state.params, state.layout),
        "batch_stats": jax_tree(state.batch_stats, state.layout),
        "step": int(state.step)}
    if include_opt_state:
        payload["opt_state"] = _cpu(opt_state if opt_state is not None
                                    else state.opt_state.state_dict())
        if state.ema_params is not None:
            payload["ema_params"] = _cpu(state.ema_params)
    torch.save(payload, path / STATE_FILE)
    if metadata is not None:
        with open(path / "metadata.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)
    return path


def load_payload(path: str | Path) -> Dict[str, Any]:
    """The raw `state.pt` dict of a checkpoint directory."""
    return torch.load(Path(path).absolute() / STATE_FILE, map_location="cpu",
                      weights_only=True)


def load_checkpoint(path: str | Path) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """→ (variables {"params"[, "batch_stats"]: JAX trees of tensors},
    metadata)."""
    path = Path(path).absolute()
    payload = load_payload(path)
    meta_path = path / "metadata.json"
    metadata = json.loads(meta_path.read_text()) if meta_path.exists() else {}
    return variables_of(payload), metadata


def variables_of(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX variable tree of a checkpoint's payload: params, and
    batch_stats where the model has them."""
    variables = {"params": payload["params"]}
    if payload.get("batch_stats"):
        variables["batch_stats"] = payload["batch_stats"]
    return variables


class BestCheckpointManager:
    """Monitors a metric; keeps the top k and the last epoch; maintains
    the {model}-best.ckpt and {model}-latest.ckpt aliases. With `write`
    off (a mesh's other ranks) it decides and names as the writer does and
    touches no file."""

    def __init__(self, checkpoint_dir: str | Path, model_name: str,
                 monitor: str = "val_acc", mode: str = "max",
                 save_top_k: int = 3, save_last: bool = True,
                 write: bool = True):
        self.dir = Path(checkpoint_dir)
        self.write = write
        if write:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.model_name = model_name
        self.monitor = monitor
        self.mode = mode
        self.save_top_k = save_top_k
        self.save_last = save_last
        self.kept: List[Tuple[float, Path]] = []   # (metric, path)

    def _better(self, a: float, b: float) -> bool:
        return a > b if self.mode == "max" else a < b

    @property
    def best_metric(self) -> Optional[float]:
        return self.kept[0][0] if self.kept else None

    @property
    def best_path(self) -> Optional[Path]:
        return self.kept[0][1] if self.kept else None

    def step(self, state: Any, metrics: Dict[str, float], epoch: int,
             extra_metadata: Optional[Dict[str, Any]] = None) -> bool:
        """Save if this epoch ranks in the top k. Returns True on a new
        best."""
        value = metrics.get(self.monitor)
        if value is None or not np.isfinite(value):
            return False
        metadata = {"epoch": epoch, "metrics": metrics,
                    "monitor": self.monitor, **(extra_metadata or {})}
        if self.save_last and self.write:
            save_checkpoint(self.dir / f"{self.model_name}-latest.ckpt",
                            state, metadata)
        in_top_k = len(self.kept) < self.save_top_k or self._better(
            value, self.kept[-1][0])
        is_best = not self.kept or self._better(value, self.kept[0][0])
        if in_top_k:
            path = self.dir / f"{self.model_name}-epoch{epoch:03d}-{value:.4f}.ckpt"
            if self.write:
                save_checkpoint(path, state, metadata)
            self.kept.append((value, path))
            self.kept.sort(key=lambda kv: kv[0], reverse=(self.mode == "max"))
            for _, stale in self.kept[self.save_top_k:]:
                if self.write:
                    shutil.rmtree(stale, ignore_errors=True)
            self.kept = self.kept[: self.save_top_k]
        if is_best and self.write:
            best = self.dir / f"{self.model_name}-best.ckpt"
            if best.exists():
                shutil.rmtree(best)
            shutil.copytree(self.kept[0][1], best)
        return is_best


def get_best_checkpoint(checkpoint_dir: str | Path,
                        model_name: str) -> Optional[Path]:
    """`{checkpoint_dir}/{model_name}-best.ckpt` where it exists."""
    p = Path(checkpoint_dir) / f"{model_name}-best.ckpt"
    return p if p.exists() else None


# ---------------------------------------------------------------------------
# distillation teachers
# ---------------------------------------------------------------------------

def load_teacher(checkpoint_path: str | Path, model_config: Any,
                 device: DeviceLike = None
                 ) -> Tuple[torch.nn.Module, Dict[str, Any], Dict[str, Any]]:
    """A frozen teacher → (module filled from the checkpoint, in eval mode
    on `device` with no parameter requiring a gradient, its variables,
    metadata)."""
    module = ModelRegistry.create_model(model_config)
    variables, metadata = load_checkpoint(checkpoint_path)
    load_jax_variables(module, variables)
    module.requires_grad_(False)
    return module.to(resolve_device(device)).eval(), variables, metadata


class Teacher:
    """A frozen teacher's forward: the eval-mode logits (the first of a
    tuple) of one member, or the weighted average Σ wᵢ·logitsᵢ of several,
    in member order, under torch.no_grad. `members` are the modules, which
    hold the teacher's weights."""

    def __init__(self, members: Sequence[torch.nn.Module],
                 weights: Optional[Sequence[float]] = None):
        self.members = list(members)
        self.weights = None if weights is None else [float(w) for w in weights]

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        acc = None
        for i, module in enumerate(self.members):
            out = module(x, train=False)
            if isinstance(out, tuple):
                out = out[0]
            if self.weights is None:
                return out
            out = out * self.weights[i]
            acc = out if acc is None else acc + out
        return acc


def _frozen(module: torch.nn.Module, variables: Optional[Dict[str, Any]]):
    if variables is not None:
        load_jax_variables(module, variables)
    return module.requires_grad_(False).eval()


def make_teacher_fn(module: torch.nn.Module,
                    variables: Optional[Dict[str, Any]] = None) -> Teacher:
    """A frozen single teacher; `variables` (a JAX tree), when given, fill
    the module first."""
    return Teacher([_frozen(module, variables)])


def make_ensemble_teacher_fn(members: Sequence[Any],
                             weights: Optional[Sequence[float]] = None
                             ) -> Teacher:
    """The weighted logit average of `members` (modules, or (module, JAX
    variables) pairs), the weights normalised to sum 1 (equal without
    weights)."""
    if weights is None:
        weights = [1.0 / len(members)] * len(members)
    w = [float(x) for x in weights]
    total = sum(w)
    modules = [_frozen(*m) if isinstance(m, tuple) else _frozen(m, None)
               for m in members]
    return Teacher(modules, [x / total for x in w])


def create_teacher_from_config(distillation_cfg: Any,
                               device: DeviceLike = None) -> Callable:
    """The teacher a distillation node names, on `device`: a
    `teacher_checkpoints` list (models from `teacher_models`, else from
    each file's name; weights `teacher_weights`) makes an ensemble, else
    `teacher_checkpoint` with `teacher_model` (else the file's name) a
    single teacher."""
    ckpts = cfg_get(distillation_cfg, "teacher_checkpoints", None)
    if ckpts:
        model_cfgs = cfg_get(distillation_cfg, "teacher_models", None)
        members = []
        for i, ck in enumerate(ckpts):
            mc = model_cfgs[i] if model_cfgs else _infer_model_config_from_path(ck)
            members.append(load_teacher(ck, mc, device)[0])
        return make_ensemble_teacher_fn(
            members, cfg_get(distillation_cfg, "teacher_weights", None))
    ckpt = cfg_get(distillation_cfg, "teacher_checkpoint", None)
    if ckpt is None:
        raise ValueError("distillation config carries no teacher checkpoint")
    mc = cfg_get(distillation_cfg, "teacher_model", None) or \
        _infer_model_config_from_path(ckpt)
    return make_teacher_fn(load_teacher(ckpt, mc, device)[0])


def _infer_model_config_from_path(path: str | Path) -> Dict[str, Any]:
    """{"name": the first registry name, CNNs then ViTs in sorted order,
    that is a substring of the file's name}."""
    stem = Path(path).name.lower()
    for name in ModelRegistry.list_models("cnn") + ModelRegistry.list_models("vit"):
        if name in stem:
            return {"name": name}
    raise ValueError(f"cannot infer teacher architecture from path {path}")


def restore_ensemble(ensemble: Any, checkpoints: List[str | Path]) -> Any:
    """Fill the members of a CNNEnsemble (a registry shell) from their
    checkpoints, one a member in order; returns the ensemble."""
    if len(checkpoints) != len(ensemble.members):
        raise ValueError(f"{len(ensemble.members)} members but "
                         f"{len(checkpoints)} checkpoints")
    for member, path in zip(ensemble.members, checkpoints):
        load_jax_variables(member, load_checkpoint(path)[0])
    return ensemble
