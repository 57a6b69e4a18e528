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
ensemble's members from such checkpoints.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.from_jax import jax_tree, load_jax_variables

STATE_FILE = "state.pt"


def _cpu(named: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().cpu().clone() for n, t in named.items()}


def save_checkpoint(path: str | Path, state: Any,
                    metadata: Optional[Dict[str, Any]] = None,
                    include_opt_state: bool = False) -> Path:
    """Save params, batch_stats and step (+ metadata.json). With
    `include_opt_state` the optimizer state (count and moments, by port
    parameter name) and the EMA shadow are stored too, for an exact
    resume."""
    path = Path(path).absolute()
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    payload: Dict[str, Any] = {
        "params": jax_tree(state.params, state.layout),
        "batch_stats": jax_tree(state.batch_stats, state.layout),
        "step": int(state.step)}
    if include_opt_state:
        sd = state.opt_state.state_dict()
        payload["opt_state"] = {"count": sd["count"], "mu": _cpu(sd["mu"]),
                                "nu": _cpu(sd["nu"])}
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
    the {model}-best.ckpt and {model}-latest.ckpt aliases."""

    def __init__(self, checkpoint_dir: str | Path, model_name: str,
                 monitor: str = "val_acc", mode: str = "max",
                 save_top_k: int = 3, save_last: bool = True):
        self.dir = Path(checkpoint_dir)
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
        if self.save_last:
            save_checkpoint(self.dir / f"{self.model_name}-latest.ckpt",
                            state, metadata)
        in_top_k = len(self.kept) < self.save_top_k or self._better(
            value, self.kept[-1][0])
        is_best = not self.kept or self._better(value, self.kept[0][0])
        if in_top_k:
            path = self.dir / f"{self.model_name}-epoch{epoch:03d}-{value:.4f}.ckpt"
            save_checkpoint(path, state, metadata)
            self.kept.append((value, path))
            self.kept.sort(key=lambda kv: kv[0], reverse=(self.mode == "max"))
            for _, stale in self.kept[self.save_top_k:]:
                shutil.rmtree(stale, ignore_errors=True)
            self.kept = self.kept[: self.save_top_k]
        if is_best:
            best = self.dir / f"{self.model_name}-best.ckpt"
            if best.exists():
                shutil.rmtree(best)
            shutil.copytree(self.kept[0][1], best)
        return is_best


def restore_ensemble(ensemble: Any, checkpoints: List[str | Path]) -> Any:
    """Fill the members of a CNNEnsemble (a registry shell) from their
    checkpoints, one a member in order; returns the ensemble."""
    if len(checkpoints) != len(ensemble.members):
        raise ValueError(f"{len(ensemble.members)} members but "
                         f"{len(checkpoints)} checkpoints")
    for member, path in zip(ensemble.members, checkpoints):
        load_jax_variables(member, load_checkpoint(path)[0])
    return ensemble
