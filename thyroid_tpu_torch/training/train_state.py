"""Train state (counterpart of thyroid_tpu/training/train_state.py).

The JAX state is an immutable pytree that every step replaces. Here the
parameters and the BatchNorm statistics are the model's own tensors, and
`apply_gradients` updates the parameters, the optimizer moments and the EMA
shadow in place (saving a second copy of every buffer) and returns the same
state object; the statistics are updated in place by the training forward
(layers.BatchNorm), where JAX takes them out of the loss function and
installs them with the step.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.from_jax import batch_stats, jax_layout
from .schedules import Optimizer, apply_updates


class TrainState:
    """step, params ({name: the model's parameter}), batch_stats ({name:
    the model's BatchNorm buffer}, empty for a model without BatchNorm),
    opt_state and the EMA shadow (a float32 copy of every parameter, or
    None; the statistics have none, as in JAX). `layout` is the model's JAX
    layout, for checkpoints."""

    def __init__(self, model: torch.nn.Module, tx: Optimizer,
                 ema: bool = False):
        self.step = 0
        self.params: Dict[str, torch.Tensor] = dict(model.named_parameters())
        self.batch_stats: Dict[str, torch.Tensor] = batch_stats(model)
        self.layout = jax_layout(model)
        self.tx = tx
        self.opt_state = tx.init(self.params)
        self.ema_params: Optional[Dict[str, torch.Tensor]] = (
            {n: p.detach().clone() for n, p in self.params.items()}
            if ema else None)

    @torch.no_grad()
    def apply_gradients(self, grads: Dict[str, torch.Tensor],
                        ema_decay: Optional[float] = None) -> "TrainState":
        updates = self.tx.update(grads, self.opt_state, self.params)
        apply_updates(self.params, updates)
        if ema_decay is not None and self.ema_params is not None:
            # e · decay + p · (1 − decay)
            ema = list(self.ema_params.values())
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, torch._foreach_mul(
                [self.params[n] for n in self.ema_params], 1.0 - ema_decay))
        self.step += 1
        return self

    def variables(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """{name: tensor} to run the model with: the EMA shadow when asked
        for and kept, else the parameters, with the live statistics."""
        params = self.ema_params if use_ema and self.ema_params is not None \
            else self.params
        return {**params, **self.batch_stats}
