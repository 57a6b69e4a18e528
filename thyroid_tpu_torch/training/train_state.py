"""Train state (counterpart of thyroid_tpu/training/train_state.py).

The JAX state is an immutable pytree that every step replaces. Here the
parameters are the model's own tensors, and `apply_gradients` updates
them, the optimizer moments and the EMA shadow in place (saving a second
copy of every buffer) and returns the same state object.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from .schedules import Optimizer, apply_updates


class TrainState:
    """step, params ({name: the model's parameter}), opt_state and the EMA
    shadow (a float32 copy of every parameter, or None)."""

    def __init__(self, model: torch.nn.Module, tx: Optimizer,
                 ema: bool = False):
        self.step = 0
        self.params: Dict[str, torch.Tensor] = dict(model.named_parameters())
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
        for and kept, else the parameters."""
        if use_ema and self.ema_params is not None:
            return self.ema_params
        return self.params
