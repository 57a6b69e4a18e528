"""Learning-rate schedules and the optimizer (counterpart of
thyroid_tpu/training/schedules.py).

The JAX package builds them from optax; this module computes the same
numbers without it:
- `build_schedule`: optax's `linear_schedule` warmup joined to
  `cosine_decay_schedule(alpha=eta_min/base_lr)` (or a step or constant
  decay), a function of the update count starting from 0;
- `build_optimizer`: the chain `clip_by_global_norm` (or `clip`, by
  value) → `adamw` (decay masked to parameters with ndim > 1) or
  `sgd(momentum=0.9)` → a per-parameter layer-decay scale, inside
  `MultiSteps` when gradients accumulate.

optax semantics kept: the schedule is read at the count *before* the
update's increment (with warmup the first update has lr 0); the clip scales
by max_norm / norm only when norm ≥ max_norm, with no epsilon; AdamW's eps
sits outside the square root and the decay joins the Adam direction before
the learning rate, −lr·(adam + wd·p); the layer scale multiplies that whole
update; MultiSteps averages k mini-steps' gradients by Welford's update,
runs the chain on the mean once every k mini-steps (its count, which the
schedule and Adam's bias correction read, advances only then) and
returns zeros in between. Parameters are a {name: tensor} dict with the port's dotted names.

On a process mesh the Trainer gives the optimizer a `sync`
(parallel/collectives.py GradSync): the gradients are summed over the
data axis before the chain runs, at the accumulation boundary under
MultiSteps (its running mean stays this rank's until then), and under
FSDP the chain runs on this rank's blocks, its state holds blocks, and
the clip's norm is taken over the whole tree from them.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, Optional

import torch

Schedule = Callable[[int], float]


def build_schedule(base_lr: float, steps_per_epoch: int, epochs: int,
                   warmup_epochs: int = 0, warmup_steps: int = 0,
                   eta_min: float = 0.0, kind: str = "cosine",
                   step_size: Optional[int] = None,
                   gamma: Optional[float] = None) -> Schedule:
    """Linear warmup into cosine/step/constant decay: count → lr."""
    warmup = warmup_steps or warmup_epochs * steps_per_epoch
    total = max(epochs * steps_per_epoch, warmup + 1)
    if kind in (None, "constant", "none"):
        def decay(count: int) -> float:
            return base_lr
    elif kind == "cosine":
        steps = max(total - warmup, 1)
        alpha = eta_min / base_lr if base_lr else 0.0

        def decay(count: int) -> float:
            frac = min(count, steps) / steps
            return base_lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * frac))
                              + alpha)
    elif kind == "step":
        every = (step_size or 30) * steps_per_epoch
        rate = gamma or 0.1

        def decay(count: int) -> float:
            return base_lr * rate ** (count // every)
    else:
        raise ValueError(f"unknown schedule '{kind}'")
    if warmup <= 0:
        return decay

    def schedule(count: int) -> float:
        if count < warmup:
            return base_lr * max(count, 0) / warmup
        return decay(count - warmup)

    return schedule


def layer_decay_mask(names, decay: float, num_layers: int) -> Dict[str, float]:
    """Per-parameter LR scale, the JAX package's recipe on the port's
    dotted names: patch_embed / pos_embed / cls_token / dist_token decay²;
    the first `block_(\\d+)`, else `stage_(\\d+)`, index i gives
    decay^max(num_layers − 1 − i, 0); anything else 1.0. The quirks are
    kept: a Swin parameter matches its block index inside its stage before
    its stage index, and num_layers is the model's len(depths) or 12."""

    def scale(name: str) -> float:
        if "patch_embed" in name or "pos_embed" in name \
                or "cls_token" in name or "dist_token" in name \
                or "absolute_pos_embed" in name:
            return decay ** 2
        m = re.search(r"block_(\d+)", name) or re.search(r"stage_(\d+)", name)
        if m:
            return decay ** max(num_layers - 1 - int(m.group(1)), 0)
        return 1.0

    return {n: scale(n) for n in names}


def _load_named(mine: Dict[str, torch.Tensor], sd: Dict[str, torch.Tensor],
                slot: str) -> None:
    if set(sd) != set(mine):
        raise KeyError(f"optimizer state {slot} names differ")
    for n, t in sd.items():
        mine[n].copy_(t)


class AdamWState:
    """optax's adamw state: the update count and the first and second
    moments of every parameter."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.count = 0
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        _load_named(self.mu, sd["mu"], "mu")
        _load_named(self.nu, sd["nu"], "nu")


class SGDState:
    """optax's sgd(momentum) state: the update count (the schedule's) and
    the momentum trace of every parameter."""

    def __init__(self, params: Dict[str, torch.Tensor]):
        self.count = 0
        self.trace = {n: torch.zeros_like(p) for n, p in params.items()}

    def state_dict(self) -> dict:
        return {"count": self.count, "trace": self.trace}

    def load_state_dict(self, sd: dict) -> None:
        self.count = int(sd["count"])
        _load_named(self.trace, sd["trace"], "trace")


class MultiStepsState:
    """optax.MultiSteps' state: the mini-step within the current k, the
    number of updates made, the wrapped chain's state and the running mean
    of the gradients since the last update."""

    def __init__(self, params: Dict[str, torch.Tensor], inner):
        self.mini_step = 0
        self.gradient_step = 0
        self.inner = inner
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()}

    @property
    def count(self) -> int:
        return self.inner.count

    def state_dict(self) -> dict:
        return {"mini_step": self.mini_step,
                "gradient_step": self.gradient_step,
                "inner": self.inner.state_dict(), "acc": self.acc}

    def load_state_dict(self, sd: dict) -> None:
        self.mini_step = int(sd["mini_step"])
        self.gradient_step = int(sd["gradient_step"])
        self.inner.load_state_dict(sd["inner"])
        _load_named(self.acc, sd["acc"], "acc")


def global_norm(tensors) -> torch.Tensor:
    """sqrt(Σ over tensors of ‖t‖²), float32 (whole tensors; a tree
    sharded by FSDP takes GradSync.norm)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.sqrt((torch.stack(norms) ** 2).sum())


class Optimizer:
    """The optax chain clip (by global norm, or by value) → adamw with a
    decay mask, or sgd with momentum 0.9 → per-parameter scale, wrapped in
    MultiSteps when `accumulate_steps` > 1, as `init`/`update` functions
    on {name: tensor} dicts. `update` returns the updates to add to the
    parameters (apply_updates) without touching them; between
    accumulation's updates it returns {} (optax returns zeros)."""

    def __init__(self, schedule: Schedule, weight_decay: float, b1: float,
                 b2: float, eps: float, clip: Optional[float],
                 decay_mask: Dict[str, bool],
                 scales: Optional[Dict[str, float]],
                 clip_algorithm: str = "norm", name: str = "adamw",
                 accumulate_steps: int = 1):
        self.schedule = schedule
        self.weight_decay, self.b1, self.b2, self.eps = \
            weight_decay, b1, b2, eps
        self.clip, self.clip_algorithm = clip, clip_algorithm
        self.decay_mask, self.scales = decay_mask, scales
        self.name = name
        self.accumulate_steps = int(accumulate_steps)
        self.sync = None

    def local(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The tensors the chain updates: this rank's FSDP blocks, else
        `params` itself."""
        return params if self.sync is None else self.sync.local(params)

    def init(self, params: Dict[str, torch.Tensor]):
        local = self.local(params)
        inner = SGDState(local) if self.name == "sgd" else AdamWState(local)
        if self.accumulate_steps > 1:
            return MultiStepsState(params, inner)
        return inner

    def update(self, grads: Dict[str, torch.Tensor], state,
               params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if not isinstance(state, MultiStepsState):
            if self.sync is not None:
                grads = self.sync.reduce(grads)
            return self._chain(grads, state, self.local(params))
        # MultiSteps: a running mean of the mini-steps' gradients (Welford:
        # acc + (g − acc) / (n + 1)); the chain runs on it once every k
        # mini-steps, and its count advances only then
        names = list(grads)
        acc = [state.acc[n] for n in names]
        delta = torch._foreach_sub([grads[n] for n in names], acc)
        torch._foreach_div_(delta, float(state.mini_step + 1))
        torch._foreach_add_(acc, delta)
        emit = state.mini_step == self.accumulate_steps - 1
        state.mini_step = (state.mini_step + 1) % self.accumulate_steps
        if not emit:
            return {}
        mean = dict(zip(names, acc))
        if self.sync is not None:
            mean = self.sync.reduce(mean)
        updates = self._chain(mean, state.inner, self.local(params))
        state.gradient_step += 1
        torch._foreach_zero_(acc)
        return updates

    def _chain(self, grads: Dict[str, torch.Tensor], state,
               params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        names = list(grads)
        g = [grads[n] for n in names]
        if self.clip and self.clip_algorithm == "value":
            # optax.clip: each element into [−v, v]
            g = torch._foreach_clamp_max(torch._foreach_clamp_min(g, -self.clip),
                                         self.clip)
        elif self.clip:
            # select(norm < max, t, (t / norm) * max) without a host read
            norm = self.sync.norm(dict(zip(names, g))) \
                if self.sync is not None and self.sync.fsdp else global_norm(g)
            trigger = norm < self.clip
            one = torch.ones((), dtype=norm.dtype, device=norm.device)
            denom = torch.where(trigger, one, norm)
            mult = torch.where(trigger, one, one * self.clip)
            g = torch._foreach_mul(torch._foreach_div(g, denom), mult)
        if isinstance(state, SGDState):
            upd = self._sgd(names, g, state)
        else:
            upd = self._adamw(names, g, state, params)
        if self.scales is not None:
            torch._foreach_mul_(upd, [self.scales[n] for n in names])
        return dict(zip(names, upd))

    def _sgd(self, names, g, state: SGDState):
        """optax.sgd(schedule, momentum=0.9): t ← g + 0.9·t, then
        −lr(count)·t; no weight decay."""
        trace = [state.trace[n] for n in names]
        torch._foreach_mul_(trace, 0.9)
        torch._foreach_add_(trace, g)
        lr = self.schedule(state.count)      # read before the increment
        state.count += 1
        return torch._foreach_mul(trace, -lr)

    def _adamw(self, names, g, state: AdamWState, params):
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        # (1 − b) · g^k + b · m, in place in the state
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g),
                                                   1 - self.b2))
        lr = self.schedule(state.count)      # read before the increment
        state.count += 1
        bc1 = float(torch.tensor(1.0) - torch.tensor(self.b1) ** state.count)
        bc2 = float(torch.tensor(1.0) - torch.tensor(self.b2) ** state.count)
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        den = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.eps)
        upd = torch._foreach_div(mu_hat, den)
        decayed = [i for i, n in enumerate(names) if self.decay_mask[n]]
        if self.weight_decay and decayed:      # u + wd · p, masked
            torch._foreach_add_([upd[i] for i in decayed], torch._foreach_mul(
                [params[names[i]] for i in decayed], self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        return upd


def build_optimizer(params: Dict[str, torch.Tensor], schedule: Schedule,
                    weight_decay: float = 1e-5, beta1: float = 0.9,
                    beta2: float = 0.999, eps: float = 1e-8,
                    gradient_clip_val: Optional[float] = 1.0,
                    gradient_clip_algorithm: str = "norm",
                    layer_decay: Optional[float] = None,
                    num_layers: int = 12, accumulate_steps: int = 1,
                    name: str = "adamw") -> Optimizer:
    """AdamW (decay masked off parameters with ndim ≤ 1), or SGD with
    momentum 0.9 when `name` is "sgd", after a clip by global norm (or by
    value when `gradient_clip_algorithm` is "value"), with optional
    layer-wise LR decay, the gradients of `accumulate_steps` mini-steps
    averaged into each update."""
    scales = None
    if layer_decay is not None and 0 < layer_decay < 1:
        scales = layer_decay_mask(params, float(layer_decay), num_layers)
    return Optimizer(schedule, float(weight_decay), float(beta1), float(beta2),
                     float(eps), gradient_clip_val,
                     {n: p.dim() > 1 for n, p in params.items()}, scales,
                     clip_algorithm=gradient_clip_algorithm, name=name,
                     accumulate_steps=accumulate_steps)


def apply_updates(params: Dict[str, torch.Tensor],
                  updates: Dict[str, torch.Tensor]) -> None:
    """p ← p + u for every parameter, in place (optax.apply_updates returns
    new arrays; the port updates the model's own parameters)."""
    if not updates:
        return
    with torch.no_grad():
        names = list(updates)
        torch._foreach_add_([params[n] for n in names],
                            [updates[n] for n in names])
