"""Parameter holders shared by the port's models (counterpart of
thyroid_tpu/models/layers.py, the parts Swin and EfficientNet use, and of
flax's nn.Conv and nn.BatchNorm).

Parameters keep the JAX package's names — LayerNorm and BatchNorm
`scale`/`bias`, Dense and Conv `kernel` and `bias`, BatchNorm's running
`mean`/`var` (buffers: the JAX `batch_stats` collection) — so a JAX
variable tree maps onto a module leaf by leaf (models/from_jax.py). Dense
kernels keep the JAX layout (in, out), which the fused kernels take; a
module whose parameters are laid out otherwise declares the difference in
`jax_layout` (ConvParams: flax's HWIO kernel is PyTorch's OIHW here).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

# torch nn.LayerNorm's default, which the JAX package and its kernels use
LN_EPS = 1e-5
# flax nn.BatchNorm's default epsilon
BN_EPS = 1e-5
# a flax conv kernel (kh, kw, in / groups, out) → PyTorch's (out, in / groups,
# kh, kw): the axes of the JAX array in the port's order
HWIO_TO_OIHW = (3, 2, 0, 1)
# std of a standard normal truncated at ±2 (flax's variance_scaling divides by
# it, so that the truncated draw has the asked-for variance)
_TRUNC_STD = 0.87962566103423978


def trunc_normal_(t: torch.Tensor, generator: torch.Generator,
                  std: float = 0.02) -> torch.Tensor:
    """Truncated normal at ±2σ, the JAX package's default initialiser."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal (variance_scaling(1, "fan_in",
    "truncated_normal")): a normal truncated at ±2 of its own σ, scaled to
    variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    return trunc_normal_(t, generator, std)


class LNParams(nn.Module):
    """LayerNorm parameters only; the kernels compute the norm."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))


class DenseParams(nn.Module):
    """Dense parameters: kernel (in, out) and an optional bias (out,)."""

    def __init__(self, in_dim: int, out_dim: int, use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            trunc_normal_(self.kernel, generator)
            if self.bias is not None:
                self.bias.zero_()


class ConvParams(nn.Module):
    """flax nn.Conv parameters: `kernel` in PyTorch's (out, in / groups,
    kh, kw) layout and an optional `bias` (out,). The JAX leaf is the HWIO
    kernel (a depthwise one (k, k, 1, C)); `jax_layout` says so."""

    # JAX leaf → (port parameter, axes of the JAX array in the port's order)
    jax_layout: Dict[str, Tuple[str, Optional[Tuple[int, ...]]]] = {
        "kernel": ("kernel", HWIO_TO_OIHW)}

    def __init__(self, in_dim: int, out_dim: int, k: int = 1, groups: int = 1,
                 use_bias: bool = False):
        super().__init__()
        self.groups = groups
        self.kernel = nn.Parameter(torch.empty(out_dim, in_dim // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(out_dim)) if use_bias else None

    def init_(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun_normal over the fan-in kh·kw·in/groups,
        zero bias."""
        with torch.no_grad():
            lecun_normal_(self.kernel, self.kernel[0].numel(), generator)
            if self.bias is not None:
                self.bias.zero_()


class BatchNorm(nn.Module):
    """flax nn.BatchNorm (flax 0.12, `momentum`, epsilon 1e-5) over the last
    axis: parameters `scale`, `bias`; running statistics in the float32
    buffers `mean`, `var` (the JAX `batch_stats`). In training the batch's
    statistics are taken in float32, also for bfloat16 inputs, with the
    biased variance E[x²] − E[x]² clipped at 0, and the running statistics
    become momentum·ra + (1 − momentum)·batch. (`F.batch_norm` and
    `nn.BatchNorm2d` update the running variance with the unbiased variance,
    n/(n−1) off flax's, so the statistics are written out here.) The
    normalisation is float32, the result in `dtype`."""

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = BN_EPS):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, train: bool,
                dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        if train:
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(dim=axes)
            var = torch.clamp((xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            # the step's new statistics, installed in place: the training
            # normalisation reads the batch's, never the running ones
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((xf - mean) * mul + self.bias).to(dtype)


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax nn.Dropout: in training each element is kept with probability
    1 − rate and scaled by 1/keep, the draws from `generator` (on x's
    device); an identity at eval or at rate 0."""
    if not train or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training needs a torch.Generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class MlpParams(nn.Module):
    """The Mlp tree (Dense_0, Dense_1) of the JAX package."""

    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.Dense_0 = DenseParams(in_dim, hidden)
        self.Dense_1 = DenseParams(hidden, in_dim)


class DropPath(nn.Module):
    """Stochastic depth: drop the residual branch per sample. In training
    each sample keeps its branch with probability 1 − rate, scaled by
    1/keep; the Bernoulli draws come from the explicit `generator` (on x's
    device). An identity at eval or at rate 0."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("DropPath in training needs a torch.Generator")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))
