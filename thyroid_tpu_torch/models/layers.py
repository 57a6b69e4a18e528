"""Parameter holders shared by the port's models (counterpart of
thyroid_tpu/models/layers.py, the part Swin uses).

Parameters keep the JAX package's names and layouts — LayerNorm
`scale`/`bias`, Dense `kernel` as (in, out) and `bias` — so a JAX
parameter tree maps onto a module leaf by leaf
(models/from_jax.py) and the fused kernels take them as they are.
"""
from __future__ import annotations

import torch
from torch import nn

# torch nn.LayerNorm's default, which the JAX package and its kernels use
LN_EPS = 1e-5


def trunc_normal_(t: torch.Tensor, generator: torch.Generator,
                  std: float = 0.02) -> torch.Tensor:
    """Truncated normal at ±2σ, the JAX package's default initialiser."""
    return nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


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
