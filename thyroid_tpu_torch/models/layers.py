"""Building blocks shared by the port's models (counterpart of
thyroid_tpu/models/layers.py, and of flax's nn.Conv and nn.BatchNorm).

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
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.token_fused import fused_ln_matmul, fused_ln_mlp_residual
from .registry import cfg_get

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


# The capture path (`forward(..., capture=True)`): a model records the
# tensors the JAX package sows into its "intermediates" collection through a
# `record(key, tensor)` callable that each parent scopes for its children.
# Keys are the flax module path joined by "/" ("block_0/Attention_0/
# attention"), which sort as the JAX package's "/".join(str(k) for k in
# path) strings sort ("['block_0']/['Attention_0']/['attention']/[0]"):
# '/' and the end of a key, like "'", sort before every letter, digit and
# '_' of a module name.
Record = Optional[Callable[[str, torch.Tensor], None]]


def scoped(record: Record, scope: str) -> Record:
    """`record` with its keys under `scope/`; None stays None."""
    if record is None:
        return None
    return lambda key, value: record(f"{scope}/{key}", value)


def recorder(capture: bool):
    """(the dict a capture forward fills, its `record`), or (None, None)."""
    if not capture:
        return None, None
    recorded: Dict[str, torch.Tensor] = {}
    return recorded, recorded.__setitem__


def captured(out: Any, recorded: Optional[Dict[str, torch.Tensor]]):
    """A forward's result: `out`, or (out, the recorded tensors by key in
    the JAX package's order) from a capture forward."""
    if recorded is None:
        return out
    return out, dict(sorted(recorded.items()))


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


class LecunDense(DenseParams):
    """Dense parameters that flax's nn.Dense initialises by its defaults:
    lecun_normal kernel over the fan-in, zero bias (Swin's quality gates,
    quality-aware merge weights and uncertainty head)."""

    def init_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            lecun_normal_(self.kernel, self.kernel.shape[0], generator)
            if self.bias is not None:
                self.bias.zero_()


class ConvParams(nn.Module):
    """flax nn.Conv parameters: `kernel` in PyTorch's (out, in / groups,
    kh, kw) layout and an optional `bias` (out,). The JAX leaf is the HWIO
    kernel (a depthwise one (k, k, 1, C)); `jax_layout` says so. `k` is
    the side of a square kernel or (kh, kw)."""

    # JAX leaf → (port parameter, axes of the JAX array in the port's order)
    jax_layout: Dict[str, Tuple[str, Optional[Tuple[int, ...]]]] = {
        "kernel": ("kernel", HWIO_TO_OIHW)}

    def __init__(self, in_dim: int, out_dim: int,
                 k: int | Tuple[int, int] = 1, groups: int = 1,
                 use_bias: bool = False):
        super().__init__()
        self.groups = groups
        kh, kw = (k, k) if isinstance(k, int) else k
        self.kernel = nn.Parameter(torch.empty(out_dim, in_dim // groups, kh, kw))
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


def manual_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      dtype: torch.dtype, eps: float = LN_EPS) -> torch.Tensor:
    """flax LayerNorm numerics: float32 statistics, fast variance
    E[x²]−μ² clamped at 0, the result in `dtype`."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mu) * mul + bias.float()).to(dtype)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype) numerics from raw parameters: input and
    parameters cast to `dtype`, the product and the bias add in `dtype`."""
    y = x.to(dtype) @ kernel.to(dtype)
    return y + bias.to(dtype) if bias is not None else y


# ------------------------------------------------- the plain transformer
# (ViT and DeiT). Parameters carry flax's names for both paths of a Block:
# LayerNorm_0, Attention_0/Dense_{0,1}, LayerNorm_1, Mlp_0/Dense_{0,1}.


class Mlp(MlpParams):
    """Dense → exact GELU → dropout → Dense → dropout, in the stream's
    dtype."""

    def __init__(self, in_dim: int, hidden: int, drop_rate: float = 0.0):
        super().__init__(in_dim, hidden)
        self.drop_rate = float(drop_rate)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = x.dtype
        x = F.gelu(dense(x, self.Dense_0.kernel, self.Dense_0.bias, dt))
        x = dropout(x, self.drop_rate, train, generator)
        x = dense(x, self.Dense_1.kernel, self.Dense_1.bias, dt)
        return dropout(x, self.drop_rate, train, generator)


class Attention(nn.Module):
    """Multi-head self-attention over (B, N, C) in the stream's dtype:
    q·scale in that dtype, the scores accumulated in float32, softmax in
    float32 then cast, attention dropout, attn·v accumulated in float32
    then cast, the out-projection (`Dense_1`) and dropout. Plain PyTorch,
    as it is XLA outside any kernel in JAX. With `ln` = (scale, bias) the
    serving path: LN + QKV in one kernel (`fused_ln_matmul`, kernel 2) on
    the pre-norm stream x."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 attn_drop_rate: float = 0.0, proj_drop_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.scale = float((dim // num_heads) ** -0.5)
        self.attn_drop_rate = float(attn_drop_rate)
        self.proj_drop_rate = float(proj_drop_rate)
        self.Dense_0 = DenseParams(dim, 3 * dim, qkv_bias)
        self.Dense_1 = DenseParams(dim, dim)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                record: Record = None) -> torch.Tensor:
        b, n, c = x.shape
        dt = x.dtype
        heads = self.num_heads
        if ln is not None:
            qkv = fused_ln_matmul(x.contiguous(), ln[0], ln[1],
                                  self.Dense_0.kernel, self.Dense_0.bias)
        else:
            qkv = dense(x, self.Dense_0.kernel, self.Dense_0.bias, dt)
        q, k, v = qkv.reshape(b, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        # the scale rounded to the model dtype, as JAX's weakly typed constant
        q = q * torch.tensor(self.scale, dtype=dt)
        attn = torch.softmax(q.float() @ k.float().transpose(-1, -2),
                             dim=-1).to(dt)
        if record is not None:
            record("attention", attn)
        attn = dropout(attn, self.attn_drop_rate, train, generator)
        out = (attn.float() @ v.float()).to(dt)
        out = dense(out.transpose(1, 2).reshape(b, n, c), self.Dense_1.kernel,
                    self.Dense_1.bias, dt)
        return dropout(out, self.proj_drop_rate, train, generator)


class PatchEmbed(nn.Module):
    """Patch embedding: a stride-p p×p conv `proj` (cuDNN on the card) →
    (B, N, D) tokens in the model dtype. With `quality_aware` it also holds
    the patch-quality head, conv3×3 → ReLU → conv1×1 → sigmoid → p×p
    average pool → (B, N) scores (`quality_conv1`, `quality_conv2`). JAX
    computes the head on every forward and only sows it, and no loss reads
    it; here `scores(x)` computes it when asked (a train step gives its
    parameters zero gradients, as jax.grad does)."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: int,
                 quality_aware: bool = False):
        super().__init__()
        self.patch_size, self.embed_dim = patch_size, embed_dim
        self.proj = ConvParams(in_channels, embed_dim, patch_size, use_bias=True)
        if quality_aware:
            self.quality_conv1 = ConvParams(in_channels, 8, 3, use_bias=True)
            self.quality_conv2 = ConvParams(8, 1, 1, use_bias=True)
        else:
            self.quality_conv1 = self.quality_conv2 = None

    def init_(self, generator: torch.Generator) -> None:
        """proj: truncated normal σ 0.02 and zero bias; the quality convs:
        flax's lecun_normal defaults."""
        with torch.no_grad():
            trunc_normal_(self.proj.kernel, generator)
            self.proj.bias.zero_()
            for conv in (self.quality_conv1, self.quality_conv2):
                if conv is not None:
                    conv.init_(generator)

    def _check(self, x: torch.Tensor) -> None:
        p = self.patch_size
        if x.shape[1] % p or x.shape[2] % p:
            raise ValueError(f"image {x.shape[1]}x{x.shape[2]} not divisible "
                             f"by patch size {p}")

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        self._check(x)
        p = self.patch_size
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), self.proj.kernel.to(dtype),
                     self.proj.bias.to(dtype), stride=p)
        return y.permute(0, 2, 3, 1).reshape(x.shape[0], -1, self.embed_dim)

    def scores(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, N) patch-quality scores in `dtype`."""
        if self.quality_conv1 is None:
            raise ValueError("this patch embedding has no quality head")
        self._check(x)
        c1, c2 = self.quality_conv1, self.quality_conv2
        q = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), c1.kernel.to(dtype),
                     c1.bias.to(dtype), padding=1)
        q = F.conv2d(F.relu(q), c2.kernel.to(dtype), c2.bias.to(dtype))
        q = F.avg_pool2d(torch.sigmoid(q), self.patch_size)
        return q.reshape(x.shape[0], -1)


class Block(nn.Module):
    """Pre-norm transformer block. With `token_kernels`, an eval forward
    takes the serving path: LN + QKV through kernel 2, attention, the
    residual, then LN + MLP + residual through `fused_ln_mlp_residual`
    (kernel 3). Otherwise, in training and in a capture forward (a
    `record` given, as JAX's Block takes its plain path under capture): LN
    → Attention → DropPath → LN → Mlp → DropPath."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 token_kernels: bool = False):
        super().__init__()
        self.token_kernels = token_kernels
        self.LayerNorm_0 = LNParams(dim)
        self.Attention_0 = Attention(dim, num_heads, qkv_bias, attn_drop_rate,
                                     drop_rate)
        self.LayerNorm_1 = LNParams(dim)
        self.Mlp_0 = Mlp(dim, int(dim * mlp_ratio), drop_rate)
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                record: Record = None) -> torch.Tensor:
        n1, n2, m = self.LayerNorm_0, self.LayerNorm_1, self.Mlp_0
        if self.token_kernels and not train and record is None:
            x = x + self.Attention_0(x, ln=(n1.scale, n1.bias))
            return fused_ln_mlp_residual(
                x.contiguous(), n2.scale, n2.bias, m.Dense_0.kernel,
                m.Dense_0.bias, m.Dense_1.kernel, m.Dense_1.bias)
        dt = x.dtype
        y = self.Attention_0(manual_layer_norm(x, n1.scale, n1.bias, dt),
                             train, generator,
                             record=scoped(record, "Attention_0"))
        x = x + self.drop_path(y, train, generator)
        y = m(manual_layer_norm(x, n2.scale, n2.bias, dt), train, generator)
        return x + self.drop_path(y, train, generator)


def sincos_pos_embed(n: int, dim: int) -> torch.Tensor:
    """(n, dim) fixed sinusoidal position embedding in float32, with the
    JAX package's `div[: (dim + 1) // 2]` slice for the cosines."""
    position = torch.arange(n, dtype=torch.float32)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32)
                    * (-torch.log(torch.tensor(10000.0)) / dim))
    pe = torch.zeros(n, dim)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div[: (dim + 1) // 2])
    return pe


def token_kernels_default(cfg: Any) -> bool:
    """A model config's `token_kernels` where it is set, else True: the
    serving path through kernels 2 and 3, which JAX takes on its
    accelerator (on its CPU it defaults to False)."""
    v = cfg_get(cfg, "token_kernels", None)
    return True if v is None else bool(v)
