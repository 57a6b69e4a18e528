"""Swin Transformer (counterpart of thyroid_tpu/models/vit/swin.py).

Two forwards, the ones the JAX package runs with `use_pallas_attention` on:

- serving (`train=False`, `deterministic=True` in JAX): per block, roll →
  fused LN+QKV (`fused_ln_matmul`) → fused W-MSA + out-projection +
  residual (`fused_swin_block_attention`, the residual being the rolled
  pre-LN stream) → roll back → fused LN+MLP+residual
  (`fused_ln_mlp_residual`); PatchMerging's norm + reduction through
  `fused_ln_matmul` without bias. The half-block attention kernel has no
  backward.
- training (`train=True`): per block, roll → LayerNorm → QKV matmul →
  `fused_swin_attention` (forward and backward kernels) → out-projection →
  roll back → shortcut + DropPath; then LayerNorm → MLP with exact GELU →
  residual + DropPath; PatchMerging's LayerNorm and reduction as plain
  matmuls. Everything but the attention is plain PyTorch, as it is XLA in
  JAX; dense layers cast their float32 parameters to the model dtype.
  With `train_token_kernels` (off by default, as in JAX) norm1 + QKV run
  through `fused_ln_matmul` and norm2 + MLP through `fused_ln_mlp`, both
  under autograd with their backward kernels; PatchMerging stays plain.

The patch-embed convolution, `patch_norm`, the final norm, the mean pool
and the float32 head are plain PyTorch in both, as they are XLA ops in JAX.

Parameters are float32 and named as in the JAX tree; the stream runs in
the model dtype (float32 or bfloat16). Options of the JAX model that this
forward does not serve raise NotImplementedError. As in JAX, `build_swin`
does not read `train_token_kernels`: the flag is set on the module itself,
`SwinTransformer(**swin_arguments(cfg), train_token_kernels=True)` (JAX:
`create_model(cfg).clone(train_token_kernels=True)`).
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...ops.attention import fused_swin_attention, fused_swin_block_attention
# re-exported under the JAX module's names
from ...ops.attention import window_partition, window_reverse  # noqa: F401
from ...ops.token_fused import (fused_ln_matmul, fused_ln_mlp,
                                fused_ln_mlp_residual)
from ..layers import (HWIO_TO_OIHW, LN_EPS, DenseParams, DropPath, LNParams,
                      MlpParams, trunc_normal_)
from ..registry import ModelRegistry, cfg_get, resolve_dtype


@lru_cache(maxsize=None)
def relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2ws−1)² bias table (standard Swin scheme)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


@lru_cache(maxsize=None)
def shift_attention_mask(h: int, w: int, ws: int, shift: int) -> Optional[np.ndarray]:
    """(nW, ws², ws²) additive mask (0 / −100) for shifted windows; None
    when shift == 0."""
    if shift == 0:
        return None
    img_mask = np.zeros((1, h, w, 1))
    h_slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    w_slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    cnt = 0
    for hs in h_slices:
        for wsl in w_slices:
            img_mask[:, hs, wsl, :] = cnt
            cnt += 1
    mask_windows = img_mask.reshape(1, h // ws, ws, w // ws, ws, 1)
    mask_windows = mask_windows.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


def manual_layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      dtype: torch.dtype, eps: float = LN_EPS) -> torch.Tensor:
    """flax LayerNorm numerics: float32 statistics, fast variance
    E[x²]−μ² clamped at 0, the result in `dtype`."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((xf - mu) * mul + bias.float()).to(dtype)


class WindowAttention(nn.Module):
    """W-MSA parameters: qkv, the relative-position bias table, proj."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True):
        super().__init__()
        self.qkv = DenseParams(dim, 3 * dim, qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        self.proj = DenseParams(dim, dim)


def dense(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
          dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype) numerics from raw parameters: input and
    parameters cast to `dtype`, the product and the bias add in `dtype`."""
    y = x.to(dtype) @ kernel.to(dtype)
    return y + bias.to(dtype) if bias is not None else y


class SwinBlock(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None,
                 drop_path_rate: float = 0.0,
                 train_token_kernels: bool = False):
        super().__init__()
        h, w = input_resolution
        ws, shift = window_size, shift_size
        if min(h, w) <= ws:            # window covers the map → no shift
            ws, shift = min(h, w), 0
        if h % ws or w % ws:
            raise NotImplementedError(
                f"window padding ({h}x{w} map, window {ws}) is not ported "
                "(ROADMAP Queue 1: Swin options)")
        self.resolution = (h, w)
        self.ws, self.shift = ws, shift
        self.num_heads = num_heads
        self.scale = float(qk_scale or (dim // num_heads) ** -0.5)
        self.norm1 = LNParams(dim)
        self.attn = WindowAttention(dim, ws, num_heads, qkv_bias)
        self.norm2 = LNParams(dim)
        self.mlp = MlpParams(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)
        self.train_token_kernels = train_token_kernels
        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(ws).reshape(-1).astype(np.int64)),
            persistent=False)
        mask = shift_attention_mask(h, w, ws, shift)
        self.register_buffer(
            "attn_mask", torch.from_numpy(mask) if mask is not None else None,
            persistent=False)

    def _bias_hnn(self) -> torch.Tensor:
        """The relative-position bias gathered to (heads, N, N) float32;
        autograd scatters its gradient back into the table."""
        n = self.ws * self.ws
        return self.attn.relative_position_bias_table[self.rel_index] \
            .reshape(n, n, self.num_heads).permute(2, 0, 1).float().contiguous()

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if train:
            return self._forward_train(x, generator)
        b, l, c = x.shape
        h, w = self.resolution
        ws, shift = self.ws, self.shift
        xs = x.reshape(b, h, w, c)
        if shift > 0:
            xs = torch.roll(xs, shifts=(-shift, -shift), dims=(1, 2))
        xs = xs.contiguous()
        a = self.attn
        qkv = fused_ln_matmul(xs, self.norm1.scale, self.norm1.bias,
                              a.qkv.kernel, a.qkv.bias).reshape(b, h, w, 3, c)
        xs = fused_swin_block_attention(
            qkv, xs, a.proj.kernel, a.proj.bias, self._bias_hnn(),
            self.attn_mask, window_size=ws, num_heads=self.num_heads,
            scale=self.scale)
        if shift > 0:
            xs = torch.roll(xs, shifts=(shift, shift), dims=(1, 2))
        m = self.mlp
        return fused_ln_mlp_residual(
            xs.reshape(b, l, c).contiguous(), self.norm2.scale, self.norm2.bias,
            m.Dense_0.kernel, m.Dense_0.bias, m.Dense_1.kernel, m.Dense_1.bias)

    def _forward_train(self, x: torch.Tensor,
                       generator: Optional[torch.Generator]) -> torch.Tensor:
        """The JAX block's fused training branch (use_pallas, not
        deterministic), x (B, L, C) in the model dtype; with
        train_token_kernels, its opt-in token-kernel variant."""
        b, l, c = x.shape
        h, w = self.resolution
        ws, shift = self.ws, self.shift
        dt = x.dtype
        xs = x.reshape(b, h, w, c)
        if shift > 0:
            xs = torch.roll(xs, shifts=(-shift, -shift), dims=(1, 2))
        a = self.attn
        if self.train_token_kernels:
            qkv = fused_ln_matmul(xs.to(dt).contiguous(), self.norm1.scale,
                                  self.norm1.bias, a.qkv.kernel, a.qkv.bias)
        else:
            xn = manual_layer_norm(xs, self.norm1.scale, self.norm1.bias, dt)
            qkv = dense(xn, a.qkv.kernel, a.qkv.bias, dt)
        qkv = qkv.reshape(b, h, w, 3, c)
        out = fused_swin_attention(
            qkv, self._bias_hnn(), self.attn_mask, window_size=ws,
            num_heads=self.num_heads, scale=self.scale).to(dt)
        out = dense(out, a.proj.kernel, a.proj.bias, dt)
        if shift > 0:
            out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
        x = x + self.drop_path(out.reshape(b, l, c), True, generator)
        m = self.mlp
        if self.train_token_kernels:
            y = fused_ln_mlp(x.contiguous(), self.norm2.scale, self.norm2.bias,
                             m.Dense_0.kernel, m.Dense_0.bias,
                             m.Dense_1.kernel, m.Dense_1.bias)
            return x + self.drop_path(y, True, generator)
        y = manual_layer_norm(x, self.norm2.scale, self.norm2.bias, dt)
        y = F.gelu(dense(y, m.Dense_0.kernel, m.Dense_0.bias, dt))
        y = dense(y, m.Dense_1.kernel, m.Dense_1.bias, dt)
        return x + self.drop_path(y, True, generator)


class PatchMerging(nn.Module):
    """2×2 patch merge, 4C → 2C: norm + reduction in one fused kernel when
    serving, LayerNorm and a plain matmul in training."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int):
        super().__init__()
        self.resolution = input_resolution
        self.norm = LNParams(4 * dim)
        self.reduction = DenseParams(4 * dim, 2 * dim, use_bias=False)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h, w = self.resolution
        b, _, c = x.shape
        x = x.reshape(b, h, w, c)
        merged = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                            x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        merged = merged.reshape(b, -1, 4 * c).contiguous()
        if train:
            normed = manual_layer_norm(merged, self.norm.scale, self.norm.bias,
                                       x.dtype)
            return dense(normed, self.reduction.kernel, None, x.dtype)
        return fused_ln_matmul(merged, self.norm.scale, self.norm.bias,
                               self.reduction.kernel, None)


class PatchEmbed(nn.Conv2d):
    """The patch-embed convolution: PyTorch's `weight` (OIHW) and `bias`;
    the JAX leaf `kernel` is its HWIO kernel."""

    jax_layout = {"kernel": ("weight", HWIO_TO_OIHW)}


class SwinStage(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int], depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float,
                 qkv_bias: bool, qk_scale: Optional[float], downsample: bool,
                 drop_path_rates: Sequence[float] = (),
                 train_token_kernels: bool = False):
        super().__init__()
        self.depth = depth
        rates = tuple(drop_path_rates) or (0.0,) * depth
        for i in range(depth):
            self.add_module(f"block_{i}", SwinBlock(
                dim, input_resolution, num_heads, window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                drop_path_rate=float(rates[i]),
                train_token_kernels=train_token_kernels))
        self.downsample = PatchMerging(input_resolution, dim) \
            if downsample else None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, train, generator)
        if self.downsample is not None:
            x = self.downsample(x, train)
        return x


class SwinTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 4,
                 in_channels: int = 1, num_classes: int = 2,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_path_rate: float = 0.2, patch_norm: bool = True,
                 train_token_kernels: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of "
                             f"patch_size {patch_size}")
        self.img_size, self.in_channels = img_size, in_channels
        self.patch_size, self.embed_dim = patch_size, embed_dim
        self.dtype = dtype
        self.train_token_kernels = train_token_kernels
        self.num_layers = len(depths)
        res = img_size // patch_size
        # stochastic-depth rate of each block, rising linearly over the net
        dpr = np.linspace(0.0, drop_path_rate, sum(depths))
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch_size,
                                      stride=patch_size)
        self.patch_norm = LNParams(embed_dim) if patch_norm else None
        for i in range(self.num_layers):
            self.add_module(f"stage_{i}", SwinStage(
                dim=int(embed_dim * 2 ** i),
                input_resolution=(res // 2 ** i, res // 2 ** i),
                depth=depths[i], num_heads=num_heads[i],
                window_size=window_size, mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, qk_scale=qk_scale,
                downsample=i < self.num_layers - 1,
                drop_path_rates=dpr[sum(depths[:i]):sum(depths[:i + 1])],
                train_token_kernels=train_token_kernels))
        self.norm = LNParams(int(embed_dim * 2 ** (self.num_layers - 1)))
        self.head = DenseParams(self.norm.scale.shape[0], num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator`: the JAX package's initialisers
        (truncated normal σ 0.02 for kernels and bias tables, zero biases,
        unit LayerNorm scales)."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, DenseParams):
                    mod.init_(generator)
                elif isinstance(mod, WindowAttention):
                    trunc_normal_(mod.relative_position_bias_table, generator)
            trunc_normal_(self.patch_embed.weight, generator)
            self.patch_embed.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                capture: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, S, in_channels) NHWC → (B, num_classes) float32 logits.
        `train` takes the training forward, whose DropPath draws come from
        `generator` (on x's device)."""
        if capture:
            raise NotImplementedError(
                "attention capture is not ported (ROADMAP Queue 1: "
                "Analysis)")
        b = x.shape[0]
        dt = self.dtype
        x = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=self.patch_size)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.embed_dim)
        if self.patch_norm is not None:
            x = manual_layer_norm(x, self.patch_norm.scale, self.patch_norm.bias, dt)
        for i in range(self.num_layers):
            x = getattr(self, f"stage_{i}")(x, train, generator)
        x = manual_layer_norm(x, self.norm.scale, self.norm.bias, dt)
        feat = x.mean(dim=1)
        return feat.float() @ self.head.kernel + self.head.bias


SWIN_PARAMS = {
    # name: (embed_dim, depths, num_heads, drop_path, img_size)
    "swin_tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24), 0.2, 224),
    "swin_small": (96, (2, 2, 18, 2), (3, 6, 12, 24), 0.3, 224),
    "swin_base": (128, (2, 2, 18, 2), (4, 8, 16, 32), 0.5, 224),
    "swin_large": (192, (2, 2, 18, 2), (6, 12, 24, 48), 0.5, 224),
    "swin_medical": (96, (2, 2, 18, 2), (3, 6, 12, 24), 0.25, 256),
}

# options of the JAX model this forward does not serve (ROADMAP Queue 1)
_UNPORTED = ("medical_adaptations", "contrast_adaptive", "quality_guided",
             "uncertainty_head", "ape")


def swin_arguments(cfg: Any) -> Dict[str, Any]:
    """The SwinTransformer arguments of a model config, as build_swin reads
    them (not `train_token_kernels`, which JAX's build_swin ignores too)."""
    name = cfg_get(cfg, "name", "swin_tiny")
    dim, depths, heads, dpr, img = SWIN_PARAMS.get(
        name, (96, (2, 2, 6, 2), (3, 6, 12, 24), 0.2, 224))
    on = [k for k in _UNPORTED
          if cfg_get(cfg, k, name == "swin_medical" and k == "medical_adaptations")]
    if on:
        raise NotImplementedError(
            f"Swin options {on} are not ported (ROADMAP Queue 1: Swin options)")
    dropout = [k for k in ("drop_rate", "attn_drop_rate")
               if float(cfg_get(cfg, k, 0.0))]
    if dropout:
        raise NotImplementedError(
            f"Swin {dropout} > 0 is not ported (ROADMAP Queue 1: Swin "
            "options); every Swin config in configs/ sets both to 0")
    return dict(
        img_size=int(cfg_get(cfg, "img_size", img)),
        patch_size=int(cfg_get(cfg, "patch_size", 4)),
        in_channels=int(cfg_get(cfg, "in_channels", 1)),
        num_classes=int(cfg_get(cfg, "num_classes", 2)),
        embed_dim=int(cfg_get(cfg, "embed_dim", dim)),
        depths=tuple(cfg_get(cfg, "depths", depths)),
        num_heads=tuple(cfg_get(cfg, "num_heads", heads)),
        window_size=int(cfg_get(cfg, "window_size", 7)),
        mlp_ratio=float(cfg_get(cfg, "mlp_ratio", 4.0)),
        qkv_bias=bool(cfg_get(cfg, "qkv_bias", True)),
        qk_scale=cfg_get(cfg, "qk_scale", None),
        drop_path_rate=float(cfg_get(cfg, "drop_path_rate", dpr)),
        patch_norm=bool(cfg_get(cfg, "patch_norm", True)),
        dtype=resolve_dtype(cfg),
    )


def build_swin(cfg: Any) -> SwinTransformer:
    return SwinTransformer(**swin_arguments(cfg))


for _name in SWIN_PARAMS:
    ModelRegistry.register(_name, "vit")(build_swin)
