"""Swin Transformer with the medical adaptations (counterpart of
thyroid_tpu/models/vit/swin.py).

The forwards are the ones the JAX package runs with `use_pallas_attention`
on; `WindowAttention` has JAX's branches:

- spatial serving (the block's windows tile its map, no contrast scaling):
  roll → fused LN+QKV (`fused_ln_matmul`) → fused W-MSA + out-projection +
  residual (`fused_swin_block_attention`, the residual being the rolled
  pre-LN stream) → roll back → fused LN+MLP+residual
  (`fused_ln_mlp_residual`). With `quality_guided` the projection leaves
  the kernel: `fused_swin_attention`, the quality gate, the projection.
  With `ln_kernel` (set on the module only, as in JAX) LN + QKV + W-MSA
  run in one kernel (`fused_swin_ln_attention`).
- spatial training: LayerNorm → QKV matmul (or `fused_ln_matmul` under
  `train_token_kernels`) → `fused_swin_attention` (forward and backward
  kernels) → out-projection → roll back → shortcut + DropPath; then
  LayerNorm → MLP with exact GELU and dropout → residual + DropPath (or
  `fused_ln_mlp` under `train_token_kernels` when `drop_rate` is 0).
- non-spatial, on windows (B·nW, N, C): taken with `contrast_adaptive`
  (the per-head `contrast_scale` edits the scores between bias and
  softmax), with window padding (the map is layer-normed first, then
  zero-padded right and bottom to window multiples; in an unshifted block
  the pad tokens are not masked, as in JAX), and in training with
  attention dropout. The QKV product and q·scale in the model dtype, the
  scores in float32 plus bias and mask, softmax in float32, attention
  dropout, attn·v accumulated in float32: plain PyTorch, as it is XLA in
  JAX. Serving still takes the fused LN+MLP kernel.

PatchMerging's quality-aware weights (4C → C → 4, softmax) scale the four
neighbours; its norm + reduction run through `fused_ln_matmul` when
serving, plain in training. The patch-embed convolution, `patch_norm`,
`ape`, the dropouts, the final norm, the mean pool, the float32 head and
the uncertainty head are plain PyTorch in both, as they are XLA ops in
JAX. `medical_adaptations` turns on contrast scaling, quality gating, the
quality-aware merge and the uncertainty head; `forward(...,
return_uncertainty=True)` returns (logits, uncertainty) where the model
has the head.

Parameters are float32 and named as in the JAX tree; the stream runs in
the model dtype (float32 or bfloat16). As in JAX, `build_swin` does not
read `train_token_kernels` or `ln_kernel`: they are set on the modules,
`SwinTransformer(**swin_arguments(cfg), train_token_kernels=True)` (JAX:
`create_model(cfg).clone(train_token_kernels=True)`). Unless a config sets
`use_pallas_attention: false`, the port computes JAX's fused-path math
(JAX's default on its accelerator); with false every block and merge
takes the plain path, no kernel, as JAX's flag does (JAX's analysis
scripts set it, so that autograd runs through the forward).
`use_checkpoint: true` runs each block under
`torch.utils.checkpoint.checkpoint` in training (JAX's `nn.remat`): the
block's forward runs again in the backward, with the DropPath and dropout
generator set back to the state it had, so the draws and the gradients are
those of the step without it. `attn_softmax_dtype: bf16` takes the plain
attention's scores as JAX's `preferred_element_type=bf16`: q·kᵀ rounded to
bfloat16, the bias and mask added and the softmax taken in bfloat16 (the
fused kernels do not read it, as JAX's do not).

`forward(..., capture=True)` returns (output, intermediates), JAX's sown
tensors: each block's window attention after the contrast scaling
("stage_{i}/block_{j}/attn/attention", (B·nW, heads, n, n)), each stage's
tokens before its merge ("stage_{i}/stage_features"), the tokens after the
final norm ("final_tokens") and, with the uncertainty head, its output
("uncertainty"). A capture forward runs no kernel: the windows attention
and the MLP take the plain path as in JAX, and so does the merge, which
JAX with `use_pallas_attention` would still run fused.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn
from torch.nn import functional as F

from ...ops.attention import (fused_swin_attention, fused_swin_block_attention,
                              fused_swin_ln_attention)
# re-exported under the JAX module's names
from ...ops.attention import window_partition, window_reverse  # noqa: F401
from ...ops.token_fused import (fused_ln_matmul, fused_ln_mlp,
                                fused_ln_mlp_residual)
from ..layers import (HWIO_TO_OIHW, DenseParams, DropPath, LecunDense,
                      LNParams, MlpParams, Record, captured, conv_layer, dense,
                      dense_layer, dropout, manual_layer_norm, recorder,
                      scoped, trunc_normal_)
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


class WindowAttention(nn.Module):
    """W-MSA with relative-position bias and the medical adaptations
    (per-head contrast scaling of the scores, quality gate before the
    projection). The forward takes JAX's branches; the stream's dtype is
    the model dtype."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 attn_drop_rate: float = 0.0, proj_drop_rate: float = 0.0,
                 contrast_adaptive: bool = False, quality_guided: bool = False,
                 train_token_kernels: bool = False, ln_kernel: bool = False,
                 softmax_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ws, self.num_heads = window_size, num_heads
        self.softmax_dtype = softmax_dtype
        self.scale = float(qk_scale or (dim // num_heads) ** -0.5)
        self.attn_drop_rate = float(attn_drop_rate)
        self.proj_drop_rate = float(proj_drop_rate)
        self.contrast_adaptive = contrast_adaptive
        self.quality_guided = quality_guided
        self.train_token_kernels = train_token_kernels
        self.ln_kernel = ln_kernel
        self.qkv = DenseParams(dim, 3 * dim, qkv_bias)
        self.relative_position_bias_table = nn.Parameter(
            torch.empty((2 * window_size - 1) ** 2, num_heads))
        if contrast_adaptive:
            self.contrast_scale = nn.Parameter(torch.ones(num_heads))
        if quality_guided:
            self.quality_gate_1 = LecunDense(dim, dim // 4)
            self.quality_gate_2 = LecunDense(dim // 4, 1)
        self.proj = DenseParams(dim, dim)
        self.register_buffer("rel_index", torch.from_numpy(
            relative_position_index(window_size).reshape(-1).astype(np.int64)),
            persistent=False)

    def bias_hnn(self) -> torch.Tensor:
        """The relative-position bias gathered to (heads, N, N) float32;
        autograd scatters its gradient back into the table."""
        n = self.ws * self.ws
        return self.relative_position_bias_table[self.rel_index] \
            .reshape(n, n, self.num_heads).permute(2, 0, 1).float().contiguous()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False, generator: Optional[torch.Generator] = None,
                spatial: bool = False,
                ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                fuse_residual: bool = False,
                record: Record = None) -> torch.Tensor:
        """`spatial`: x (B, H, W, C) the rolled stream, layer-normed here
        with `ln` = (scale, bias) → (B, H, W, C); with `fuse_residual` (and
        no quality gate) the half-block's residual stream x + proj(attn).
        Otherwise x (B·nW, N, C) windows, already normed → (B·nW, N, C).
        `mask` (nW, N, N) or None; `train` takes dropout's draws from
        `generator`; `record` (windows only) takes the softmax as
        "attention"."""
        dt = x.dtype
        bias = self.bias_hnn()
        kw = dict(window_size=self.ws, num_heads=self.num_heads,
                  scale=self.scale)
        if spatial:
            b, hh, ww, c = x.shape
            serving = ln is not None and not train
            if self.ln_kernel and serving:
                out = fused_swin_ln_attention(
                    x, ln[0], ln[1], self.qkv.kernel, self.qkv.bias, bias,
                    mask, **kw).to(dt)
                return self._output_proj(out, train, generator)
            if serving:
                qkv = fused_ln_matmul(x, ln[0], ln[1], self.qkv.kernel,
                                      self.qkv.bias).reshape(b, hh, ww, 3, c)
                if fuse_residual and not self.quality_guided:
                    return fused_swin_block_attention(
                        qkv, x, self.proj.kernel, self.proj.bias, bias, mask,
                        **kw).to(dt)
            elif self.train_token_kernels and ln is not None:
                qkv = fused_ln_matmul(x.to(dt).contiguous(), ln[0], ln[1],
                                      self.qkv.kernel, self.qkv.bias)
            else:
                xn = manual_layer_norm(x, ln[0], ln[1], dt) \
                    if ln is not None else x
                qkv = dense(xn, self.qkv.kernel, self.qkv.bias, dt)
            out = fused_swin_attention(qkv.reshape(b, hh, ww, 3, c), bias,
                                       mask, **kw).to(dt)
            return self._output_proj(out, train, generator)

        b_, n, c = x.shape
        heads = self.num_heads
        qkv = dense(x, self.qkv.kernel, self.qkv.bias, dt)
        q, k, v = qkv.reshape(b_, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        # q·scale in the model dtype, the scale rounded to it as JAX's
        # weakly typed constant is
        q = q * torch.tensor(self.scale, dtype=dt)
        # the scores in softmax_dtype (JAX's preferred_element_type): a
        # float32 product, rounded once; bias and mask added in that dtype
        sdt = self.softmax_dtype
        attn = (q.float() @ k.float().transpose(-1, -2)).to(sdt) \
            + bias[None].to(sdt)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b_ // nw, nw, heads, n, n)
                    + mask[None, :, None].to(sdt)).reshape(b_, heads, n, n)
        if self.contrast_adaptive:
            attn = attn * self.contrast_scale.float().reshape(1, -1, 1, 1)
        if attn.dtype == torch.float32:
            attn = torch.softmax(attn, dim=-1)
        else:  # jax.nn.softmax written out, each step rounded to bfloat16
            e = torch.exp(attn - attn.amax(dim=-1, keepdim=True))
            attn = e / e.sum(dim=-1, keepdim=True)
        attn = attn.to(dt)
        if record is not None:
            record("attention", attn)
        attn = dropout(attn, self.attn_drop_rate, train, generator)
        out = (attn.float() @ v.float()).to(dt)
        out = out.transpose(1, 2).reshape(b_, n, c)
        return self._output_proj(out, train, generator)

    def _output_proj(self, out: torch.Tensor, train: bool,
                     generator: Optional[torch.Generator]) -> torch.Tensor:
        dt = out.dtype
        if self.quality_guided:
            g = F.relu(dense_layer(out, self.quality_gate_1, dt))
            g = dense_layer(g, self.quality_gate_2, dt)
            out = out * torch.sigmoid(g)
        out = dense_layer(out, self.proj, dt)
        return dropout(out, self.proj_drop_rate, train, generator)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int],
                 num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.0, drop_path_rate: float = 0.0,
                 contrast_adaptive: bool = False, quality_guided: bool = False,
                 train_token_kernels: bool = False, kernels: bool = True,
                 softmax_dtype: torch.dtype = torch.float32):
        super().__init__()
        h, w = input_resolution
        ws, shift = window_size, shift_size
        if min(h, w) <= ws:            # window covers the map → no shift
            ws, shift = min(h, w), 0
        # right and bottom zero pad to window multiples (after norm1)
        self.pad = ((-h) % ws, (-w) % ws)
        self.padded = self.pad != (0, 0)
        self.resolution = (h, w)
        self.ws, self.shift = ws, shift
        self.drop_rate = float(drop_rate)
        self.train_token_kernels = train_token_kernels
        self.kernels = kernels
        self.norm1 = LNParams(dim)
        self.attn = WindowAttention(
            dim, ws, num_heads, qkv_bias, qk_scale, attn_drop_rate, drop_rate,
            contrast_adaptive=contrast_adaptive, quality_guided=quality_guided,
            train_token_kernels=train_token_kernels, softmax_dtype=softmax_dtype)
        self.norm2 = LNParams(dim)
        self.mlp = MlpParams(dim, int(dim * mlp_ratio))
        self.drop_path = DropPath(drop_path_rate)
        mask = shift_attention_mask(h + self.pad[0], w + self.pad[1], ws, shift)
        self.register_buffer(
            "attn_mask", torch.from_numpy(mask) if mask is not None else None,
            persistent=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                record: Record = None) -> torch.Tensor:
        """x (B, L, C) in the model dtype; `train` takes the training
        forward, whose DropPath and dropout draws come from `generator`.
        Without `kernels`, or with a `record` (a capture forward), the
        plain path: windows attention and the MLP in plain PyTorch."""
        b, l, c = x.shape
        h, w = self.resolution
        ws, shift = self.ws, self.shift
        dt = x.dtype
        a = self.attn
        shortcut = x
        xs = x.reshape(b, h, w, c)
        if self.padded:
            # LN first, so that the pad tokens are exact zeros after the norm
            xs = manual_layer_norm(xs, self.norm1.scale, self.norm1.bias, dt)
            xs = F.pad(xs, (0, 0, 0, self.pad[1], 0, self.pad[0]))
        if shift > 0:
            xs = torch.roll(xs, shifts=(-shift, -shift), dims=(1, 2))
        plain = record is not None or not self.kernels
        # the fused spatial kernels take neither the contrast scaling nor
        # padding, nor attention dropout in training
        fused = not plain and not a.contrast_adaptive and not self.padded \
            and (not train or a.attn_drop_rate == 0.0)
        # serving: proj + residual ride the attention kernel's epilogue
        proj_fused = fused and not train and not a.quality_guided
        if fused:
            xs = a(xs.contiguous(), self.attn_mask, train, generator,
                   spatial=True, ln=(self.norm1.scale, self.norm1.bias),
                   fuse_residual=proj_fused)
        else:
            xn = xs if self.padded else manual_layer_norm(
                xs, self.norm1.scale, self.norm1.bias, dt)
            hp, wp = xs.shape[1:3]
            xs = window_reverse(a(window_partition(xn, ws), self.attn_mask,
                                  train, generator,
                                  record=scoped(record, "attn")), ws, hp, wp)
        if shift > 0:
            xs = torch.roll(xs, shifts=(shift, shift), dims=(1, 2))
        if self.padded:
            xs = xs[:, :h, :w]
        x = xs.reshape(b, l, c)
        if not proj_fused:
            x = shortcut + self.drop_path(x, train, generator)
        m = self.mlp
        if not train and not plain:
            return fused_ln_mlp_residual(
                x.contiguous(), self.norm2.scale, self.norm2.bias,
                m.Dense_0.kernel, m.Dense_0.bias, m.Dense_1.kernel, m.Dense_1.bias)
        if train and not plain and self.train_token_kernels \
                and self.drop_rate == 0.0:
            y = fused_ln_mlp(x.contiguous(), self.norm2.scale, self.norm2.bias,
                             m.Dense_0.kernel, m.Dense_0.bias,
                             m.Dense_1.kernel, m.Dense_1.bias)
            return x + self.drop_path(y, True, generator)
        y = manual_layer_norm(x, self.norm2.scale, self.norm2.bias, dt)
        y = F.gelu(dense(y, m.Dense_0.kernel, m.Dense_0.bias, dt))
        y = dropout(y, self.drop_rate, train, generator)
        y = dense(y, m.Dense_1.kernel, m.Dense_1.bias, dt)
        y = dropout(y, self.drop_rate, train, generator)
        return x + self.drop_path(y, train, generator)


class PatchMerging(nn.Module):
    """2×2 patch merge, 4C → 2C, with optional quality weights on the four
    neighbours; norm + reduction in one fused kernel when serving,
    LayerNorm and a plain matmul in training and on the plain path."""

    def __init__(self, input_resolution: Tuple[int, int], dim: int,
                 quality_aware: bool = False):
        super().__init__()
        self.resolution = input_resolution
        self.quality_aware = quality_aware
        if quality_aware:
            self.quality_weight_1 = LecunDense(4 * dim, dim)
            self.quality_weight_2 = LecunDense(dim, 4)
        self.norm = LNParams(4 * dim)
        self.reduction = DenseParams(4 * dim, 2 * dim, use_bias=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                plain: bool = False) -> torch.Tensor:
        h, w = self.resolution
        b, _, c = x.shape
        dt = x.dtype
        x = x.reshape(b, h, w, c)
        merged = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                            x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        merged = merged.reshape(b, -1, 4 * c)
        if self.quality_aware:
            qw = F.relu(dense_layer(merged, self.quality_weight_1, dt))
            qw = dense_layer(qw, self.quality_weight_2, dt)
            # softmax in the model dtype, as flax writes it out
            e = torch.exp(qw - qw.amax(dim=-1, keepdim=True))
            qw = e / e.sum(dim=-1, keepdim=True)
            merged = (merged.reshape(b, -1, 4, c) * (4.0 * qw[..., None])) \
                .reshape(b, -1, 4 * c)
        merged = merged.contiguous()
        if train or plain:
            normed = manual_layer_norm(merged, self.norm.scale, self.norm.bias, dt)
            return dense(normed, self.reduction.kernel, None, dt)
        return fused_ln_matmul(merged, self.norm.scale, self.norm.bias,
                               self.reduction.kernel, None)


class PatchEmbed(nn.Conv2d):
    """The patch-embed convolution: PyTorch's `weight` (OIHW) and `bias`;
    the JAX leaf `kernel` is its HWIO kernel."""

    jax_layout = {"kernel": ("weight", HWIO_TO_OIHW)}


def checkpointed(block: nn.Module, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """block(x, train=True) under torch.utils.checkpoint (JAX's nn.remat):
    its activations are dropped and the forward runs again in the
    backward. checkpoint restores the global RNGs only, so the recompute
    sets `generator` back to its state before the first run, and restores
    it after, and draws the same DropPath and dropout masks."""
    state = generator.get_state() if generator is not None else None
    first = [True]

    def run(x):
        if first[0] or generator is None:
            first[0] = False
            return block(x, True, generator)
        after = generator.get_state()
        generator.set_state(state)
        try:
            return block(x, True, generator)
        finally:
            generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)


class SwinStage(nn.Module):
    def __init__(self, dim: int, input_resolution: Tuple[int, int], depth: int,
                 num_heads: int, window_size: int, mlp_ratio: float,
                 qkv_bias: bool, qk_scale: Optional[float], downsample: bool,
                 drop_path_rates: Sequence[float] = (),
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 contrast_adaptive: bool = False, quality_guided: bool = False,
                 quality_aware_merge: bool = False,
                 train_token_kernels: bool = False, kernels: bool = True,
                 softmax_dtype: torch.dtype = torch.float32,
                 use_checkpoint: bool = False):
        super().__init__()
        self.depth = depth
        self.kernels = kernels
        self.use_checkpoint = use_checkpoint
        rates = tuple(drop_path_rates) or (0.0,) * depth
        for i in range(depth):
            self.add_module(f"block_{i}", SwinBlock(
                dim, input_resolution, num_heads, window_size,
                shift_size=0 if i % 2 == 0 else window_size // 2,
                mlp_ratio=mlp_ratio, qkv_bias=qkv_bias, qk_scale=qk_scale,
                drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                drop_path_rate=float(rates[i]),
                contrast_adaptive=contrast_adaptive,
                quality_guided=quality_guided,
                train_token_kernels=train_token_kernels, kernels=kernels,
                softmax_dtype=softmax_dtype))
        self.downsample = PatchMerging(input_resolution, dim,
                                       quality_aware=quality_aware_merge) \
            if downsample else None

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None,
                record: Record = None) -> torch.Tensor:
        for i in range(self.depth):
            block = getattr(self, f"block_{i}")
            if self.use_checkpoint and train and torch.is_grad_enabled():
                x = checkpointed(block, x, generator)
            else:
                x = block(x, train, generator,
                          record=scoped(record, f"block_{i}"))
        if record is not None:
            record("stage_features", x)
        if self.downsample is not None:
            x = self.downsample(x, train,
                                plain=record is not None or not self.kernels)
        return x


class SwinTransformer(nn.Module):
    def __init__(self, img_size: int = 224, patch_size: int = 4,
                 in_channels: int = 1, num_classes: int = 2,
                 embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.2, ape: bool = False,
                 patch_norm: bool = True, medical_adaptations: bool = False,
                 contrast_adaptive: bool = False, quality_guided: bool = False,
                 uncertainty_head: bool = False,
                 train_token_kernels: bool = False, kernels: bool = True,
                 softmax_dtype: torch.dtype = torch.float32,
                 use_checkpoint: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if img_size % patch_size:
            raise ValueError(f"img_size {img_size} is not a multiple of "
                             f"patch_size {patch_size}")
        self.img_size, self.in_channels = img_size, in_channels
        self.patch_size, self.embed_dim = patch_size, embed_dim
        self.drop_rate = float(drop_rate)
        self.dtype = dtype
        self.train_token_kernels = train_token_kernels
        self.num_layers = len(depths)
        res = img_size // patch_size
        # stochastic-depth rate of each block, rising linearly over the net
        dpr = np.linspace(0.0, drop_path_rate, sum(depths))
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch_size,
                                      stride=patch_size)
        self.patch_norm = LNParams(embed_dim) if patch_norm else None
        self.absolute_pos_embed = nn.Parameter(
            torch.empty(1, res * res, embed_dim)) if ape else None
        for i in range(self.num_layers):
            self.add_module(f"stage_{i}", SwinStage(
                dim=int(embed_dim * 2 ** i),
                input_resolution=(res // 2 ** i, res // 2 ** i),
                depth=depths[i], num_heads=num_heads[i],
                window_size=window_size, mlp_ratio=mlp_ratio,
                qkv_bias=qkv_bias, qk_scale=qk_scale,
                downsample=i < self.num_layers - 1,
                drop_path_rates=dpr[sum(depths[:i]):sum(depths[:i + 1])],
                drop_rate=drop_rate, attn_drop_rate=attn_drop_rate,
                contrast_adaptive=contrast_adaptive or medical_adaptations,
                quality_guided=quality_guided or medical_adaptations,
                quality_aware_merge=medical_adaptations,
                train_token_kernels=train_token_kernels, kernels=kernels,
                softmax_dtype=softmax_dtype, use_checkpoint=use_checkpoint))
        feat = int(embed_dim * 2 ** (self.num_layers - 1))
        self.norm = LNParams(feat)
        self.head = DenseParams(feat, num_classes)
        if medical_adaptations or uncertainty_head:
            self.uncertainty_1 = LecunDense(feat, feat // 2)
            self.uncertainty_2 = LecunDense(feat // 2, num_classes)
        else:
            self.uncertainty_1 = self.uncertainty_2 = None

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator`: the JAX package's initialisers
        (truncated normal σ 0.02 for kernels, bias tables and the absolute
        position embedding, flax's lecun_normal for the quality and
        uncertainty Dense layers, zero biases, unit LayerNorm and contrast
        scales)."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, DenseParams):
                    mod.init_(generator)
                elif isinstance(mod, WindowAttention):
                    trunc_normal_(mod.relative_position_bias_table, generator)
            trunc_normal_(self.patch_embed.weight, generator)
            self.patch_embed.bias.zero_()
            if self.absolute_pos_embed is not None:
                trunc_normal_(self.absolute_pos_embed, generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                capture: bool = False,
                generator: Optional[torch.Generator] = None,
                return_uncertainty: bool = False):
        """x (B, S, S, in_channels) NHWC → (B, num_classes) float32 logits;
        with `return_uncertainty`, (logits, uncertainty) where the model has
        the uncertainty head; with `capture`, (that, intermediates).
        `train` takes the training forward, whose DropPath and dropout
        draws come from `generator` (on x's device)."""
        recorded, record = recorder(capture)
        b = x.shape[0]
        dt = self.dtype
        x = conv_layer(x, self.patch_embed.weight, self.patch_embed.bias, dt,
                       stride=self.patch_size).reshape(b, -1, self.embed_dim)
        if self.patch_norm is not None:
            x = manual_layer_norm(x, self.patch_norm.scale, self.patch_norm.bias, dt)
        if self.absolute_pos_embed is not None:
            x = x + self.absolute_pos_embed.to(dt)
        x = dropout(x, self.drop_rate, train, generator)
        for i in range(self.num_layers):
            x = getattr(self, f"stage_{i}")(x, train, generator,
                                            record=scoped(record, f"stage_{i}"))
        x = manual_layer_norm(x, self.norm.scale, self.norm.bias, dt)
        if record is not None:
            record("final_tokens", x)
        feat = x.mean(dim=1)
        logits = dense_layer(feat, self.head, torch.float32)
        if self.uncertainty_1 is None or not (return_uncertainty or capture):
            return captured(logits, recorded)
        u = F.relu(dense_layer(feat, self.uncertainty_1, dt))
        u = dropout(u, 0.1, train, generator)
        u = dense_layer(u, self.uncertainty_2, torch.float32)
        if record is not None:
            record("uncertainty", u)
        return captured((logits, u) if return_uncertainty else logits,
                        recorded)


SWIN_PARAMS = {
    # name: (embed_dim, depths, num_heads, drop_path, img_size)
    "swin_tiny": (96, (2, 2, 6, 2), (3, 6, 12, 24), 0.2, 224),
    "swin_small": (96, (2, 2, 18, 2), (3, 6, 12, 24), 0.3, 224),
    "swin_base": (128, (2, 2, 18, 2), (4, 8, 16, 32), 0.5, 224),
    "swin_large": (192, (2, 2, 18, 2), (6, 12, 24, 48), 0.5, 224),
    "swin_medical": (96, (2, 2, 18, 2), (3, 6, 12, 24), 0.25, 256),
}


def swin_arguments(cfg: Any) -> Dict[str, Any]:
    """The SwinTransformer arguments of a model config, every key JAX's
    build_swin reads (not `train_token_kernels`, which it ignores too).
    `use_pallas_attention` false builds the model without kernels (unset,
    with them); `use_checkpoint` checkpoints each block in training;
    `attn_softmax_dtype` bf16 (or bfloat16) takes the plain attention's
    scores in bfloat16."""
    name = cfg_get(cfg, "name", "swin_tiny")
    dim, depths, heads, dpr, img = SWIN_PARAMS.get(
        name, (96, (2, 2, 6, 2), (3, 6, 12, 24), 0.2, 224))
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
        drop_rate=float(cfg_get(cfg, "drop_rate", 0.0)),
        attn_drop_rate=float(cfg_get(cfg, "attn_drop_rate", 0.0)),
        drop_path_rate=float(cfg_get(cfg, "drop_path_rate", dpr)),
        ape=bool(cfg_get(cfg, "ape", False)),
        patch_norm=bool(cfg_get(cfg, "patch_norm", True)),
        medical_adaptations=bool(cfg_get(cfg, "medical_adaptations",
                                         name == "swin_medical")),
        contrast_adaptive=bool(cfg_get(cfg, "contrast_adaptive", False)),
        quality_guided=bool(cfg_get(cfg, "quality_guided", False)),
        uncertainty_head=bool(cfg_get(cfg, "uncertainty_head", False)),
        kernels=bool(cfg_get(cfg, "use_pallas_attention", True)),
        softmax_dtype=(torch.bfloat16 if cfg_get(cfg, "attn_softmax_dtype", None)
                       in ("bf16", "bfloat16") else torch.float32),
        use_checkpoint=bool(cfg_get(cfg, "use_checkpoint", False)),
        dtype=resolve_dtype(cfg),
    )


def build_swin(cfg: Any) -> SwinTransformer:
    return SwinTransformer(**swin_arguments(cfg))


for _name in SWIN_PARAMS:
    ModelRegistry.register(_name, "vit")(build_swin)
