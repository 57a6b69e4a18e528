"""Vision Transformer tiny/small/base (counterpart of
thyroid_tpu/models/vit/vit.py): patch embedding, class token, learnable or
sinusoidal position embedding, pre-norm blocks with linspace drop path,
final LayerNorm, `cls` or `gap` pooling, float32 head.

The blocks are `models/layers.py` `Block`s. With `token_kernels` (the
registry's default unless a config sets it, as JAX's on its accelerator) an
eval forward runs each block through kernels 2 (LN + QKV) and 3 (LN + MLP +
residual); training forwards, and `token_kernels: false`, take the plain
path, as JAX's CPU does. Parameters are float32 and named as in the JAX
tree; the stream runs in the model dtype. `forward(...,
return_patch_quality=True)` returns (logits, patch-quality scores) for a
`quality_aware` model. `forward(..., capture=True)` returns (output,
intermediates): each block's attention probabilities
("block_{i}/Attention_0/attention", (B, heads, N, N)), the tokens after the
final norm ("final_tokens") and, for a `quality_aware` model, the patch
scores ("patch_embed/patch_quality"), which JAX sows on every forward. A
capture forward takes the plain blocks, never kernels 2-3, as JAX's does.
`pool_type` and `class_token` are attributes, as GradCAM's head rule
reads them.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
from torch import nn

from ..layers import (Block, DenseParams, LNParams, PatchEmbed, Record,
                      captured, dense_layer, dropout, manual_layer_norm,
                      recorder, scoped, sincos_pos_embed,
                      token_kernels_default, trunc_normal_)
from ..registry import ModelRegistry, cfg_get, resolve_dtype


class VisionTransformer(nn.Module):
    # tokens ahead of the patches: the class token
    prefix = ("cls_token",)

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_channels: int = 1, num_classes: int = 2,
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, pos_embed_type: str = "learnable",
                 pool_type: str = "cls", class_token: bool = True,
                 quality_aware: bool = False, token_kernels: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.depth = embed_dim, depth
        self.drop_rate = float(drop_rate)
        self.pool_type = pool_type
        self.class_token = class_token
        self.token_kernels = token_kernels
        self.dtype = dtype
        self.patch_embed = PatchEmbed(in_channels, embed_dim, patch_size,
                                      quality_aware)
        self.prefix = self.prefix if class_token else ()
        for name in self.prefix:
            self.register_parameter(name, nn.Parameter(torch.empty(1, 1, embed_dim)))
        seq = (img_size // patch_size) ** 2 + len(self.prefix)
        if pos_embed_type == "learnable":
            self.pos_embed = nn.Parameter(torch.empty(1, seq, embed_dim))
        else:
            self.pos_embed = None
            self.register_buffer("sincos", sincos_pos_embed(seq, embed_dim)[None],
                                 persistent=False)
        dpr = np.linspace(0.0, drop_path_rate, depth)
        for i in range(depth):
            self.add_module(f"block_{i}", Block(
                embed_dim, num_heads, mlp_ratio, qkv_bias, drop_rate,
                attn_drop_rate, float(dpr[i]), token_kernels=token_kernels))
        self.norm = LNParams(embed_dim)
        self.head = DenseParams(embed_dim, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` with the JAX package's
        initialisers: truncated normal σ 0.02 for the patch projection, the
        tokens, the position table and every Dense kernel, lecun_normal for
        the quality convs, zero biases, unit LayerNorm scales."""
        with torch.no_grad():
            self.patch_embed.init_(generator)
            for name in self.prefix:
                trunc_normal_(getattr(self, name), generator)
            if self.pos_embed is not None:
                trunc_normal_(self.pos_embed, generator)
            for mod in self.modules():
                if isinstance(mod, DenseParams):
                    mod.init_(generator)
                elif isinstance(mod, LNParams):
                    mod.scale.fill_(1.0)
                    mod.bias.zero_()

    def encode(self, x: torch.Tensor, train: bool,
               generator: Optional[torch.Generator],
               record: Record = None) -> torch.Tensor:
        """x (B, S, S, C) NHWC → the final-normed tokens (B, seq, D) in the
        model dtype; `record` takes the capture path's tensors."""
        dt = self.dtype
        tokens = self.patch_embed(x, dt)
        b = tokens.shape[0]
        tokens = torch.cat([getattr(self, n).to(dt).expand(b, 1, self.embed_dim)
                            for n in self.prefix] + [tokens], dim=1)
        pe = self.pos_embed if self.pos_embed is not None else self.sincos
        tokens = dropout(tokens + pe.to(dt), self.drop_rate, train, generator)
        for i in range(self.depth):
            tokens = getattr(self, f"block_{i}")(
                tokens, train, generator, record=scoped(record, f"block_{i}"))
        tokens = manual_layer_norm(tokens, self.norm.scale, self.norm.bias, dt)
        if record is not None:
            record("final_tokens", tokens)
            if self.patch_embed.quality_conv1 is not None:
                record("patch_embed/patch_quality",
                       self.patch_embed.scores(x, dt))
        return tokens

    def classify(self, tokens: torch.Tensor, train: bool):
        """The normed tokens → float32 logits."""
        if self.pool_type == "cls" and self.prefix:
            feat = tokens[:, 0]
        else:
            feat = tokens[:, len(self.prefix):].mean(dim=1)
        return dense_layer(feat, self.head, torch.float32)

    def forward(self, x: torch.Tensor, train: bool = False,
                capture: bool = False,
                generator: Optional[torch.Generator] = None,
                return_patch_quality: bool = False):
        """x (B, S, S, in_channels) NHWC → (B, num_classes) float32 logits;
        with `return_patch_quality`, (logits, (B, N) patch-quality scores);
        with `capture`, (that, intermediates). `train` takes the training
        forward, whose DropPath and dropout draws come from `generator` (on
        x's device)."""
        recorded, record = recorder(capture)
        out = self.classify(self.encode(x, train, generator, record), train)
        if return_patch_quality:
            out = out, self.patch_embed.scores(x, self.dtype)
        return captured(out, recorded)


VIT_PARAMS = {
    # name: (embed_dim, depth, num_heads)
    "vit_tiny": (192, 12, 3),
    "vit_small": (384, 12, 6),
    "vit_base": (768, 12, 12),
}


def vit_arguments(cfg: Any, defaults=(None, None, None)) -> dict:
    """The keys JAX's build_vit and build_deit both read."""
    dim, depth, heads = defaults
    return dict(
        img_size=int(cfg_get(cfg, "img_size", 224)),
        patch_size=int(cfg_get(cfg, "patch_size", 16)),
        in_channels=int(cfg_get(cfg, "in_channels", 1)),
        num_classes=int(cfg_get(cfg, "num_classes", 2)),
        embed_dim=int(cfg_get(cfg, "embed_dim", dim or 768)),
        depth=int(cfg_get(cfg, "depth", depth or 12)),
        num_heads=int(cfg_get(cfg, "num_heads", heads or 12)),
        mlp_ratio=float(cfg_get(cfg, "mlp_ratio", 4.0)),
        qkv_bias=bool(cfg_get(cfg, "qkv_bias", True)),
        drop_rate=float(cfg_get(cfg, "drop_rate", 0.0)),
        attn_drop_rate=float(cfg_get(cfg, "attn_drop_rate", 0.0)),
        drop_path_rate=float(cfg_get(cfg, "drop_path_rate", 0.1)),
        quality_aware=bool(cfg_get(cfg, "quality_aware", False)),
        token_kernels=token_kernels_default(cfg),
        dtype=resolve_dtype(cfg),
    )


def build_vit(cfg: Any) -> VisionTransformer:
    name = cfg_get(cfg, "name", "vit_base")
    return VisionTransformer(
        pos_embed_type=str(cfg_get(cfg, "pos_embed_type", "learnable")),
        pool_type=str(cfg_get(cfg, "pool_type", "cls")),
        **vit_arguments(cfg, VIT_PARAMS.get(name, (None, None, None))))


for _name in VIT_PARAMS:
    ModelRegistry.register(_name, "vit")(build_vit)


def create_vit_tiny(**kw) -> VisionTransformer:
    return build_vit({"name": "vit_tiny", **kw})


def create_vit_small(**kw) -> VisionTransformer:
    return build_vit({"name": "vit_small", **kw})


def create_vit_base(**kw) -> VisionTransformer:
    return build_vit({"name": "vit_base", **kw})
