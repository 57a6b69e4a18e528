"""DeiT tiny/small/base (counterpart of thyroid_tpu/models/vit/deit.py): the
ViT stack with a distillation token beside the class token and a second
head on it. A training forward returns (cls_logits, dist_logits), which the
Trainer's "deit" loss mode weighs 0.5 / 0.5; an eval forward returns their
mean. The position table is always learnable and pooling always reads the
tokens, as in JAX. The capture path is ViT's. Like JAX's DeiT it has no
`pool_type` or `class_token` attribute, so GradCAM's head rule
(analysis/gradcam.py `_apply_head`) applies `head` to the mean of all
tokens, the class and distillation tokens included.
"""
from __future__ import annotations

from typing import Any

import torch

from ..layers import DenseParams, dense_layer
from ..registry import ModelRegistry, cfg_get
from .vit import VisionTransformer, vit_arguments


class DeiT(VisionTransformer):
    prefix = ("cls_token", "dist_token")

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_channels: int = 1, num_classes: int = 2,
                 embed_dim: int = 192, depth: int = 12, num_heads: int = 3,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.1, quality_aware: bool = False,
                 token_kernels: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(img_size, patch_size, in_channels, num_classes,
                         embed_dim, depth, num_heads, mlp_ratio, qkv_bias,
                         drop_rate, attn_drop_rate, drop_path_rate,
                         quality_aware=quality_aware,
                         token_kernels=token_kernels, dtype=dtype)
        self.head_dist = DenseParams(embed_dim, num_classes)
        # neither attribute exists on JAX's DeiT; GradCAM reads their absence
        del self.pool_type, self.class_token

    def classify(self, tokens: torch.Tensor, train: bool):
        """(cls_logits, dist_logits) in training, their mean at eval;
        float32."""
        cls = dense_layer(tokens[:, 0], self.head, torch.float32)
        dist = dense_layer(tokens[:, 1], self.head_dist, torch.float32)
        if train:
            return cls, dist
        return (cls + dist) / 2.0


DEIT_PARAMS = {
    "deit_tiny": (192, 12, 3),
    "deit_small": (384, 12, 6),
    "deit_base": (768, 12, 12),
}


def build_deit(cfg: Any) -> DeiT:
    name = cfg_get(cfg, "name", "deit_tiny")
    return DeiT(**vit_arguments(cfg, DEIT_PARAMS.get(name, (192, 12, 3))))


for _name in DEIT_PARAMS:
    ModelRegistry.register(_name, "vit")(build_deit)
