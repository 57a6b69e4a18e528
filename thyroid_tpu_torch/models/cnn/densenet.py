"""DenseNet 121/161/169/201 (counterpart of thyroid_tpu/models/cnn/densenet.py),
NHWC.

Each dense layer is BatchNorm → ReLU → 1×1 conv → BatchNorm → ReLU → 3×3
conv (→ dropout), concatenated onto its input along the channels; a
transition is BatchNorm → ReLU → 1×1 conv → 2×2 average pool. The 7×7
stem and the 3×3 convolutions go to `F.conv2d` as channels-last NCHW views
(cuDNN on the card), the 1×1 convolutions are matmuls over the channel
axis (efficientnet.conv_nhwc, pointwise). Convolutions cast to the model
dtype as flax's nn.Conv(dtype=…); BatchNorm is flax's, written out in
float32 (layers.BatchNorm, momentum 0.9, eps 1e-5); the 3×3 stride-2 max
pool pads with −inf; the global mean runs in the model dtype and the
classifier in float32.

Parameters are float32 and named as in the JAX tree: `conv0`, `norm0`,
`denseblock{i}_layer{j}` (each `BatchNorm_{0,1}`, `Conv_{0,1}`),
`transition{i}` (`BatchNorm_0`, `Conv_0`), `norm_final`, `classifier`.
`forward(x, capture=True)` returns (logits, {"features": the map after
`norm_final` and ReLU}), the tensor JAX sows for GradCAM.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (BatchNorm, ConvParams, DenseParams, captured, dropout,
                      lecun_normal_)
from ..registry import ModelRegistry, cfg_get, resolve_dtype
from .efficientnet import conv_nhwc, pointwise


class DenseLayer(nn.Module):
    def __init__(self, in_features: int, growth_rate: int, bn_size: int = 4,
                 dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_0 = ConvParams(in_features, bn_size * growth_rate, 1)
        self.BatchNorm_1 = BatchNorm(bn_size * growth_rate)
        self.Conv_1 = ConvParams(bn_size * growth_rate, growth_rate, 3)

    def forward(self, x: torch.Tensor, train: bool, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = pointwise(F.relu(self.BatchNorm_0(x, train, dtype)), self.Conv_0, dtype)
        y = conv_nhwc(F.relu(self.BatchNorm_1(y, train, dtype)), self.Conv_1,
                      dtype, padding=1)
        y = dropout(y, self.dropout_rate, train, generator)
        return torch.cat([x.to(dtype), y], dim=-1)


class Transition(nn.Module):
    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.BatchNorm_0 = BatchNorm(in_features)
        self.Conv_0 = ConvParams(in_features, features, 1)

    def forward(self, x: torch.Tensor, train: bool, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        y = pointwise(F.relu(self.BatchNorm_0(x, train, dtype)), self.Conv_0, dtype)
        return F.avg_pool2d(y.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class DenseNet(nn.Module):
    def __init__(self, growth_rate: int = 32,
                 block_config: Sequence[int] = (6, 12, 24, 16),
                 num_init_features: int = 64, bn_size: int = 4,
                 dropout_rate: float = 0.0, num_classes: int = 2,
                 in_channels: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv0 = ConvParams(in_channels, num_init_features, 7)
        self.norm0 = BatchNorm(num_init_features)
        self.stages = []
        features = num_init_features
        for i, n_layers in enumerate(block_config):
            for j in range(n_layers):
                name = f"denseblock{i + 1}_layer{j + 1}"
                self.add_module(name, DenseLayer(features + j * growth_rate,
                                                 growth_rate, bn_size,
                                                 dropout_rate))
                self.stages.append(name)
            features += n_layers * growth_rate
            if i != len(block_config) - 1:
                name = f"transition{i + 1}"
                self.add_module(name, Transition(features, features // 2))
                self.stages.append(name)
                features //= 2
        self.norm_final = BatchNorm(features)
        self.classifier = DenseParams(features, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` with flax's defaults: lecun_normal
        conv and dense kernels, zero biases, BatchNorm scale 1 and bias 0,
        running mean 0 and var 1."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, ConvParams):
                    mod.init_(generator)
                elif isinstance(mod, BatchNorm):
                    mod.scale.fill_(1.0)
                    mod.bias.zero_()
                    mod.mean.zero_()
                    mod.var.fill_(1.0)
            lecun_normal_(self.classifier.kernel,
                          self.classifier.kernel.shape[0], generator)
            self.classifier.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                capture: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, S, in_channels) NHWC → (B, num_classes) float32 logits.
        `train` takes the training forward: batch statistics (the running
        ones updated in place) and dropout drawing from `generator`; with
        `capture`, (logits, intermediates)."""
        dt = self.dtype
        x = conv_nhwc(x, self.conv0, dt, stride=2, padding=3)
        x = F.relu(self.norm0(x, train, dt))
        # max_pool2d pads with −inf, as flax's nn.max_pool
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for name in self.stages:
            x = getattr(self, name)(x, train, dt, generator)
        x = F.relu(self.norm_final(x, train, dt))
        recorded = {"features": x} if capture else None
        x = x.mean(dim=(1, 2))
        return captured(x.float() @ self.classifier.kernel + self.classifier.bias,
                        recorded)


DENSENET_PARAMS = {
    # name: (growth_rate, block_config, num_init_features)
    "densenet121": (32, (6, 12, 24, 16), 64),
    "densenet161": (48, (6, 12, 36, 24), 96),
    "densenet169": (32, (6, 12, 32, 32), 64),
    "densenet201": (32, (6, 12, 48, 32), 64),
}


@ModelRegistry.register(list(DENSENET_PARAMS), "cnn")
def build_densenet(cfg: Any) -> DenseNet:
    name = cfg_get(cfg, "name", "densenet121")
    growth, blocks, init_f = DENSENET_PARAMS.get(name, (32, (6, 12, 24, 16), 64))
    return DenseNet(
        growth_rate=int(cfg_get(cfg, "growth_rate", growth)),
        block_config=tuple(cfg_get(cfg, "block_config", blocks)),
        num_init_features=int(cfg_get(cfg, "num_init_features", init_f)),
        bn_size=int(cfg_get(cfg, "bn_size", 4)),
        dropout_rate=float(cfg_get(cfg, "dropout_rate", 0.0)),
        num_classes=int(cfg_get(cfg, "num_classes", 2)),
        in_channels=int(cfg_get(cfg, "in_channels", 1)),
        dtype=resolve_dtype(cfg),
    )
