"""ResNet 18/34/50/101 (counterpart of thyroid_tpu/models/cnn/resnet.py),
NHWC, conv + BatchNorm (+ ReLU) blocks.

Activations stay NHWC, as in JAX. The 7×7 stem, the 3×3 convolutions and
every strided convolution go to `F.conv2d` as channels-last NCHW views
(efficientnet.conv_nhwc: cuDNN on the card); the stride-1 1×1 convolutions
are matmuls over the channel axis. Convolutions cast their input and
kernel to the model dtype, as flax's nn.Conv(dtype=…) does; BatchNorm
takes float32 statistics (layers.BatchNorm, momentum 0.9); the 3×3
stride-2 max pool pads with −inf; the global mean runs in the model dtype,
dropout draws from the caller's generator, and `fc` is float32.

Parameters are float32 and named as in the JAX tree: the stem `conv1`
and `bn1`, blocks `layer{stage}_{i}` holding `ConvBN_{j}` (each a
`Conv_0` and a `BatchNorm_0`) and, where the shape changes, `downsample`;
the head `fc`. `forward(x, capture=True)` returns (logits, {"features":
the last block's output}), the tensor JAX sows for GradCAM.
`SpatialAttention` and `QualityEncoder` are kept, unwired, as in JAX.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (BatchNorm, ConvParams, DenseParams, LecunDense,
                      captured, dropout, lecun_normal_)
from ..registry import ModelRegistry, cfg_get, resolve_dtype
from .efficientnet import conv_nhwc, pointwise


class ConvBN(nn.Module):
    """A bias-free k×k conv (symmetric k//2 padding), BatchNorm and an
    optional ReLU."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 strides: int = 1, act: bool = True):
        super().__init__()
        self.kernel, self.strides, self.act = kernel, strides, act
        self.Conv_0 = ConvParams(in_features, features, kernel)
        self.BatchNorm_0 = BatchNorm(features)

    def forward(self, x: torch.Tensor, train: bool,
                dtype: torch.dtype) -> torch.Tensor:
        if self.kernel == 1 and self.strides == 1:
            y = pointwise(x, self.Conv_0, dtype)
        else:
            y = conv_nhwc(x, self.Conv_0, dtype, self.strides, self.kernel // 2)
        y = self.BatchNorm_0(y, train, dtype)
        return F.relu(y) if self.act else y


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        self.ConvBN_0 = ConvBN(in_features, features, 3, strides)
        self.ConvBN_1 = ConvBN(features, features, 3, 1, act=False)
        # the JAX block adds the projection where the shapes differ
        self.downsample = ConvBN(in_features, features, 1, strides, act=False) \
            if (strides != 1 or in_features != features) else None

    def forward(self, x: torch.Tensor, train: bool,
                dtype: torch.dtype) -> torch.Tensor:
        y = self.ConvBN_1(self.ConvBN_0(x, train, dtype), train, dtype)
        residual = x if self.downsample is None \
            else self.downsample(x, train, dtype)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_features: int, features: int, strides: int = 1):
        super().__init__()
        out = features * self.expansion
        self.ConvBN_0 = ConvBN(in_features, features, 1, 1)
        self.ConvBN_1 = ConvBN(features, features, 3, strides)
        self.ConvBN_2 = ConvBN(features, out, 1, 1, act=False)
        self.downsample = ConvBN(in_features, out, 1, strides, act=False) \
            if (strides != 1 or in_features != out) else None

    def forward(self, x: torch.Tensor, train: bool,
                dtype: torch.dtype) -> torch.Tensor:
        y = self.ConvBN_0(x, train, dtype)
        y = self.ConvBN_2(self.ConvBN_1(y, train, dtype), train, dtype)
        residual = x if self.downsample is None \
            else self.downsample(x, train, dtype)
        return F.relu(y + residual)


class SpatialAttention(nn.Module):
    """sigmoid(1×1 conv with bias) gate over a feature map → (attended,
    attention); unwired, as in JAX."""

    def __init__(self, in_features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Conv_0 = ConvParams(in_features, 1, use_bias=True)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        attention = torch.sigmoid(pointwise(x, self.Conv_0, self.dtype))
        return x * attention, attention


class QualityEncoder(nn.Module):
    """Per-image quality scores (B, 3) → (B, hidden_dim): two Dense + ReLU;
    unwired, as in JAX."""

    def __init__(self, in_features: int = 3, hidden_dim: int = 64,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.Dense_0 = LecunDense(in_features, hidden_dim)
        self.Dense_1 = LecunDense(hidden_dim, hidden_dim)

    def forward(self, quality_scores: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = quality_scores.to(dt)
        for d in (self.Dense_0, self.Dense_1):
            x = F.relu(x @ d.kernel.to(dt) + d.bias.to(dt))
        return x


class ResNet(nn.Module):
    def __init__(self, block: str = "bottleneck",
                 layers: Sequence[int] = (3, 4, 6, 3), width: int = 64,
                 num_classes: int = 2, in_channels: int = 1,
                 dropout_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate, self.dtype = dropout_rate, dtype
        block_cls = BasicBlock if block == "basic" else Bottleneck
        self.conv1 = ConvParams(in_channels, width, 7)
        self.bn1 = BatchNorm(width)
        self.blocks = []
        in_f = width
        for stage, n_blocks in enumerate(layers):
            feats = width * 2 ** stage
            for i in range(n_blocks):
                name = f"layer{stage + 1}_{i}"
                self.add_module(name, block_cls(
                    in_f, feats, 2 if (stage > 0 and i == 0) else 1))
                self.blocks.append(name)
                in_f = feats * block_cls.expansion
        self.fc = DenseParams(in_f, num_classes)

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
            lecun_normal_(self.fc.kernel, self.fc.kernel.shape[0], generator)
            self.fc.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                capture: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, S, in_channels) NHWC → (B, num_classes) float32 logits.
        `train` takes the training forward: batch statistics (the running
        ones updated in place) and dropout drawing from `generator` (on x's
        device); with `capture`, (logits, intermediates)."""
        dt = self.dtype
        x = conv_nhwc(x, self.conv1, dt, stride=2, padding=3)
        x = F.relu(self.bn1(x, train, dt))
        # max_pool2d pads with −inf, as flax's nn.max_pool
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
        for name in self.blocks:
            x = getattr(self, name)(x, train, dt)
        recorded = {"features": x} if capture else None
        x = dropout(x.mean(dim=(1, 2)), self.dropout_rate, train, generator)
        return captured(x.float() @ self.fc.kernel + self.fc.bias, recorded)


RESNET_PARAMS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
}


@ModelRegistry.register(list(RESNET_PARAMS), "cnn")
def build_resnet(cfg: Any) -> ResNet:
    name = cfg_get(cfg, "name", "resnet50")
    block, layers = RESNET_PARAMS.get(name, ("bottleneck", (3, 4, 6, 3)))
    return ResNet(
        block=str(cfg_get(cfg, "block", block)),
        layers=tuple(cfg_get(cfg, "layers", layers)),
        width=int(cfg_get(cfg, "width", 64)),
        num_classes=int(cfg_get(cfg, "num_classes", 2)),
        in_channels=int(cfg_get(cfg, "in_channels", 1)),
        dropout_rate=float(cfg_get(cfg, "dropout_rate", 0.0)),
        dtype=resolve_dtype(cfg),
    )
