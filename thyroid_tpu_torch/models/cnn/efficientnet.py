"""EfficientNet B0–B3 (counterpart of thyroid_tpu/models/cnn/efficientnet.py):
compound-scaled MBConv stack with SiLU, squeeze-excite and stochastic
depth, NHWC.

Activations stay NHWC, as in JAX. The 3×3 stem and the depthwise
convolutions go to `F.conv2d` as channels-last NCHW views of the NHWC
tensors (no copy when the convolution returns channels-last, which it does
for an input with more than one channel); the 1×1 convolutions (expand,
project, head, squeeze-excite) are matmuls over the channel axis. Every
convolution casts its input and kernel to the model dtype and returns that
dtype, as flax's nn.Conv(dtype=…) does; BatchNorm takes float32
statistics (layers.BatchNorm); the head's mean runs in the model dtype and
the classifier in float32.

Depthwise convolutions, as in JAX (`MBConv`):
- `dw_shift_conv`: `ShiftDepthwiseConv`, shifted multiply-accumulates
  (ops/depthwise.py), any stride, train and eval;
- `dw_pallas_conv`: `PallasDepthwiseConv` for the stride-1 convs, the
  depthwise kernel (Q2-17, ops/depthwise_pallas.py) in eval forwards only;
  the stride-2 convs and every training forward keep the library
  convolution, as they keep XLA's in JAX;
- otherwise `DepthwiseConv`, `F.conv2d(groups=C)` (cuDNN on the card).
All three hold the same `kernel` parameter, so the variable tree does not
depend on the choice.

Parameters are float32 and named as in the JAX tree. Inside an MBConv the
convolutions carry explicit names `Conv_{n}` and the BatchNorms flax's
per-class count `BatchNorm_0..2`; the expand_ratio 1 block has no expand
convolution, so its depthwise conv is `Conv_0` and its project `Conv_1`.
Padding is symmetric k//2 at every stride (timm's non-TF variants), not
TF SAME. `forward(x, capture=True)` returns (logits, {"features": the
map after `head_bn` and SiLU}), the tensor JAX sows for GradCAM; with
dw_pallas_conv its forward runs the depthwise kernel, as JAX's does.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.depthwise import shift_depthwise_conv
from ...ops.depthwise_pallas import depthwise_conv2d_pallas
from ...serving.quantize import conv_site
from ..layers import (BatchNorm, ConvParams, DenseParams, DropPath, captured,
                      conv_layer, dense_layer, dropout, lecun_normal_)
from ..registry import ModelRegistry, cfg_get, resolve_dtype

# (expand_ratio, channels, repeats, stride, kernel) — standard B0 plan
B0_PLAN = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)


def round_filters(f: int, width_mult: float, divisor: int = 8) -> int:
    f *= width_mult
    new_f = max(divisor, int(f + divisor / 2) // divisor * divisor)
    if new_f < 0.9 * f:
        new_f += divisor
    return int(new_f)


def round_repeats(r: int, depth_mult: float) -> int:
    return int(math.ceil(depth_mult * r))


def conv_nhwc(x: torch.Tensor, conv: ConvParams, dtype: torch.dtype,
              stride: int = 1, padding: int = 0) -> torch.Tensor:
    """flax nn.Conv(dtype) on NHWC x with symmetric `padding`
    (layers.conv_layer, int8 under `int8_serving` where eligible); the
    result NHWC contiguous in `dtype`."""
    return conv_layer(x, conv.kernel, conv.bias, dtype, stride, padding,
                      conv.groups).contiguous()


def pointwise(x: torch.Tensor, conv: ConvParams,
              dtype: torch.dtype) -> torch.Tensor:
    """A 1×1 stride-1 flax Conv on NHWC x as a matmul over channels (its
    int8 form under `int8_serving` where eligible)."""
    y = conv_site(x, conv.kernel, conv.bias, dtype)
    if y is not None:
        return y
    bias = conv.bias.to(dtype) if conv.bias is not None else None
    return F.linear(x.to(dtype), conv.kernel[:, :, 0, 0].to(dtype), bias)


class SqueezeExcite(nn.Module):
    """Squeeze to max(1, int(in_features·se_ratio)) of the BLOCK input's
    width, excite back to the expanded width; both 1×1 convs with bias."""

    def __init__(self, in_features: int, features: int, se_ratio: float = 0.25):
        super().__init__()
        squeezed = max(1, int(in_features * se_ratio))
        self.Conv_0 = ConvParams(features, squeezed, use_bias=True)
        self.Conv_1 = ConvParams(squeezed, features, use_bias=True)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        s = x.mean(dim=(1, 2), keepdim=True)
        s = F.silu(pointwise(s, self.Conv_0, dtype))
        s = pointwise(s, self.Conv_1, dtype)
        return x * torch.sigmoid(s)


class DepthwiseConv(ConvParams):
    """A depthwise conv with nn.Conv(feature_group_count=C)'s parameter
    (kernel (C, 1, k, k), no bias), symmetric k//2 padding, computed by
    F.conv2d(groups=C) (cuDNN on the card)."""

    def __init__(self, features: int, kernel: int, strides: int = 1):
        super().__init__(features, features, kernel, groups=features)
        self.strides = strides

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool) -> torch.Tensor:
        return conv_nhwc(x, self, dtype, self.strides,
                         int(self.kernel.shape[-1]) // 2)


class ShiftDepthwiseConv(DepthwiseConv):
    """The depthwise conv as k² shifted multiply-accumulates
    (ops/depthwise.py), train and eval (`dw_shift_conv`)."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool) -> torch.Tensor:
        return shift_depthwise_conv(x.to(dtype), self.kernel.to(dtype),
                                    self.strides)


class PallasDepthwiseConv(DepthwiseConv):
    """A stride-1 depthwise conv through kernel Q2-17
    (ops/depthwise_pallas.py) in eval forwards (`dw_pallas_conv`); a
    training forward keeps F.conv2d, as JAX keeps XLA's conv and autodiff."""

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                train: bool) -> torch.Tensor:
        if train:
            return super().forward(x, dtype, train)
        return depthwise_conv2d_pallas(x.to(dtype).contiguous(),
                                       self.kernel.to(dtype))


class MBConv(nn.Module):
    def __init__(self, in_features: int, out_features: int, expand_ratio: int,
                 kernel: int, strides: int, drop_path_rate: float = 0.0,
                 dw_shift: bool = False, dw_pallas: bool = False):
        super().__init__()
        self.expand_ratio = expand_ratio
        self.residual = strides == 1 and in_features == out_features
        expanded = in_features * expand_ratio
        n_conv = 0
        if expand_ratio != 1:
            self.Conv_0 = ConvParams(in_features, expanded)
            self.BatchNorm_0 = BatchNorm(expanded)
            n_conv = 1
        n_bn = n_conv
        if dw_shift:
            dw = ShiftDepthwiseConv(expanded, kernel, strides)
        elif dw_pallas and strides == 1:
            dw = PallasDepthwiseConv(expanded, kernel)
        else:
            dw = DepthwiseConv(expanded, kernel, strides)
        # explicit Conv_{n} names, as in JAX: flax's per-class count would
        # name the depthwise conv apart from its neighbours
        self.dw = f"Conv_{n_conv}"
        self.add_module(self.dw, dw)
        self.add_module(f"BatchNorm_{n_bn}", BatchNorm(expanded))
        self.SqueezeExcite_0 = SqueezeExcite(in_features, expanded)
        self.project = f"Conv_{n_conv + 1}"
        self.add_module(self.project, ConvParams(expanded, out_features))
        self.add_module(f"BatchNorm_{n_bn + 1}", BatchNorm(out_features))
        self.bns = [f"BatchNorm_{i}" for i in range(n_bn + 2)]
        self.drop_path = DropPath(drop_path_rate) if self.residual else None

    def forward(self, x: torch.Tensor, train: bool, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        bns = [getattr(self, n) for n in self.bns]
        h = x
        if self.expand_ratio != 1:
            h = F.silu(bns.pop(0)(pointwise(h, self.Conv_0, dtype), train, dtype))
        h = getattr(self, self.dw)(h, dtype, train)
        h = F.silu(bns[0](h, train, dtype))
        h = self.SqueezeExcite_0(h, dtype)
        h = bns[1](pointwise(h, getattr(self, self.project), dtype), train, dtype)
        if self.residual:
            h = self.drop_path(h, train, generator) + x
        return h


class EfficientNet(nn.Module):
    def __init__(self, width_mult: float = 1.0, depth_mult: float = 1.0,
                 dropout_rate: float = 0.2, drop_path_rate: float = 0.2,
                 num_classes: int = 2, in_channels: int = 1,
                 img_size: int = 224, dw_shift: bool = False,
                 dw_pallas: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        # the served and initialised side: the config's img_size or 224, as
        # the JAX engine and init_model read it, never the variant's resolution
        self.img_size, self.in_channels = img_size, in_channels
        self.dropout_rate, self.dtype = dropout_rate, dtype
        stem = round_filters(32, width_mult)
        self.stem_conv = ConvParams(in_channels, stem, 3)
        self.stem_bn = BatchNorm(stem)
        total = sum(round_repeats(r, depth_mult) for _, _, r, _, _ in B0_PLAN)
        self.blocks = []
        in_f, block_idx = stem, 0
        for stage, (expand, ch, repeats, stride, kernel) in enumerate(B0_PLAN):
            out_f = round_filters(ch, width_mult)
            for i in range(round_repeats(repeats, depth_mult)):
                # stochastic depth rises with the block index (not Swin's
                # linspace): rate · idx / total
                dpr = drop_path_rate * block_idx / max(total, 1)
                name = f"mbconv{stage}_{i}"
                self.add_module(name, MBConv(
                    in_f, out_f, expand, kernel, stride if i == 0 else 1,
                    drop_path_rate=dpr, dw_shift=dw_shift, dw_pallas=dw_pallas))
                self.blocks.append(name)
                in_f = out_f
                block_idx += 1
        head = round_filters(1280, width_mult)
        self.head_conv = ConvParams(in_f, head)
        self.head_bn = BatchNorm(head)
        self.classifier = DenseParams(head, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` with flax's defaults: lecun_normal
        for every conv and dense kernel, zero biases, BatchNorm scale 1 and
        bias 0, running mean 0 and var 1."""
        with torch.no_grad():
            for mod in self.modules():
                if isinstance(mod, ConvParams):
                    mod.init_(generator)
                elif isinstance(mod, BatchNorm):
                    mod.scale.fill_(1.0)
                    mod.bias.zero_()
                    mod.mean.zero_()
                    mod.var.fill_(1.0)
            lecun_normal_(self.classifier.kernel, self.classifier.kernel.shape[0],
                          generator)
            self.classifier.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False,
                capture: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, S, in_channels) NHWC → (B, num_classes) float32 logits.
        `train` takes the training forward: batch statistics (the running
        ones updated in place), DropPath and dropout drawing from
        `generator` (on x's device); with `capture`, (logits,
        intermediates)."""
        dt = self.dtype
        x = conv_nhwc(x, self.stem_conv, dt, stride=2, padding=1)
        x = F.silu(self.stem_bn(x, train, dt))
        for name in self.blocks:
            x = getattr(self, name)(x, train, dt, generator)
        x = F.silu(self.head_bn(pointwise(x, self.head_conv, dt), train, dt))
        recorded = {"features": x} if capture else None
        x = dropout(x.mean(dim=(1, 2)), self.dropout_rate, train, generator)
        return captured(dense_layer(x, self.classifier, torch.float32), recorded)


EFFICIENTNET_PARAMS = {
    # name: (width_mult, depth_mult, resolution, dropout) — reference
    # VARIANT_CONFIG (src/models/cnn/efficientnet.py:19-24)
    "efficientnet_b0": (1.0, 1.0, 224, 0.2),
    "efficientnet_b1": (1.0, 1.1, 240, 0.2),
    "efficientnet_b2": (1.1, 1.2, 260, 0.3),
    "efficientnet_b3": (1.2, 1.4, 300, 0.3),
}


def stride1_depthwise_shapes(name: str, batch: int, side: int):
    """{(B, H, W, C, k): convs per forward} of the stride-1 depthwise convs
    that an eval forward of `name` at `batch` and `side` gives the depthwise
    kernel with dw_pallas_conv (the stem and every stride-2 conv take the
    side to (side - 1) // 2 + 1, symmetric k//2 padding)."""
    wm, dm, _, _ = EFFICIENTNET_PARAMS[name]
    side = (side - 1) // 2 + 1
    in_f, shapes = round_filters(32, wm), {}
    for expand, ch, repeats, stride, k in B0_PLAN:
        for i in range(round_repeats(repeats, dm)):
            s = stride if i == 0 else 1
            if s == 1:
                key = (batch, side, side, in_f * expand, k)
                shapes[key] = shapes.get(key, 0) + 1
            side = (side - 1) // s + 1
            in_f = round_filters(ch, wm)
    return shapes


@ModelRegistry.register(list(EFFICIENTNET_PARAMS), "cnn")
def build_efficientnet(cfg: Any) -> EfficientNet:
    name = cfg_get(cfg, "name", "efficientnet_b0")
    wm, dm, _, drop = EFFICIENTNET_PARAMS.get(name, (1.0, 1.0, 224, 0.2))
    return EfficientNet(
        width_mult=float(cfg_get(cfg, "width_mult", wm)),
        depth_mult=float(cfg_get(cfg, "depth_mult", dm)),
        dropout_rate=float(cfg_get(cfg, "dropout_rate", drop)),
        drop_path_rate=float(cfg_get(cfg, "drop_path_rate", 0.2)),
        num_classes=int(cfg_get(cfg, "num_classes", 2)),
        in_channels=int(cfg_get(cfg, "in_channels", 1)),
        img_size=int(cfg_get(cfg, "img_size", 224)),
        dw_shift=bool(cfg_get(cfg, "dw_shift_conv", False)),
        dw_pallas=bool(cfg_get(cfg, "dw_pallas_conv", False)),
        dtype=resolve_dtype(cfg),
    )
