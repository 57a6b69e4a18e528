"""Inception v3 / v4 (counterpart of thyroid_tpu/models/cnn/inception.py),
NHWC.

Every convolution is a `ConvBN`: a bias-free conv, BatchNorm with epsilon
1e-3 (flax's, written out in float32: layers.BatchNorm), ReLU. `SAME`
convolutions here all have stride 1 and odd sides, so they pad k//2 on
each side; the stride-2 ones are `VALID`. 1×1 stride-1 convolutions are
matmuls over the channel axis, the others `F.conv2d` on channels-last
views (cuDNN on the card). Max pools are 3×3 stride 2 `VALID`; the pool
branch is a 3×3 stride-1 `SAME` average pool that divides by the full
window at the border in v3 (`count_include_pad=True`) and by the real
taps in v4 (False), flax's nn.avg_pool semantics either way, on a
contiguous NCHW copy (`branch_pool`).

InceptionV3's auxiliary head (5×5 stride-3 average pool → `aux_conv0` →
`aux_conv1` → mean → `aux_fc`) runs in training only, where the forward
returns (logits, aux_logits); `aux_conv1` is `VALID` when the pooled map
is at least 5×5 (299² inputs) and `SAME` below (224²). JAX computes the
head at eval too and drops it, which changes nothing: its BatchNorms read
the running statistics there. Dropout before `fc`, float32 heads.

Parameters are float32 and named as in the JAX tree: flax's per-class
names in creation order (`ConvBN_{n}`, `InceptionA_{n}`, …, each ConvBN a
`Conv_0` and a `BatchNorm_0`), and `aux_conv0`, `aux_conv1`, `aux_fc`,
`fc`. `forward(x, capture=True)` returns (output, {"features": the last
mixed block's output}), the tensor JAX sows for GradCAM.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..layers import (BatchNorm, ConvParams, DenseParams, captured, dropout,
                      lecun_normal_)
from ..registry import ModelRegistry, cfg_get, resolve_dtype
from .efficientnet import conv_nhwc, pointwise

INCEPTION_BN_EPS = 1e-3


def _pair(k) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


class ConvBN(nn.Module):
    def __init__(self, in_features: int, features: int,
                 kernel: int | Sequence[int] = 3, strides: int = 1,
                 padding: str = "SAME"):
        super().__init__()
        self.kernel, self.strides, self.padding = _pair(kernel), strides, padding
        self.Conv_0 = ConvParams(in_features, features, self.kernel)
        self.BatchNorm_0 = BatchNorm(features, eps=INCEPTION_BN_EPS)

    def forward(self, x: torch.Tensor, train: bool, dtype: torch.dtype,
                padding: Optional[str] = None) -> torch.Tensor:
        pad = padding or self.padding
        kh, kw = self.kernel
        if (kh, kw) == (1, 1) and self.strides == 1:
            y = pointwise(x, self.Conv_0, dtype)
        else:
            y = conv_nhwc(x, self.Conv_0, dtype, self.strides,
                          (kh // 2, kw // 2) if pad == "SAME" else 0)
        return F.relu(self.BatchNorm_0(y, train, dtype))


def _nchw(fn, x: torch.Tensor, *args, **kw) -> torch.Tensor:
    """A torch pooling `fn` on NHWC x through its channels-last view."""
    return fn(x.permute(0, 3, 1, 2), *args, **kw).permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """3×3 stride-2 VALID max pool."""
    return _nchw(F.max_pool2d, x, 3, 2)


def branch_pool(x: torch.Tensor, count_include_pad: bool = True) -> torch.Tensor:
    """3×3 stride-1 SAME average pool: the border divides by 9 with
    `count_include_pad`, by the number of real taps without. It pools a
    contiguous NCHW copy: on the card, PyTorch's padded average pool over
    the channels-last view has an exact forward but a wrong backward (its
    input gradient about 100% off the CPU's; chip_smoke.py phase 25 holds
    this form's gradient to the CPU's)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2).contiguous(), 3, 1, 1,
                     count_include_pad=count_include_pad)
    return y.permute(0, 2, 3, 1)


class _Convs(nn.Module):
    """A module whose ConvBNs are named as flax names them: ConvBN_{n} in
    creation order."""

    def __init__(self):
        super().__init__()
        self._counts: Dict[str, int] = {}

    def child(self, module: nn.Module) -> nn.Module:
        cls = type(module).__name__
        n = self._counts.get(cls, 0)
        self._counts[cls] = n + 1
        self.add_module(f"{cls}_{n}", module)
        return module


def _cat(*xs: torch.Tensor) -> torch.Tensor:
    return torch.cat(xs, dim=-1)


class InceptionA(_Convs):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        c = self.child
        self.b1 = [c(ConvBN(cin, 64, 1))]
        self.b2 = [c(ConvBN(cin, 48, 1)), c(ConvBN(48, 64, 5))]
        self.b3 = [c(ConvBN(cin, 64, 1)), c(ConvBN(64, 96, 3)), c(ConvBN(96, 96, 3))]
        self.b4 = [c(ConvBN(cin, pool_features, 1))]
        self.out = 64 + 64 + 96 + pool_features

    def forward(self, x, train, dt):
        return _cat(_chain(self.b1, x, train, dt), _chain(self.b2, x, train, dt),
                    _chain(self.b3, x, train, dt),
                    _chain(self.b4, branch_pool(x), train, dt))


def _chain(convs: List[ConvBN], x, train, dt):
    for conv in convs:
        x = conv(x, train, dt)
    return x


class InceptionB(_Convs):
    def __init__(self, cin: int):
        super().__init__()
        c = self.child
        self.b1 = [c(ConvBN(cin, 384, 3, 2, "VALID"))]
        self.b2 = [c(ConvBN(cin, 64, 1)), c(ConvBN(64, 96, 3)),
                   c(ConvBN(96, 96, 3, 2, "VALID"))]
        self.out = 384 + 96 + cin

    def forward(self, x, train, dt):
        return _cat(_chain(self.b1, x, train, dt), _chain(self.b2, x, train, dt),
                    max_pool(x))


class InceptionC(_Convs):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c, c7 = self.child, channels_7x7
        self.b1 = [c(ConvBN(cin, 192, 1))]
        self.b2 = [c(ConvBN(cin, c7, 1)), c(ConvBN(c7, c7, (1, 7))),
                   c(ConvBN(c7, 192, (7, 1)))]
        self.b3 = [c(ConvBN(cin, c7, 1)), c(ConvBN(c7, c7, (7, 1))),
                   c(ConvBN(c7, c7, (1, 7))), c(ConvBN(c7, c7, (7, 1))),
                   c(ConvBN(c7, 192, (1, 7)))]
        self.b4 = [c(ConvBN(cin, 192, 1))]
        self.out = 4 * 192

    def forward(self, x, train, dt):
        return _cat(_chain(self.b1, x, train, dt), _chain(self.b2, x, train, dt),
                    _chain(self.b3, x, train, dt),
                    _chain(self.b4, branch_pool(x), train, dt))


class InceptionD(_Convs):
    def __init__(self, cin: int):
        super().__init__()
        c = self.child
        self.b1 = [c(ConvBN(cin, 192, 1)), c(ConvBN(192, 320, 3, 2, "VALID"))]
        self.b2 = [c(ConvBN(cin, 192, 1)), c(ConvBN(192, 192, (1, 7))),
                   c(ConvBN(192, 192, (7, 1))), c(ConvBN(192, 192, 3, 2, "VALID"))]
        self.out = 320 + 192 + cin

    def forward(self, x, train, dt):
        return _cat(_chain(self.b1, x, train, dt), _chain(self.b2, x, train, dt),
                    max_pool(x))


class InceptionE(_Convs):
    def __init__(self, cin: int):
        super().__init__()
        c = self.child
        self.b1 = [c(ConvBN(cin, 320, 1))]
        self.b2 = [c(ConvBN(cin, 384, 1))]
        self.b2ab = (c(ConvBN(384, 384, (1, 3))), c(ConvBN(384, 384, (3, 1))))
        self.b3 = [c(ConvBN(cin, 448, 1)), c(ConvBN(448, 384, 3))]
        self.b3ab = (c(ConvBN(384, 384, (1, 3))), c(ConvBN(384, 384, (3, 1))))
        self.b4 = [c(ConvBN(cin, 192, 1))]
        self.out = 320 + 768 + 768 + 192

    def forward(self, x, train, dt):
        # the branches in JAX's order
        b1 = _chain(self.b1, x, train, dt)
        b2 = _chain(self.b2, x, train, dt)
        b2 = [m(b2, train, dt) for m in self.b2ab]
        b3 = _chain(self.b3, x, train, dt)
        b3 = [m(b3, train, dt) for m in self.b3ab]
        return _cat(b1, *b2, *b3,
                    _chain(self.b4, branch_pool(x), train, dt))


def _init_convnet(model: nn.Module, generator: torch.Generator,
                  heads: Sequence[DenseParams]) -> None:
    """flax's defaults: lecun_normal conv and dense kernels, zero biases,
    BatchNorm scale 1 and bias 0, running mean 0 and var 1."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvParams):
                mod.init_(generator)
            elif isinstance(mod, BatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)
        for head in heads:
            lecun_normal_(head.kernel, head.kernel.shape[0], generator)
            head.bias.zero_()


class InceptionV3(_Convs):
    def __init__(self, num_classes: int = 2, in_channels: int = 1,
                 dropout_rate: float = 0.5, aux_logits: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate, self.aux_logits, self.dtype = dropout_rate, aux_logits, dtype
        c = self.child
        self.stem = [c(ConvBN(in_channels, 32, 3, 2, "VALID")),
                     c(ConvBN(32, 32, 3, 1, "VALID")), c(ConvBN(32, 64, 3)),
                     None,                               # max pool
                     c(ConvBN(64, 80, 1)), c(ConvBN(80, 192, 3, 1, "VALID")),
                     None]
        mixed = [c(InceptionA(192, 32))]
        for pool in (64, 64):
            mixed.append(c(InceptionA(mixed[-1].out, pool)))
        mixed.append(c(InceptionB(mixed[-1].out)))
        for c7 in (128, 160, 160, 192):
            mixed.append(c(InceptionC(mixed[-1].out, c7)))
        self.before_aux = mixed
        if aux_logits:
            self.aux_conv0 = ConvBN(768, 128, 1)
            self.aux_conv1 = ConvBN(128, 768, 5)
            self.aux_fc = DenseParams(768, num_classes)
        self.after_aux = [c(InceptionD(768))]
        for _ in range(2):
            self.after_aux.append(c(InceptionE(self.after_aux[-1].out)))
        self.fc = DenseParams(2048, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        _init_convnet(self, generator,
                      [self.aux_fc, self.fc] if self.aux_logits else [self.fc])

    def aux(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.dtype
        a = _nchw(F.avg_pool2d, x, 5, 3)
        a = self.aux_conv0(a, train, dt)
        pad = "VALID" if min(a.shape[1], a.shape[2]) >= 5 else "SAME"
        a = self.aux_conv1(a, train, dt, padding=pad).mean(dim=(1, 2))
        return a.float() @ self.aux_fc.kernel + self.aux_fc.bias

    def forward(self, x: torch.Tensor, train: bool = False,
                capture: bool = False,
                generator: Optional[torch.Generator] = None):
        """x (B, S, S, in_channels) NHWC → (B, num_classes) float32 logits;
        in training with `aux_logits`, (logits, aux_logits). `train` takes
        batch statistics (the running ones updated in place) and dropout
        drawing from `generator`; with `capture`, (that, intermediates)."""
        dt = self.dtype
        for conv in self.stem:
            x = max_pool(x) if conv is None else conv(x, train, dt)
        for block in self.before_aux:
            x = block(x, train, dt)
        aux = self.aux(x, train) if self.aux_logits and train else None
        for block in self.after_aux:
            x = block(x, train, dt)
        recorded = {"features": x} if capture else None
        x = dropout(x.mean(dim=(1, 2)), self.dropout_rate, train, generator)
        logits = x.float() @ self.fc.kernel + self.fc.bias
        return captured((logits, aux) if aux is not None else logits, recorded)


class InceptionV4A(_Convs):
    def __init__(self, cin: int):
        super().__init__()
        c = self.child
        self.b1 = [c(ConvBN(cin, 96, 1))]
        self.b2 = [c(ConvBN(cin, 64, 1)), c(ConvBN(64, 96, 3))]
        self.b3 = [c(ConvBN(cin, 64, 1)), c(ConvBN(64, 96, 3)), c(ConvBN(96, 96, 3))]
        self.b4 = [c(ConvBN(cin, 96, 1))]
        self.out = 384

    def forward(self, x, train, dt):
        return _cat(_chain(self.b1, x, train, dt), _chain(self.b2, x, train, dt),
                    _chain(self.b3, x, train, dt),
                    _chain(self.b4, branch_pool(x, count_include_pad=False), train, dt))


class InceptionV4B(_Convs):
    def __init__(self, cin: int):
        super().__init__()
        c = self.child
        self.b1 = [c(ConvBN(cin, 384, 1))]
        self.b2 = [c(ConvBN(cin, 192, 1)), c(ConvBN(192, 224, (1, 7))),
                   c(ConvBN(224, 256, (7, 1)))]
        self.b3 = [c(ConvBN(cin, 192, 1)), c(ConvBN(192, 192, (7, 1))),
                   c(ConvBN(192, 224, (1, 7))), c(ConvBN(224, 224, (7, 1))),
                   c(ConvBN(224, 256, (1, 7)))]
        self.b4 = [c(ConvBN(cin, 128, 1))]
        self.out = 1024

    def forward(self, x, train, dt):
        return _cat(_chain(self.b1, x, train, dt), _chain(self.b2, x, train, dt),
                    _chain(self.b3, x, train, dt),
                    _chain(self.b4, branch_pool(x, count_include_pad=False), train, dt))


class InceptionV4C(_Convs):
    def __init__(self, cin: int):
        super().__init__()
        c = self.child
        self.b1 = [c(ConvBN(cin, 256, 1))]
        self.b2 = [c(ConvBN(cin, 384, 1))]
        self.b2ab = (c(ConvBN(384, 256, (1, 3))), c(ConvBN(384, 256, (3, 1))))
        # Cadene/timm's orientation: 448 via (3, 1), 512 via (1, 3)
        self.b3 = [c(ConvBN(cin, 384, 1)), c(ConvBN(384, 448, (3, 1))),
                   c(ConvBN(448, 512, (1, 3)))]
        self.b3ab = (c(ConvBN(512, 256, (1, 3))), c(ConvBN(512, 256, (3, 1))))
        self.b4 = [c(ConvBN(cin, 256, 1))]
        self.out = 1536

    def forward(self, x, train, dt):
        # the branches in JAX's order
        b1 = _chain(self.b1, x, train, dt)
        b2 = _chain(self.b2, x, train, dt)
        b2 = [m(b2, train, dt) for m in self.b2ab]
        b3 = _chain(self.b3, x, train, dt)
        b3 = [m(b3, train, dt) for m in self.b3ab]
        return _cat(b1, *b2, *b3,
                    _chain(self.b4, branch_pool(x, count_include_pad=False), train, dt))


class InceptionV4(_Convs):
    def __init__(self, num_classes: int = 2, in_channels: int = 1,
                 dropout_rate: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dropout_rate, self.dtype = dropout_rate, dtype
        c = self.child
        self.stem = [c(ConvBN(in_channels, 32, 3, 2, "VALID")),
                     c(ConvBN(32, 32, 3, 1, "VALID")), c(ConvBN(32, 64, 3))]
        self.p2 = [c(ConvBN(64, 96, 3, 2, "VALID"))]
        self.q1 = [c(ConvBN(160, 64, 1)), c(ConvBN(64, 96, 3, 1, "VALID"))]
        self.q2 = [c(ConvBN(160, 64, 1)), c(ConvBN(64, 64, (1, 7))),
                   c(ConvBN(64, 64, (7, 1))), c(ConvBN(64, 96, 3, 1, "VALID"))]
        self.r1 = [c(ConvBN(192, 192, 3, 2, "VALID"))]
        self.mixed_a = [c(InceptionV4A(384)) for _ in range(4)]
        self.red_a1 = [c(ConvBN(384, 384, 3, 2, "VALID"))]
        self.red_a2 = [c(ConvBN(384, 192, 1)), c(ConvBN(192, 224, 3)),
                       c(ConvBN(224, 256, 3, 2, "VALID"))]
        self.mixed_b = [c(InceptionV4B(1024)) for _ in range(7)]
        self.red_b1 = [c(ConvBN(1024, 192, 1)), c(ConvBN(192, 192, 3, 2, "VALID"))]
        self.red_b2 = [c(ConvBN(1024, 256, 1)), c(ConvBN(256, 256, (1, 7))),
                       c(ConvBN(256, 320, (7, 1))),
                       c(ConvBN(320, 320, 3, 2, "VALID"))]
        self.mixed_c = [c(InceptionV4C(1536)) for _ in range(3)]
        self.fc = DenseParams(1536, num_classes)

    def init_weights(self, generator: torch.Generator) -> None:
        _init_convnet(self, generator, [self.fc])

    def forward(self, x: torch.Tensor, train: bool = False,
                capture: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, S, in_channels) NHWC → (B, num_classes) float32 logits;
        with `capture`, (logits, intermediates)."""
        dt = self.dtype
        x = _chain(self.stem, x, train, dt)
        x = _cat(max_pool(x), _chain(self.p2, x, train, dt))
        x = _cat(_chain(self.q1, x, train, dt), _chain(self.q2, x, train, dt))
        x = _cat(_chain(self.r1, x, train, dt), max_pool(x))
        for block in self.mixed_a:
            x = block(x, train, dt)
        x = _cat(_chain(self.red_a1, x, train, dt), _chain(self.red_a2, x, train, dt),
                 max_pool(x))
        for block in self.mixed_b:
            x = block(x, train, dt)
        x = _cat(_chain(self.red_b1, x, train, dt),
                 _chain(self.red_b2, x, train, dt), max_pool(x))
        for block in self.mixed_c:
            x = block(x, train, dt)
        recorded = {"features": x} if capture else None
        x = dropout(x.mean(dim=(1, 2)), self.dropout_rate, train, generator)
        return captured(x.float() @ self.fc.kernel + self.fc.bias, recorded)


@ModelRegistry.register(["inception_v3", "inception_v4"], "cnn")
def build_inception(cfg: Any):
    name = cfg_get(cfg, "name", "inception_v3")
    common = dict(
        num_classes=int(cfg_get(cfg, "num_classes", 2)),
        in_channels=int(cfg_get(cfg, "in_channels", 1)),
        dropout_rate=float(cfg_get(cfg, "dropout_rate", 0.5)),
        dtype=resolve_dtype(cfg),
    )
    if name == "inception_v4":
        return InceptionV4(**common)
    return InceptionV3(aux_logits=bool(cfg_get(cfg, "aux_logits", True)), **common)
