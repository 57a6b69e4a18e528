"""Depthwise convolution as shifted multiply-accumulates (counterpart of
thyroid_tpu/ops/depthwise.py).

The plain function behind EfficientNet's opt-in `dw_shift_conv` and the
plain version of the depthwise kernel (ops/depthwise_pallas.py): k² shifted
slices of the zero-padded input, each cast to float32, multiplied by its
tap's weight and added to a float32 sum in tap order (iy, ix); the sum is
returned in x's dtype, the contract of a bf16 convolution with float32
accumulation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def shift_depthwise_conv(x: torch.Tensor, w: torch.Tensor, strides: int = 1,
                         padding: int | None = None) -> torch.Tensor:
    """x (B, H, W, C); w (C, 1, kh, kw), PyTorch's depthwise weight layout
    (the JAX function takes flax's (kh, kw, 1, C)); symmetric `padding`
    (default k//2, the torch-symmetric choice of the CNN zoo) →
    (B, Ho, Wo, C) in x.dtype, float32-accumulated."""
    kh, kw = int(w.shape[2]), int(w.shape[3])
    if padding is None:
        padding = kh // 2
    _, h, wd, _ = x.shape
    s = int(strides)
    ho = (h + 2 * padding - kh) // s + 1
    wo = (wd + 2 * padding - kw) // s + 1
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    wk = w[:, 0].float()                               # (C, kh, kw)
    acc = None
    for i in range(kh):
        for j in range(kw):
            sl = xp[:, i:i + s * (ho - 1) + 1:s, j:j + s * (wo - 1) + 1:s, :]
            term = sl.float() * wk[:, i, j]
            acc = term if acc is None else acc + term
    return acc.to(x.dtype)
