"""Stride-1 depthwise convolution through the CUDA kernel `csrc/depthwise.cu`
(counterpart of thyroid_tpu/ops/depthwise_pallas.py, kernel Q2-17).

- `depthwise_conv2d_plain(x, w)`: the kernel's plain version, the shifted
  multiply-accumulates of ops/depthwise.py at stride 1.
- `depthwise_conv2d_pallas(x, w)`: launches the kernel on a CUDA tensor and
  runs the plain version on a CPU tensor; symmetric k//2 zero padding,
  float32 accumulation in tap order, the output in x's dtype. It is a
  `torch.autograd.Function`, as the JAX function is a custom_vjp, so that
  analysis paths (Grad-CAM) can differentiate an eval forward through it;
  its backward (`depthwise_conv2d_bwd`) is the JAX `_dw_bwd` in plain
  PyTorch: the input gradient is the depthwise convolution of g with the
  spatially flipped kernel, the weight gradient k² per-tap sums of the
  shifted input times g. The JAX backward is XLA, not Pallas, so there is
  no backward kernel.

Weights are in PyTorch's depthwise layout (C, 1, k, k); activations NHWC.
Unlike the TPU kernel, the wrapper neither pads nor packs lanes on the
host: taps outside the image read zero inside the kernel.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .depthwise import shift_depthwise_conv

KERNEL_SIZES = (3, 5, 7)           # the kernel's instantiations
_DTYPES = (torch.float32, torch.bfloat16)


def depthwise_conv2d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: x (B, H, W, C), w (C, 1, k, k) → (B, H, W, C)."""
    return shift_depthwise_conv(x, w, 1)


def depthwise_conv2d_bwd(x: torch.Tensor, w: torch.Tensor,
                         g: torch.Tensor) -> tuple:
    """(dx in x.dtype, dw in w.dtype) of the stride-1 depthwise conv at
    (x, w) for the output gradient g, computed in float32."""
    k = int(w.shape[-1])
    p = k // 2
    _, h, wd, c = x.shape
    gf = g.float()
    wf = torch.flip(w, dims=(2, 3)).float()
    dx = F.conv2d(gf.permute(0, 3, 1, 2), wf, padding=p, groups=c) \
        .permute(0, 2, 3, 1).to(x.dtype)
    xpad = F.pad(x.float(), (0, 0, p, p, p, p))
    taps = [(xpad[:, iy:iy + h, ix:ix + wd, :] * gf).sum(dim=(0, 1, 2))
            for iy in range(k) for ix in range(k)]
    dw = torch.stack(taps, dim=-1).reshape(c, 1, k, k).to(w.dtype)
    return dx, dw


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"depthwise_conv2d_pallas takes float32 or bfloat16 "
                        f"x and w of one dtype, got {x.dtype} and {w.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[1] != 1 \
            or w.shape[0] != x.shape[-1] or w.shape[2] != w.shape[3]:
        raise ValueError(f"depthwise_conv2d_pallas takes x (B, H, W, C) and "
                         f"w (C, 1, k, k), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    if int(w.shape[-1]) not in KERNEL_SIZES:
        raise ValueError(f"the depthwise kernel takes k in {KERNEL_SIZES}, "
                         f"got {int(w.shape[-1])}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("depthwise_conv2d_pallas needs contiguous x and w")
    if w.device != x.device:
        raise ValueError("x and w must lie on one device")
    if x.data_ptr() % 16:
        raise ValueError("depthwise_conv2d_pallas copies x in 16-byte pieces: "
                         "x must start 16-byte aligned")


def _forward(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cpu":
        return depthwise_conv2d_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check(x, w)
    b, h, wd, c = x.shape
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    fn = _build.function("depthwise", "tt_depthwise_conv", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    status = fn(_build.ptr(x), _build.ptr(w), _build.ptr(y), b, h, wd, c,
                int(w.shape[-1]), int(x.dtype == torch.bfloat16),
                _build.stream_ptr(x.device))
    _build.check("depthwise", status, "depthwise_conv2d_pallas")
    depthwise_conv2d_pallas.launches += 1
    return y


class _DepthwiseConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        return depthwise_conv2d_bwd(x, w, g)


def depthwise_conv2d_pallas(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 depthwise conv with symmetric k//2 zero padding: x
    (B, H, W, C) and w (C, 1, k, k) of one dtype (float32 or bfloat16) →
    (B, H, W, C) in x.dtype, float32-accumulated; differentiable."""
    return _DepthwiseConv.apply(x, w)


depthwise_conv2d_pallas.launches = 0
