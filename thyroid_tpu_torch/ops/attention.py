"""Swin window attention (counterpart of thyroid_tpu/ops/attention.py).

`fused_swin_block_attention` is the serving half-block — window
partition, W-MSA with relative-position bias and shift mask, window
reverse, out-projection, bias and residual — in one CUDA kernel
(`csrc/swin_attention.cu`) on CUDA tensors, and in its plain PyTorch
version, `swin_block_attention_plain`, on CPU tensors.
`window_attention_reference` is the per-window reference the tests use.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_TOKENS = 64   # the kernel's row layout covers windows up to 8 x 8


def window_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v (BW, h, N, d), bias (h, N, N), mask (nW, N, N) or None →
    (BW, h, N, d) in q's dtype, computed in float32."""
    bw, h, n, d = q.shape
    if scale is None:
        scale = d ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    scores = scores + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        scores = (scores.reshape(bw // nw, nw, h, n, n)
                  + mask[None, :, None].float()).reshape(bw, h, n, n)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws·ws, C), windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, ws·ws, C) → (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // ((h // ws) * (w // ws))
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def swin_block_attention_plain(qkv: torch.Tensor, residual: torch.Tensor,
                               proj_kernel: torch.Tensor,
                               proj_bias: Optional[torch.Tensor],
                               bias: torch.Tensor,
                               mask: Optional[torch.Tensor], *,
                               window_size: int, num_heads: int,
                               scale: float) -> torch.Tensor:
    """Plain version of fused_swin_block_attention: attention in float32,
    its output rounded to the compute dtype before the projection, the
    projection accumulated in float32, bias and residual added in float32,
    the result in the compute dtype."""
    b, hh, ww, _, c = qkv.shape
    ws, n, dh = window_size, window_size * window_size, c // num_heads
    cdt = qkv.dtype
    win = window_partition(qkv.reshape(b, hh, ww, 3 * c), ws).float()
    q, k, v = (win[:, :, i * c:(i + 1) * c].reshape(-1, n, num_heads, dh)
               .transpose(1, 2) for i in range(3))
    scores = (q * scale) @ k.transpose(-1, -2) + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        scores = (scores.reshape(-1, nw, num_heads, n, n)
                  + mask[None, :, None].float()).reshape(-1, num_heads, n, n)
    o = torch.softmax(scores, dim=-1) @ v               # (BW, h, N, dh)
    o = o.transpose(1, 2).reshape(-1, n, c).to(cdt).float()
    y = o @ proj_kernel.to(cdt).float()
    if proj_bias is not None:
        y = y + proj_bias.float()
    return (residual.float() + window_reverse(y, ws, hh, ww)).to(cdt)


def fused_swin_block_attention(qkv: torch.Tensor, residual: torch.Tensor,
                               proj_kernel: torch.Tensor,
                               proj_bias: Optional[torch.Tensor],
                               bias: torch.Tensor,
                               mask: Optional[torch.Tensor] = None, *,
                               window_size: int, num_heads: int,
                               scale: Optional[float] = None) -> torch.Tensor:
    """out = residual + proj(window_reverse(W-MSA(partition(qkv)))).

    qkv (B, H, W, 3, C) — already LN'd, projected and rolled if shifted;
    residual (B, H, W, C) — the pre-LN stream in the same rolled frame;
    proj_kernel (C, C), proj_bias (C,) or None; bias (heads, N, N) the
    gathered relative-position bias; mask (nW, N, N) shift mask or None.
    → (B, H, W, C) in qkv's dtype."""
    b, hh, ww, three, c = qkv.shape
    ws, n = window_size, window_size * window_size
    if three != 3 or tuple(residual.shape) != (b, hh, ww, c):
        raise ValueError(f"qkv {tuple(qkv.shape)} / residual "
                         f"{tuple(residual.shape)} do not match")
    if hh % ws or ww % ws or c % num_heads:
        raise ValueError(f"({hh}, {ww}, {c}) does not tile into {ws}x{ws} "
                         f"windows of {num_heads} heads")
    nw = (hh // ws) * (ww // ws)
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} is not "
                         f"{(num_heads, n, n)}")
    if mask is not None and tuple(mask.shape) != (nw, n, n):
        raise ValueError(f"mask {tuple(mask.shape)} is not {(nw, n, n)}")
    if scale is None:
        scale = (c // num_heads) ** -0.5
    if qkv.device.type == "cpu":
        return swin_block_attention_plain(
            qkv, residual, proj_kernel, proj_bias, bias, mask,
            window_size=ws, num_heads=num_heads, scale=float(scale))
    if qkv.device.type != "cuda":
        raise ValueError(f"unsupported device {qkv.device}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"fused_swin_block_attention takes float32 or "
                        f"bfloat16, got {qkv.dtype}")
    if residual.dtype != qkv.dtype:
        raise TypeError(f"residual {residual.dtype} != qkv {qkv.dtype}")
    if n > _MAX_TOKENS:
        raise ValueError(f"window {ws}x{ws} has more than {_MAX_TOKENS} tokens")
    wp = proj_kernel.to(qkv.dtype).contiguous()
    bp = (proj_bias.float() if proj_bias is not None
          else torch.zeros(c, dtype=torch.float32, device=qkv.device)).contiguous()
    bias = bias.float().contiguous()
    mask_f = mask.float().contiguous() if mask is not None else None
    for t in (qkv, residual, wp, bp, bias) + ((mask_f,) if mask is not None else ()):
        if t.device != qkv.device:
            raise ValueError(f"tensors on {t.device} and {qkv.device}")
        if not t.is_contiguous():
            raise ValueError("fused_swin_block_attention needs contiguous "
                             "qkv and residual")
    is_bf16 = int(qkv.dtype == torch.bfloat16)
    y = torch.empty_like(residual)
    if b == 0:
        return y
    fn = _build.function("swin_attention", "tt_swin_block_attention",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(qkv), _build.ptr(residual), _build.ptr(wp),
                _build.ptr(bp), _build.ptr(bias),
                _build.ptr(mask_f) if mask_f is not None else None,
                _build.ptr(y), b, hh, ww, c, num_heads, ws, float(scale),
                is_bf16, _build.stream_ptr(qkv.device))
    _build.check("swin_attention", status, "fused_swin_block_attention")
    fused_swin_block_attention.launches += 1
    return y


fused_swin_block_attention.launches = 0
