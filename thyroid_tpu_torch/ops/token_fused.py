"""Token-major fused LN kernels (counterpart of thyroid_tpu/ops/token_fused.py).

Forward only (serving; with autograd recording they raise, since their
backward kernels are ROADMAP Queue 2 items 9-11):
- `fused_ln_matmul`:        y = LN(x) @ W + b            (csrc/ln_matmul.cu)
- `fused_ln_mlp_residual`:  y = x + fc2(gelu(fc1(LN(x))))  (csrc/ln_mlp.cu)

Each launches its CUDA kernel on CUDA tensors and runs its plain PyTorch
version (`ln_matmul_plain`, `ln_mlp_residual_plain`) on CPU tensors. The
compute dtype is x's dtype: weights are cast to it, LN parameters and
biases to float32, as the JAX wrappers do. LN follows flax's fast-variance
numerics in float32; intermediate activations are rounded to the compute
dtype where the JAX kernels round them.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .platform import refuse_autograd

LN_EPS = 1e-5
_DTYPES = (torch.float32, torch.bfloat16)
_NO_BWD = ("its backward kernels are not ported (ROADMAP Queue 2 items "
           "9-11); training runs LN and the matmuls in plain PyTorch")


def ln_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
            eps: float = LN_EPS) -> torch.Tensor:
    """flax LayerNorm numerics on the last axis, float32 in and out:
    fast variance E[x²]−μ² clamped at 0, mul = rsqrt(var+eps)·γ."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * g
    return (x - mu) * mul + b


def ln_matmul_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                    w: torch.Tensor, wb: Optional[torch.Tensor],
                    eps: float = LN_EPS) -> torch.Tensor:
    """Plain version of fused_ln_matmul on x (T, C), w (C, O)."""
    cdt = x.dtype
    xn = ln_rows(x.float(), g.float(), b.float(), eps).to(cdt).float()
    y = xn @ w.to(cdt).float()
    if wb is not None:
        y = y + wb.float()
    return y.to(cdt)


def ln_mlp_residual_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                          w1: torch.Tensor, b1: torch.Tensor,
                          w2: torch.Tensor, b2: torch.Tensor,
                          eps: float = LN_EPS) -> torch.Tensor:
    """Plain version of fused_ln_mlp_residual on x (T, C)."""
    cdt = x.dtype
    xf = x.float()
    xn = ln_rows(xf, g.float(), b.float(), eps).to(cdt).float()
    h = (xn @ w1.to(cdt).float() + b1.float()).to(cdt).float()
    h = torch.nn.functional.gelu(h).to(cdt).float()
    return (xf + (h @ w2.to(cdt).float() + b2.float())).to(cdt)


def _check(name: str, x: torch.Tensor, *tensors: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    for t in (x,) + tensors:
        if t.device != x.device:
            raise ValueError(f"{name}: tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def _flat(x: torch.Tensor) -> torch.Tensor:
    if not x.is_contiguous():
        raise ValueError("token kernels need a contiguous x")
    return x.reshape(-1, x.shape[-1])


def fused_ln_matmul(x: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], *,
                    eps: float = LN_EPS) -> torch.Tensor:
    """x (..., C) → LN(x) @ w + b, (..., O) in x's dtype; b may be None."""
    refuse_autograd("fused_ln_matmul", _NO_BWD, x, ln_scale, ln_bias, w, b)
    lead, c = x.shape[:-1], x.shape[-1]
    out_dim = w.shape[1]
    if w.shape[0] != c:
        raise ValueError(f"w {tuple(w.shape)} does not take width {c}")
    x2 = _flat(x)
    if x.device.type == "cpu":
        return ln_matmul_plain(x2, ln_scale, ln_bias, w, b, eps) \
            .reshape(*lead, out_dim)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    w = w.to(x.dtype).contiguous()
    g = ln_scale.float().contiguous()
    bl = ln_bias.float().contiguous()
    wb = b.float().contiguous() if b is not None else None
    _check("fused_ln_matmul", x2, g, bl, w, *([wb] if wb is not None else []))
    t = x2.shape[0]
    y = torch.empty(t, out_dim, dtype=x.dtype, device=x.device)
    if t == 0:
        return y.reshape(*lead, out_dim)
    fn = _build.function("ln_matmul", "tt_ln_matmul", [ctypes.c_void_p] * 6 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(x2), _build.ptr(g), _build.ptr(bl), _build.ptr(w),
                _build.ptr(wb) if wb is not None else None, _build.ptr(y),
                t, c, out_dim, eps, int(x.dtype == torch.bfloat16),
                _build.stream_ptr(x.device))
    _build.check("ln_matmul", status, "fused_ln_matmul")
    fused_ln_matmul.launches += 1
    return y.reshape(*lead, out_dim)


fused_ln_matmul.launches = 0


def fused_ln_mlp_residual(x: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, *,
                          eps: float = LN_EPS) -> torch.Tensor:
    """x (..., C) → x + fc2(gelu(fc1(LN(x)))) in x's dtype; the 4C hidden
    layer never leaves the kernel."""
    refuse_autograd("fused_ln_mlp_residual", _NO_BWD, x, ln_scale, ln_bias,
                    w1, b1, w2, b2)
    c = x.shape[-1]
    hdim = w1.shape[1]
    if w1.shape[0] != c or tuple(w2.shape) != (hdim, c):
        raise ValueError(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do "
                         f"not take width {c}")
    x2 = _flat(x)
    if x.device.type == "cpu":
        return ln_mlp_residual_plain(x2, ln_scale, ln_bias, w1, b1, w2, b2,
                                     eps).reshape(x.shape)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if c % 4:
        raise ValueError(f"fused_ln_mlp_residual needs C % 4 == 0, got {c}")
    w1 = w1.to(x.dtype).contiguous()
    w2 = w2.to(x.dtype).contiguous()
    g = ln_scale.float().contiguous()
    bl = ln_bias.float().contiguous()
    b1 = b1.float().contiguous()
    b2 = b2.float().contiguous()
    _check("fused_ln_mlp_residual", x2, g, bl, w1, b1, w2, b2)
    t = x2.shape[0]
    y = torch.empty_like(x2)
    if t == 0:
        return y.reshape(x.shape)
    fn = _build.function("ln_mlp", "tt_ln_mlp_residual", [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(x2), _build.ptr(g), _build.ptr(bl), _build.ptr(w1),
                _build.ptr(b1), _build.ptr(w2), _build.ptr(b2), _build.ptr(y),
                t, c, hdim, eps, int(x.dtype == torch.bfloat16),
                _build.stream_ptr(x.device))
    _build.check("ln_mlp", status, "fused_ln_mlp_residual")
    fused_ln_mlp_residual.launches += 1
    return y.reshape(x.shape)


fused_ln_mlp_residual.launches = 0
