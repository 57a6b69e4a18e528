"""Token-major fused LN kernels (counterpart of thyroid_tpu/ops/token_fused.py).

- `fused_ln_matmul`:        y = LN(x) @ W + b              (csrc/ln_matmul.cu;
                            bf16 on wgmma tensor cores)
- `fused_ln_mlp_residual`:  y = x + fc2(gelu(fc1(LN(x))))  (csrc/ln_mlp.cu;
                            bf16 on wgmma tensor cores, csrc/mlp_tc.cuh)
- `fused_ln_mlp`:           y = fc2(gelu(fc1(LN(x))))      (training: DropPath
                            and the skip stay outside; the same kernel)

All three are differentiable, as the JAX custom_vjps are: a
`torch.autograd.Function` saves the inputs, and its backward recomputes the
LN statistics (and, for the MLP, the 4C hidden layer) in the backward
kernels, so neither direction keeps a hidden tensor in global memory:
- `fused_ln_matmul_bwd`: dX, dγ, dβ of LN + matmul (csrc/ln_matmul_bwd.cu;
  bf16 on wgmma tensor cores); dW = LN(x)ᵀ dY and db = ΣdY are plain
  products, as JAX leaves them to XLA;
- `fused_ln_mlp_bwd_dx`: dX, dγ, dβ of LN + MLP (csrc/ln_mlp_bwd.cu; bf16
  on wgmma tensor cores);
- `fused_ln_mlp_bwd_dw`: dW1, db1, dW2 of LN + MLP (csrc/ln_mlp_bwd.cu; bf16
  on wgmma tensor cores); db2 = ΣdY is a plain sum, as in JAX.

Each kernel is an op (`thyroid_tpu_torch::ln_matmul`, `ln_mlp`,
`ln_matmul_bwd`, `ln_mlp_bwd_dx`, `ln_mlp_bwd_dw`; ops/_build.py
`define_op`) that launches it on CUDA tensors and runs its plain PyTorch
version (`ln_matmul_plain`, `ln_mlp_plain`, `ln_matmul_bwd_plain`,
`ln_mlp_bwd_plain`) on CPU tensors. The compute dtype is x's dtype: weights
are cast to it, LN parameters and biases to float32, as the JAX wrappers
do. LN follows flax's fast-variance numerics in float32; intermediate
activations are rounded to the compute dtype where the JAX kernels round
them, and every product accumulates in float32. The backward kernels take
every width C that JAX's do (rows past 768, swin_base's and swin_large's
last stage, take their wide path: csrc/token_bwd.cuh `ln_bwd_wide`); the
only refusal left is a dY whose shape or dtype does not match.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build

LN_EPS = 1e-5
_DTYPES = (torch.float32, torch.bfloat16)


def ln_rows(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
            eps: float = LN_EPS) -> torch.Tensor:
    """flax LayerNorm numerics on the last axis, float32 in and out:
    fast variance E[x²]−μ² clamped at 0, mul = rsqrt(var+eps)·γ."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * g
    return (x - mu) * mul + b


def ln_stats(x: torch.Tensor, eps: float = LN_EPS):
    """(x̂, rstd) of float32 rows for the LN backward, the same numerics."""
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    r = torch.rsqrt(var + eps)
    return (x - mu) * r, r


def ln_bwd_rows(dxn: torch.Tensor, xhat: torch.Tensor, r: torch.Tensor,
                g: torch.Tensor) -> torch.Tensor:
    """dX of y = x̂·γ + β given dXn, x̂ and rstd (float32 rows)."""
    dxh = dxn * g
    m1 = dxh.mean(dim=-1, keepdim=True)
    m2 = (dxh * xhat).mean(dim=-1, keepdim=True)
    return r * (dxh - m1 - xhat * m2)


def gelu_grad(h: torch.Tensor) -> torch.Tensor:
    """d/dh gelu(h) = Φ(h) + h·φ(h), exact erf (the JAX kernels' erf is
    Abramowitz–Stegun's, 1.5e-7 from it)."""
    cdf = 0.5 * (1.0 + torch.erf(h * math.sqrt(0.5)))
    return cdf + h * torch.exp(-0.5 * h * h) * (1.0 / math.sqrt(2.0 * math.pi))


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


def ln_mlp_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                 w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                 b2: torch.Tensor, eps: float = LN_EPS,
                 residual: bool = False) -> torch.Tensor:
    """Plain version of fused_ln_mlp (and, with `residual`, of
    fused_ln_mlp_residual) on x (T, C)."""
    cdt = x.dtype
    xf = x.float()
    xn = ln_rows(xf, g.float(), b.float(), eps).to(cdt).float()
    h = (xn @ w1.to(cdt).float() + b1.float()).to(cdt).float()
    h = torch.nn.functional.gelu(h).to(cdt).float()
    y = h @ w2.to(cdt).float() + b2.float()
    return (xf + y if residual else y).to(cdt)


def ln_mlp_residual_plain(x, g, b, w1, b1, w2, b2,
                          eps: float = LN_EPS) -> torch.Tensor:
    """Plain version of fused_ln_mlp_residual on x (T, C)."""
    return ln_mlp_plain(x, g, b, w1, b1, w2, b2, eps, residual=True)


def ln_matmul_bwd_plain(x: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                        dy: torch.Tensor, eps: float = LN_EPS):
    """Plain version of fused_ln_matmul_bwd: x (T, C), w (C, O), dy (T, O)
    in the compute dtype → (dX in it, dγ, dβ float32)."""
    cdt = x.dtype
    xhat, r = ln_stats(x.float(), eps)
    dxn = dy.to(cdt).float() @ w.to(cdt).float().t()
    dx = ln_bwd_rows(dxn, xhat, r, g.float()).to(cdt)
    return dx, (dxn * xhat).sum(dim=0), dxn.sum(dim=0)


def _mlp_bwd_hidden(x, g, b, w1, b1, w2, dy, eps, acc=torch.float32):
    """What both halves of the plain LN + MLP backward start from, in
    `acc` (float32): (x̂, rstd, LN(x) rebuilt as x̂·γ + β and rounded, the
    hidden pre-activation, dH, dY)."""
    cdt = x.dtype
    xhat, r = ln_stats(x.to(acc), eps)
    w1c, w2c = w1.to(cdt).to(acc), w2.to(cdt).to(acc)
    xn = (xhat * g.to(acc) + b.to(acc)).to(cdt).to(acc)
    hr = (xn @ w1c + b1.to(acc)).to(cdt).to(acc)
    dyf = dy.to(cdt).to(acc)
    dh = ((dyf @ w2c.t()) * gelu_grad(hr)).to(cdt).to(acc)
    return xhat, r, xn, hr, dh, dyf


def _mlp_bwd_dx_from(x, g, w1, residual, hidden):
    xhat, r, _, _, dh, dyf = hidden
    dxn = dh @ w1.to(x.dtype).to(dh.dtype).t()
    dx = ln_bwd_rows(dxn, xhat, r, g.to(dh.dtype))
    if residual:
        dx = dx + dyf
    return dx.to(x.dtype), (dxn * xhat).sum(dim=0), dxn.sum(dim=0)


def _mlp_bwd_dw_from(x, hidden):
    _, _, xn, hr, dh, dyf = hidden
    a = torch.nn.functional.gelu(hr).to(x.dtype).to(dh.dtype)
    return xn.t() @ dh, dh.sum(dim=0), a.t() @ dyf


def ln_mlp_bwd_dx_plain(x, g, b, w1, b1, w2, dy, residual: bool,
                        eps: float = LN_EPS):
    """dX in x's dtype, dγ, dβ float32 of the LN + MLP (the first kernel's
    outputs); with `residual`, dX gains dy."""
    return _mlp_bwd_dx_from(x, g, w1, residual,
                            _mlp_bwd_hidden(x, g, b, w1, b1, w2, dy, eps))


def ln_mlp_bwd_dw_plain(x, g, b, w1, b1, w2, dy, eps: float = LN_EPS):
    """dW1, db1, dW2 float32 of the LN + MLP (the second kernel's)."""
    return _mlp_bwd_dw_from(x, _mlp_bwd_hidden(x, g, b, w1, b1, w2, dy, eps))


def ln_mlp_bwd_plain(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                     w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                     dy: torch.Tensor, residual: bool, eps: float = LN_EPS,
                     acc: torch.dtype = torch.float32):
    """Plain version of the LN + MLP backward (both kernels): x, dy (T, C)
    in the compute dtype → (dX in it, dγ, dβ, dW1, db1, dW2 float32). The
    LN is rebuilt as x̂·γ + β, as the JAX backward rebuilds it, once for
    both halves. `acc` torch.float64 evaluates the same roundings to the
    compute dtype with float64 products and sums (and gives the sums in
    float64): the yardstick of how far the float32 sums themselves stand
    from exact."""
    hidden = _mlp_bwd_hidden(x, g, b, w1, b1, w2, dy, eps, acc)
    return (_mlp_bwd_dx_from(x, g, w1, residual, hidden)
            + _mlp_bwd_dw_from(x, hidden))


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


def _groups(lib: str, symbol: str, *sizes: int) -> int:
    fn = _build.function(lib, symbol, [ctypes.c_int] * len(sizes))
    return fn(*sizes)


def _workspace(lib: str, symbol: str, device, *sizes: int) -> torch.Tensor:
    """The scratch bytes a launch asks for (in bf16 the normalised rows,
    f32 partials over hidden splits and, for widths that are not multiples
    of 8, zero-padded operand copies; in float32 none up to C = 768, and the
    backward's normalised rows, dXn and row statistics past it)."""
    fn = getattr(_build.library(lib), symbol)
    fn.argtypes = [ctypes.c_int] * len(sizes)
    fn.restype = ctypes.c_longlong
    return torch.empty(max(int(fn(*sizes)), 1), dtype=torch.uint8,
                       device=device)


# ---------------------------------------------------------------- forward


def _ln_matmul_args(x2, g, b, w, wb):
    """The kernel's operands: w in x's dtype, LN parameters and bias in
    float32, all contiguous, after the wrapper's checks."""
    w = w.to(x2.dtype).contiguous()
    g = g.float().contiguous()
    bl = b.float().contiguous()
    wb = wb.float().contiguous() if wb is not None else None
    _check("fused_ln_matmul", x2, g, bl, w, *([wb] if wb is not None else []))
    return g, bl, w, wb


def _ln_matmul_cpu(x2, g, b, w, wb, eps):
    return ln_matmul_plain(x2, g, b, w, wb, eps).contiguous()


def _ln_matmul_fake(x2, g, b, w, wb, eps):
    _ln_matmul_args(x2, g, b, w, wb)
    return x2.new_empty(x2.shape[0], w.shape[1])


def _ln_matmul_cuda(x2, g, b, w, wb, eps):
    g, bl, w, wb = _ln_matmul_args(x2, g, b, w, wb)
    t, c = x2.shape
    out_dim = w.shape[1]
    y = torch.empty(t, out_dim, dtype=x2.dtype, device=x2.device)
    if t == 0:
        return y
    is_bf16 = int(x2.dtype == torch.bfloat16)
    ws = _workspace("ln_matmul", "tt_ln_matmul_workspace", x2.device, t, c,
                    out_dim, is_bf16)
    fn = _build.function("ln_matmul", "tt_ln_matmul", [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(x2), _build.ptr(g), _build.ptr(bl), _build.ptr(w),
                _build.ptr(wb) if wb is not None else None, _build.ptr(y),
                _build.ptr(ws), t, c, out_dim, eps, is_bf16,
                _build.stream_ptr(x2.device))
    _build.check("ln_matmul", status, "fused_ln_matmul")
    fused_ln_matmul.launches += 1
    return y


_ln_matmul_op = _build.define_op(
    "ln_matmul(Tensor x, Tensor g, Tensor b, Tensor w, Tensor? wb, "
    "float eps) -> Tensor",
    cpu=_ln_matmul_cpu, cuda=_ln_matmul_cuda, fake=_ln_matmul_fake)


def _ln_mlp_args(x2, g, b, w1, b1, w2, b2, residual):
    name = "fused_ln_mlp_residual" if residual else "fused_ln_mlp"
    if x2.shape[1] % 4:
        raise ValueError(f"{name} needs C % 4 == 0, got {x2.shape[1]}")
    args = (w1.to(x2.dtype).contiguous(), w2.to(x2.dtype).contiguous(),
            g.float().contiguous(), b.float().contiguous(),
            b1.float().contiguous(), b2.float().contiguous())
    _check(name, x2, *args)
    return args


def _ln_mlp_cpu(x2, g, b, w1, b1, w2, b2, eps, residual):
    return ln_mlp_plain(x2, g, b, w1, b1, w2, b2, eps, residual).contiguous()


def _ln_mlp_fake(x2, g, b, w1, b1, w2, b2, eps, residual):
    _ln_mlp_args(x2, g, b, w1, b1, w2, b2, residual)
    return torch.empty_like(x2)


def _ln_mlp_cuda(x2, g, b, w1, b1, w2, b2, eps, residual):
    w1, w2, g, bl, b1, b2 = _ln_mlp_args(x2, g, b, w1, b1, w2, b2, residual)
    t, c = x2.shape
    hdim = w1.shape[1]
    y = torch.empty_like(x2)
    if t == 0:
        return y
    is_bf16 = int(x2.dtype == torch.bfloat16)
    ws = _workspace("ln_mlp", "tt_ln_mlp_workspace", x2.device, t, c, hdim,
                    is_bf16)
    fn = _build.function("ln_mlp", "tt_ln_mlp", [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(x2), _build.ptr(g), _build.ptr(bl), _build.ptr(w1),
                _build.ptr(b1), _build.ptr(w2), _build.ptr(b2), _build.ptr(y),
                _build.ptr(ws), t, c, hdim, eps, int(residual), is_bf16,
                _build.stream_ptr(x2.device))
    _build.check("ln_mlp", status,
                 "fused_ln_mlp_residual" if residual else "fused_ln_mlp")
    (fused_ln_mlp_residual if residual else fused_ln_mlp).launches += 1
    return y


_ln_mlp_op = _build.define_op(
    "ln_mlp(Tensor x, Tensor g, Tensor b, Tensor w1, Tensor b1, Tensor w2, "
    "Tensor b2, float eps, bool residual) -> Tensor",
    cpu=_ln_mlp_cpu, cuda=_ln_mlp_cuda, fake=_ln_mlp_fake)


# ---------------------------------------------------------------- backward


def _check_bwd(name: str, x2: torch.Tensor, dy: torch.Tensor, width: int) -> None:
    # no width limit: JAX's backward kernels take any C, and so do these
    if dy.dtype != x2.dtype or tuple(dy.shape) != (x2.shape[0], width):
        raise ValueError(f"dy {dy.dtype} {tuple(dy.shape)} does not match x "
                         f"{x2.dtype} {tuple(x2.shape)}")


def _ln_matmul_bwd_args(x2, g, w, dy):
    _check_bwd("fused_ln_matmul_bwd", x2, dy, w.shape[1])
    w = w.to(x2.dtype).contiguous()
    g = g.float().contiguous()
    _check("fused_ln_matmul_bwd", x2, g, w, dy)
    return g, w


def _ln_matmul_bwd_cpu(x2, g, w, dy, eps):
    dx, dg, db = ln_matmul_bwd_plain(x2, g, w, dy, eps)
    return dx.contiguous(), torch.stack([dg, db])


def _ln_matmul_bwd_fake(x2, g, w, dy, eps):
    _ln_matmul_bwd_args(x2, g, w, dy)
    return (torch.empty_like(x2),
            x2.new_empty(2, x2.shape[1], dtype=torch.float32))


def _ln_matmul_bwd_cuda(x2, g, w, dy, eps):
    g, w = _ln_matmul_bwd_args(x2, g, w, dy)
    t, c = x2.shape
    out_dim = w.shape[1]
    dx = torch.empty_like(x2)
    dgb = torch.zeros(2, c, dtype=torch.float32, device=x2.device)
    if t == 0:
        return dx, dgb
    is_bf16 = int(x2.dtype == torch.bfloat16)
    partial = torch.empty(_groups("ln_matmul_bwd", "tt_ln_bwd_groups", t, c,
                                  is_bf16), 2, c, dtype=torch.float32,
                          device=x2.device)
    ws = _workspace("ln_matmul_bwd", "tt_ln_matmul_bwd_workspace", x2.device,
                    t, c, out_dim, is_bf16)
    fn = _build.function("ln_matmul_bwd", "tt_ln_matmul_bwd",
                         [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(x2), _build.ptr(g), _build.ptr(w), _build.ptr(dy),
                _build.ptr(dx), _build.ptr(partial), _build.ptr(dgb),
                _build.ptr(ws), t, c, out_dim, eps, is_bf16,
                _build.stream_ptr(x2.device))
    _build.check("ln_matmul_bwd", status, "fused_ln_matmul_bwd")
    fused_ln_matmul_bwd.launches += 1
    return dx, dgb


_ln_matmul_bwd_op = _build.define_op(
    "ln_matmul_bwd(Tensor x, Tensor g, Tensor w, Tensor dy, float eps) "
    "-> (Tensor, Tensor)",
    cpu=_ln_matmul_bwd_cpu, cuda=_ln_matmul_bwd_cuda,
    fake=_ln_matmul_bwd_fake)


def fused_ln_matmul_bwd(x2: torch.Tensor, g: torch.Tensor, w: torch.Tensor,
                        dy: torch.Tensor, *, eps: float = LN_EPS):
    """dX, dγ, dβ of fused_ln_matmul: x2 (T, C), w (C, O) and the output
    gradient dy (T, O) in the compute dtype → (dX (T, C) in it, dγ (C,),
    dβ (C,) float32), through `thyroid_tpu_torch::ln_matmul_bwd`."""
    dx, dgb = _ln_matmul_bwd_op(x2, g, w, dy, float(eps))
    return dx, dgb[0], dgb[1]


fused_ln_matmul_bwd.launches = 0


def _mlp_bwd_args(name, x2, g, b, w1, b1, w2, dy):
    _check_bwd(name, x2, dy, x2.shape[1])
    args = (x2, g.float().contiguous(), b.float().contiguous(),
            w1.to(x2.dtype).contiguous(), b1.float().contiguous(),
            w2.to(x2.dtype).contiguous(), dy)
    _check(name, *args)
    return args


def _ln_mlp_bwd_dx_cpu(x2, g, b, w1, b1, w2, dy, residual, eps):
    dx, dg, db = ln_mlp_bwd_dx_plain(x2, g, b, w1, b1, w2, dy, residual, eps)
    return dx.contiguous(), torch.stack([dg, db])


def _ln_mlp_bwd_dx_fake(x2, g, b, w1, b1, w2, dy, residual, eps):
    _mlp_bwd_args("fused_ln_mlp_bwd_dx", x2, g, b, w1, b1, w2, dy)
    return (torch.empty_like(x2),
            x2.new_empty(2, x2.shape[1], dtype=torch.float32))


def _ln_mlp_bwd_dx_cuda(x2, g, b, w1, b1, w2, dy, residual, eps):
    args = _mlp_bwd_args("fused_ln_mlp_bwd_dx", x2, g, b, w1, b1, w2, dy)
    t, c = x2.shape
    hdim = w1.shape[1]
    dx = torch.empty_like(x2)
    dgb = torch.zeros(2, c, dtype=torch.float32, device=x2.device)
    if t == 0:
        return dx, dgb
    is_bf16 = int(x2.dtype == torch.bfloat16)
    partial = torch.empty(_groups("ln_mlp_bwd", "tt_ln_mlp_bwd_dx_groups", t,
                                  c, is_bf16), 2, c, dtype=torch.float32,
                          device=x2.device)
    ws = _workspace("ln_mlp_bwd", "tt_ln_mlp_bwd_dx_workspace", x2.device, t,
                    c, hdim, is_bf16)
    fn = _build.function("ln_mlp_bwd", "tt_ln_mlp_bwd_dx",
                         [ctypes.c_void_p] * 11 + [ctypes.c_int] * 3
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                            ctypes.c_void_p])
    status = fn(*(_build.ptr(a) for a in args), _build.ptr(dx),
                _build.ptr(partial), _build.ptr(dgb), _build.ptr(ws), t, c,
                hdim, eps, int(residual), is_bf16, _build.stream_ptr(x2.device))
    _build.check("ln_mlp_bwd", status, "fused_ln_mlp_bwd_dx")
    fused_ln_mlp_bwd_dx.launches += 1
    return dx, dgb


_ln_mlp_bwd_dx_op = _build.define_op(
    "ln_mlp_bwd_dx(Tensor x, Tensor g, Tensor b, Tensor w1, Tensor b1, "
    "Tensor w2, Tensor dy, bool residual, float eps) -> (Tensor, Tensor)",
    cpu=_ln_mlp_bwd_dx_cpu, cuda=_ln_mlp_bwd_dx_cuda,
    fake=_ln_mlp_bwd_dx_fake)


def fused_ln_mlp_bwd_dx(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                        w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        dy: torch.Tensor, *, residual: bool,
                        eps: float = LN_EPS):
    """dX, dγ, dβ of the LN + MLP (kernel `_ln_mlp_bwd_dx_kernel` of the
    JAX package): x2, dy (T, C) in the compute dtype → (dX in it, dγ, dβ
    float32); with `residual`, dX gains dy. Through
    `thyroid_tpu_torch::ln_mlp_bwd_dx`."""
    dx, dgb = _ln_mlp_bwd_dx_op(x2, g, b, w1, b1, w2, dy, bool(residual),
                                float(eps))
    return dx, dgb[0], dgb[1]


fused_ln_mlp_bwd_dx.launches = 0


def _ln_mlp_bwd_dw_cpu(x2, g, b, w1, b1, w2, dy, eps):
    dw1, db1, dw2 = ln_mlp_bwd_dw_plain(x2, g, b, w1, b1, w2, dy, eps)
    return torch.cat([dw1.reshape(-1), dw2.reshape(-1), db1])


def _ln_mlp_bwd_dw_fake(x2, g, b, w1, b1, w2, dy, eps):
    _mlp_bwd_args("fused_ln_mlp_bwd_dw", x2, g, b, w1, b1, w2, dy)
    c, hdim = w1.shape
    return x2.new_empty(2 * c * hdim + hdim, dtype=torch.float32)


def _ln_mlp_bwd_dw_cuda(x2, g, b, w1, b1, w2, dy, eps):
    args = _mlp_bwd_args("fused_ln_mlp_bwd_dw", x2, g, b, w1, b1, w2, dy)
    t, c = x2.shape
    hdim = w1.shape[1]
    out = torch.zeros(2 * c * hdim + hdim, dtype=torch.float32, device=x2.device)
    if t == 0:
        return out
    is_bf16 = int(x2.dtype == torch.bfloat16)
    groups = _groups("ln_mlp_bwd", "tt_ln_mlp_bwd_dw_groups", t, c, hdim,
                     is_bf16)
    if groups < 1:
        raise RuntimeError("fused_ln_mlp_bwd_dw: the CUDA occupancy query "
                           "failed")
    partial = torch.empty(groups, out.numel(), dtype=torch.float32,
                          device=x2.device)
    ws = _workspace("ln_mlp_bwd", "tt_ln_mlp_bwd_dw_workspace", x2.device, t,
                    c, hdim, is_bf16)
    fn = _build.function("ln_mlp_bwd", "tt_ln_mlp_bwd_dw",
                         [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    status = fn(*(_build.ptr(a) for a in args), _build.ptr(partial),
                _build.ptr(out), _build.ptr(ws), t, c, hdim, eps, is_bf16,
                _build.stream_ptr(x2.device))
    _build.check("ln_mlp_bwd", status, "fused_ln_mlp_bwd_dw")
    fused_ln_mlp_bwd_dw.launches += 1
    return out


_ln_mlp_bwd_dw_op = _build.define_op(
    "ln_mlp_bwd_dw(Tensor x, Tensor g, Tensor b, Tensor w1, Tensor b1, "
    "Tensor w2, Tensor dy, float eps) -> Tensor",
    cpu=_ln_mlp_bwd_dw_cpu, cuda=_ln_mlp_bwd_dw_cuda,
    fake=_ln_mlp_bwd_dw_fake)


def fused_ln_mlp_bwd_dw(x2: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
                        w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor,
                        dy: torch.Tensor, *, eps: float = LN_EPS):
    """dW1 (C, Hd), db1 (Hd,), dW2 (Hd, C) of the LN + MLP, float32
    (kernel `_ln_mlp_bwd_dw_kernel` of the JAX package), views of the one
    output of `thyroid_tpu_torch::ln_mlp_bwd_dw`."""
    out = _ln_mlp_bwd_dw_op(x2, g, b, w1, b1, w2, dy, float(eps))
    c, hdim = w1.shape
    return (out[:c * hdim].view(c, hdim), out[2 * c * hdim:],
            out[c * hdim:2 * c * hdim].view(hdim, c))


fused_ln_mlp_bwd_dw.launches = 0


def _ln_mlp_bwd_cpu(x2, g, b, w1, b1, w2, dy, residual, eps):
    dx, dg, db, dw1, db1, dw2 = ln_mlp_bwd_plain(x2, g, b, w1, b1, w2, dy,
                                                 residual, eps)
    return (dx.contiguous(), torch.stack([dg, db]),
            torch.cat([dw1.reshape(-1), dw2.reshape(-1), db1]))


def _ln_mlp_bwd_fake(x2, g, b, w1, b1, w2, dy, residual, eps):
    return (_ln_mlp_bwd_dx_fake(x2, g, b, w1, b1, w2, dy, residual, eps)
            + (_ln_mlp_bwd_dw_fake(x2, g, b, w1, b1, w2, dy, eps),))


def _ln_mlp_bwd_cuda(x2, g, b, w1, b1, w2, dy, residual, eps):
    return (_ln_mlp_bwd_dx_cuda(x2, g, b, w1, b1, w2, dy, residual, eps)
            + (_ln_mlp_bwd_dw_cuda(x2, g, b, w1, b1, w2, dy, eps),))


# both kernels of the LN + MLP backward in one op, so that the plain
# version (ln_mlp_bwd_plain) rebuilds the hidden layer once for both
_ln_mlp_bwd_op = _build.define_op(
    "ln_mlp_bwd(Tensor x, Tensor g, Tensor b, Tensor w1, Tensor b1, "
    "Tensor w2, Tensor dy, bool residual, float eps) "
    "-> (Tensor, Tensor, Tensor)",
    cpu=_ln_mlp_bwd_cpu, cuda=_ln_mlp_bwd_cuda, fake=_ln_mlp_bwd_fake)


def ln_mlp_bwd(x2, g, b, w1, b1, w2, dy, *, residual: bool,
               eps: float = LN_EPS):
    """The whole LN + MLP backward → (dX, dγ, dβ, dW1, db1, dW2): kernels 10
    and 11 through `thyroid_tpu_torch::ln_mlp_bwd`."""
    dx, dgb, out = _ln_mlp_bwd_op(x2, g, b, w1, b1, w2, dy, bool(residual),
                                  float(eps))
    c, hdim = w1.shape
    return (dx, dgb[0], dgb[1], out[:c * hdim].view(c, hdim),
            out[2 * c * hdim:], out[c * hdim:2 * c * hdim].view(hdim, c))


# ---------------------------------------------------------------- autograd


class _LnMatmul(torch.autograd.Function):
    """custom_vjp of the JAX package: the residuals are the inputs; the
    backward recomputes the LN statistics in its kernel."""

    @staticmethod
    def forward(ctx, x2, g, b, w, wb, eps):
        ctx.save_for_backward(x2, g, b, w)
        ctx.eps = eps
        ctx.wb_dtype = wb.dtype if wb is not None else None
        return _ln_matmul_op(x2, g, b, w, wb, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x2, g, b, w = ctx.saved_tensors
        cdt = x2.dtype
        dy = grad.to(cdt).contiguous()        # rounded as _ln_matmul_ad_bwd does
        dx, dg, dbl = fused_ln_matmul_bwd(x2, g, w, dy, eps=ctx.eps)
        # dW = LN(x)ᵀ dY and dwb = ΣdY: plain products, as XLA's in JAX
        xn = ln_rows(x2.float(), g.float(), b.float(), ctx.eps).to(cdt)
        dw = xn.float().t() @ dy.float()
        dwb = grad.float().sum(dim=0).to(ctx.wb_dtype) \
            if ctx.wb_dtype is not None else None
        return (dx, dg.to(g.dtype), dbl.to(b.dtype), dw.to(w.dtype), dwb,
                None)


class _LnMlp(torch.autograd.Function):
    """custom_vjp of the JAX package's LN + MLP, with or without the
    residual: the residuals are the inputs; both backward kernels rebuild
    the hidden layer."""

    @staticmethod
    def forward(ctx, x2, g, b, w1, b1, w2, b2, eps, residual):
        ctx.save_for_backward(x2, g, b, w1, b1, w2)
        ctx.eps, ctx.residual, ctx.b2_dtype = eps, residual, b2.dtype
        return _ln_mlp_op(x2, g, b, w1, b1, w2, b2, eps, residual)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x2, g, b, w1, b1, w2 = ctx.saved_tensors
        dy = grad.to(x2.dtype).contiguous()   # rounded as _ln_mlp_ad_bwd does
        dx, dg, dbl, dw1, db1, dw2 = ln_mlp_bwd(
            x2, g, b, w1, b1, w2, dy, residual=ctx.residual, eps=ctx.eps)
        db2 = dy.float().sum(dim=0)
        return (dx, dg.to(g.dtype), dbl.to(b.dtype), dw1.to(w1.dtype),
                db1.to(b1.dtype), dw2.to(w2.dtype), db2.to(ctx.b2_dtype),
                None, None)


def fused_ln_matmul(x: torch.Tensor, ln_scale: torch.Tensor,
                    ln_bias: torch.Tensor, w: torch.Tensor,
                    b: Optional[torch.Tensor], *,
                    eps: float = LN_EPS) -> torch.Tensor:
    """x (..., C) → LN(x) @ w + b, (..., O) in x's dtype; b may be None.
    Differentiable (dX, dγ, dβ from `fused_ln_matmul_bwd`)."""
    lead, c = x.shape[:-1], x.shape[-1]
    out_dim = w.shape[1]
    if w.shape[0] != c:
        raise ValueError(f"w {tuple(w.shape)} does not take width {c}")
    return _LnMatmul.apply(_flat(x), ln_scale, ln_bias, w, b, float(eps)) \
        .reshape(*lead, out_dim)


fused_ln_matmul.launches = 0


def _ln_mlp_apply(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, residual):
    c = x.shape[-1]
    hdim = w1.shape[1]
    if w1.shape[0] != c or tuple(w2.shape) != (hdim, c):
        raise ValueError(f"w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} do "
                         f"not take width {c}")
    return _LnMlp.apply(_flat(x), ln_scale, ln_bias, w1, b1, w2, b2,
                        float(eps), residual).reshape(x.shape)


def fused_ln_mlp_residual(x: torch.Tensor, ln_scale: torch.Tensor,
                          ln_bias: torch.Tensor, w1: torch.Tensor,
                          b1: torch.Tensor, w2: torch.Tensor,
                          b2: torch.Tensor, *,
                          eps: float = LN_EPS) -> torch.Tensor:
    """x (..., C) → x + fc2(gelu(fc1(LN(x)))) in x's dtype; the 4C hidden
    layer never leaves the kernel. Differentiable."""
    return _ln_mlp_apply(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, True)


fused_ln_mlp_residual.launches = 0


def fused_ln_mlp(x: torch.Tensor, ln_scale: torch.Tensor,
                 ln_bias: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                 w2: torch.Tensor, b2: torch.Tensor, *,
                 eps: float = LN_EPS) -> torch.Tensor:
    """The training variant without the residual add: x (..., C) →
    fc2(gelu(fc1(LN(x)))) in x's dtype, so DropPath and the skip stay
    outside. Differentiable."""
    return _ln_mlp_apply(x, ln_scale, ln_bias, w1, b1, w2, b2, eps, False)


fused_ln_mlp.launches = 0
