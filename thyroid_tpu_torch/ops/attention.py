"""Swin window attention (counterpart of thyroid_tpu/ops/attention.py).

- `fused_swin_block_attention` is the serving half-block — window
  partition, W-MSA with relative-position bias and shift mask, window
  reverse, out-projection, bias and residual — in one CUDA kernel
  (`csrc/swin_attention.cu`; in bf16 the attention on TF32 tensor cores
  and the projection on wgmma), forward only.
- `fused_swin_attention` is the training (and eval) W-MSA without the
  projection, differentiable: a `torch.autograd.Function` pairs the forward
  kernel (`csrc/swin_attention.cu`) with a backward kernel
  (`csrc/swin_attention_bwd.cu`) that recomputes the softmax from the saved
  inputs, as the JAX custom_vjp does; in bf16 both on TF32 tensor cores.
- `fused_swin_ln_attention` is the LN + QKV + shifted W-MSA serving
  variant on the raw stream (`csrc/swin_ln_attention.cu`; bf16 projection
  on wgmma and attention on TF32 tensor cores), forward only;
  `WindowAttention(ln_kernel=True)` reaches it.
- `fused_window_attention` is the per-window MSA on separate q/k/v
  (`csrc/window_attention.cu`; in bf16 at head widths that are multiples
  of 16 up to 64 on wgmma, `window_attention_route`), forward only.

Each kernel is an op (`thyroid_tpu_torch::swin_block_attention`,
`swin_attention`, `swin_attention_bwd`, `swin_ln_attention`,
`window_attention`; ops/_build.py `define_op`) that runs it on CUDA tensors
and its plain PyTorch version (`swin_block_attention_plain`,
`swin_attention_plain`, `swin_attention_bwd_plain`,
`swin_ln_attention_plain`, `window_attention_reference`) on CPU tensors.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .platform import refuse_autograd

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_TOKENS = 64   # the kernel's row layout covers windows up to 8 x 8
_MAX_LN_WIDTH = 1536  # the bf16 LN + QKV + W-MSA kernel's widest row
_LN_RESIDENT_WIDTH = 1024  # above it the bf16 kernel normalises into a workspace


def window_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, bias: torch.Tensor,
                               mask: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v (BW, h, N, d), bias (h, N, N), mask (nW, N, N) or None, window
    b taking mask[b % nW] → (BW, h, N, d) in q's dtype, computed in
    float32: q·scale, scores + bias (+ mask), e = exp(s − max),
    P = e / Σe, P v. The plain version of fused_window_attention."""
    bw, h, n, d = q.shape
    if scale is None:
        scale = d ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    scores = scores + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        scores = (scores.reshape(bw // nw, nw, h, n, n)
                  + mask[None, :, None].float()).reshape(bw, h, n, n)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def window_attention_route(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> str:
    """Which kernel `thyroid_tpu_torch::window_attention` launches on these
    CUDA q, k, v, as `csrc/window_attention.cu` chooses: "wgmma" for bf16
    at a head width d that is a multiple of 16 up to 64 (Swin's 32) with
    q, k and v 16-byte aligned, "scalar" for float32 and every other bf16
    head width (24, 40, 80, ...). A query for the card's checks; CPU
    tensors take window_attention_reference."""
    fn = _build.function("window_attention", "tt_window_attention_route",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
    tc = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), q.shape[-1],
            int(q.dtype == torch.bfloat16))
    return "wgmma" if tc else "scalar"


def _window_cpu(q, k, v, bias, mask, scale):
    return window_attention_reference(q, k, v, bias, mask, scale).contiguous()


def _f32(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return t.float().contiguous() if t is not None else None


def _window_fake(q, k, v, bias, mask, scale):
    _check_cuda("fused_window_attention", q, q.shape[2], k, v, _f32(bias),
                _f32(mask))
    return torch.empty_like(q)


def _window_cuda(q, k, v, bias, mask, scale):
    bw, h, n, d = q.shape
    bias_f, mask_f = _f32(bias), _f32(mask)
    _check_cuda("fused_window_attention", q, n, k, v, bias_f, mask_f)
    out = torch.empty_like(q)
    if bw == 0:
        return out
    fn = _build.function("window_attention", "tt_window_attention",
                         [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(bias_f),
                _build.ptr(mask_f) if mask_f is not None else None,
                _build.ptr(out), bw, h, n, d,
                mask.shape[0] if mask is not None else 1, float(scale),
                int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check("window_attention", status, "fused_window_attention")
    _build.count_launch(fused_window_attention)
    return out


_window_op = _build.define_op(
    "window_attention(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? mask, "
    "float scale) -> Tensor",
    cpu=_window_cpu, cuda=_window_cuda, fake=_window_fake)


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None,
                           window_tile: int = 16) -> torch.Tensor:
    """Per-window MSA: q/k/v (BW, h, N, d), bias (h, N, N), mask (nW, N, N)
    additive or None (BW % nW == 0; window b takes mask[b % nW]) →
    (BW, h, N, d) in q's dtype. N ≤ 64 on the card. Forward only.
    `window_tile` is accepted and ignored: it tiled the TPU grid.

    On the card, bf16 at head widths that are multiples of 16 up to 64
    runs on the tensor cores (wgmma): S from bf16 q and k accumulated in
    float32, then scaled; the softmax in float32 with e^x as __expf and one
    reciprocal a row; P rounded to bf16 for P v. float32, and bf16 at any
    other head width, keep the scalar float32 kernel. `window_attention_route`
    says which; a build or launch error raises, never falls back."""
    del window_tile
    refuse_autograd("fused_window_attention", "the JAX kernel has no "
                    "autodiff either", q, k, v, bias, mask)
    bw, h, n, d = q.shape
    for name, t in (("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} does not "
                             f"match q {q.dtype} {tuple(q.shape)}")
    if tuple(bias.shape) != (h, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} is not {(h, n, n)}")
    if mask is not None and (mask.dim() != 3 or mask.shape[1:] != (n, n)
                             or bw % mask.shape[0]):
        raise ValueError(f"mask {tuple(mask.shape)} is not (nW, {n}, {n}) "
                         f"with nW dividing {bw}")
    if scale is None:
        scale = d ** -0.5
    return _window_op(q, k, v, bias, mask, float(scale))


fused_window_attention.launches = 0


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


def _check_windows(qkv: torch.Tensor, bias: torch.Tensor,
                   mask: Optional[torch.Tensor], ws: int, num_heads: int) -> None:
    b, hh, ww, three, c = qkv.shape
    n = ws * ws
    if three != 3:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (B, H, W, 3, C)")
    if hh % ws or ww % ws or c % num_heads:
        raise ValueError(f"({hh}, {ww}, {c}) does not tile into {ws}x{ws} "
                         f"windows of {num_heads} heads")
    nw = (hh // ws) * (ww // ws)
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} is not "
                         f"{(num_heads, n, n)}")
    if mask is not None and tuple(mask.shape) != (nw, n, n):
        raise ValueError(f"mask {tuple(mask.shape)} is not {(nw, n, n)}")


def _check_cuda(name: str, qkv: torch.Tensor, n: int, *tensors) -> None:
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16, got {qkv.dtype}")
    if n > _MAX_TOKENS:
        raise ValueError(f"window of {n} tokens: {name} takes at most "
                         f"{_MAX_TOKENS}")
    for t in (qkv,) + tensors:
        if t is None:
            continue
        if t.device != qkv.device:
            raise ValueError(f"{name}: tensors on {t.device} and {qkv.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def _window_heads(x: torch.Tensor, ws: int, num_heads: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, heads, N, C/heads) float32, windows in
    row-major order."""
    c = x.shape[-1]
    win = window_partition(x.float(), ws)
    return win.reshape(win.shape[0], ws * ws, num_heads, c // num_heads) \
        .transpose(1, 2)


def _heads_window(o: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """The inverse of _window_heads: (B·nW, heads, N, dh) → (B, H, W, C)."""
    bw, heads, n, dh = o.shape
    return window_reverse(o.transpose(1, 2).reshape(bw, n, heads * dh), ws, h, w)


def _probs(q: torch.Tensor, k: torch.Tensor, bias: torch.Tensor,
           mask: Optional[torch.Tensor]) -> torch.Tensor:
    """softmax(q_s kᵀ + bias (+ mask)) over (B·nW, heads, N, N) in float32;
    q is already scaled; mask (nW, N, N) is indexed by the window's index
    inside its image."""
    bw, heads, n, _ = q.shape
    s = q @ k.transpose(-1, -2) + bias[None].float()
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(bw // nw, nw, heads, n, n)
             + mask[None, :, None].float()).reshape(bw, heads, n, n)
    return torch.softmax(s, dim=-1)


def swin_attention_plain(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor], *, window_size: int,
                         num_heads: int, scale: float) -> torch.Tensor:
    """Plain version of fused_swin_attention's forward: W-MSA in float32 on
    qkv (B, H, W, 3, C), the output (B, H, W, C) in qkv's dtype."""
    b, hh, ww, _, c = qkv.shape
    ws = window_size
    q, k, v = (_window_heads(qkv[:, :, :, i], ws, num_heads) for i in range(3))
    o = _probs(q * scale, k, bias, mask) @ v
    return _heads_window(o, ws, hh, ww).to(qkv.dtype)


def swin_attention_bwd_plain(qkv: torch.Tensor, dout: torch.Tensor,
                             bias: torch.Tensor,
                             mask: Optional[torch.Tensor], *,
                             window_size: int, num_heads: int,
                             scale: float):
    """Plain version of fused_swin_attention's backward, by the explicit
    formulas in float32 (q_s = q·scale, P recomputed):
    dV = Pᵀ dO, dP = dO Vᵀ, dS = P ⊙ (dP − rowsum(dP ⊙ P)),
    dQ = scale·dS K, dK = dSᵀ q_s, dBias = Σ over batch and windows of dS.
    dout (B, H, W, C) → (dqkv (B, H, W, 3, C) in qkv's dtype,
    dbias (heads, N, N) float32)."""
    b, hh, ww, _, c = qkv.shape
    ws = window_size
    q, k, v = (_window_heads(qkv[:, :, :, i], ws, num_heads) for i in range(3))
    do = _window_heads(dout, ws, num_heads)
    qs = q * scale
    p = _probs(qs, k, bias, mask)
    dv = p.transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = (ds @ k) * scale
    dk = ds.transpose(-1, -2) @ qs
    dqkv = torch.stack([_heads_window(t, ws, hh, ww) for t in (dq, dk, dv)],
                       dim=3).to(qkv.dtype)
    return dqkv, ds.sum(dim=0)


def _swin_fwd_cpu(qkv, bias, mask, window_size, num_heads, scale):
    return swin_attention_plain(qkv, bias, mask, window_size=window_size,
                                num_heads=num_heads, scale=scale).contiguous()


def _swin_fwd_fake(qkv, bias, mask, window_size, num_heads, scale):
    _check_cuda("fused_swin_attention", qkv, window_size ** 2, _f32(bias),
                _f32(mask))
    b, hh, ww, _, c = qkv.shape
    return qkv.new_empty(b, hh, ww, c)


def _swin_fwd_cuda(qkv, bias, mask, window_size, num_heads, scale):
    b, hh, ww, _, c = qkv.shape
    bias_f, mask_f = _f32(bias), _f32(mask)
    _check_cuda("fused_swin_attention", qkv, window_size ** 2, bias_f, mask_f)
    out = torch.empty(b, hh, ww, c, dtype=qkv.dtype, device=qkv.device)
    if b == 0:
        return out
    fn = _build.function("swin_attention", "tt_swin_attention",
                         [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(qkv), _build.ptr(bias_f),
                _build.ptr(mask_f) if mask_f is not None else None,
                _build.ptr(out), b, hh, ww, c, num_heads, window_size,
                float(scale), int(qkv.dtype == torch.bfloat16),
                _build.stream_ptr(qkv.device))
    _build.check("swin_attention", status, "fused_swin_attention")
    _build.count_launch(fused_swin_attention)
    return out


_swin_fwd_op = _build.define_op(
    "swin_attention(Tensor qkv, Tensor bias, Tensor? mask, int window_size, "
    "int num_heads, float scale) -> Tensor",
    cpu=_swin_fwd_cpu, cuda=_swin_fwd_cuda, fake=_swin_fwd_fake)


def _check_swin_bwd(qkv, dout, bias, mask, window_size):
    b, hh, ww, _, c = qkv.shape
    _check_cuda("fused_swin_attention backward", qkv, window_size ** 2, dout,
                bias, mask)
    if dout.dtype != qkv.dtype or tuple(dout.shape) != (b, hh, ww, c):
        raise ValueError(f"dout {dout.dtype} {tuple(dout.shape)} does not "
                         f"match qkv {qkv.dtype} {tuple(qkv.shape)}")


def _swin_bwd_cpu(qkv, dout, bias, mask, window_size, num_heads, scale):
    dqkv, dbias = swin_attention_bwd_plain(qkv, dout, bias, mask,
                                           window_size=window_size,
                                           num_heads=num_heads, scale=scale)
    return dqkv.contiguous(), dbias.contiguous()


def _swin_bwd_fake(qkv, dout, bias, mask, window_size, num_heads, scale):
    _check_swin_bwd(qkv, dout, _f32(bias), _f32(mask), window_size)
    n = window_size ** 2
    return (torch.empty_like(qkv),
            qkv.new_empty(num_heads, n, n, dtype=torch.float32))


def _swin_bwd_cuda(qkv, dout, bias, mask, window_size, num_heads, scale):
    b, hh, ww, _, c = qkv.shape
    n = window_size ** 2
    bias_f, mask_f = _f32(bias), _f32(mask)
    _check_swin_bwd(qkv, dout, bias_f, mask_f, window_size)
    dqkv = torch.empty_like(qkv)
    dbias = torch.zeros(num_heads, n, n, dtype=torch.float32, device=qkv.device)
    if b == 0:
        return dqkv, dbias
    is_bf16 = int(qkv.dtype == torch.bfloat16)
    lib = _build.library("swin_attention_bwd")
    groups_fn = lib.tt_swin_bwd_groups
    groups_fn.argtypes = [ctypes.c_int] * 4
    groups_fn.restype = ctypes.c_int
    windows = b * (hh // window_size) * (ww // window_size)
    groups = groups_fn(windows, num_heads, c // num_heads, is_bf16)
    partial = torch.empty(num_heads, groups, n, n, dtype=torch.float32,
                          device=qkv.device)
    fn = _build.function("swin_attention_bwd", "tt_swin_attention_bwd",
                         [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(qkv), _build.ptr(dout), _build.ptr(bias_f),
                _build.ptr(mask_f) if mask_f is not None else None,
                _build.ptr(dqkv), _build.ptr(dbias), _build.ptr(partial),
                b, hh, ww, c, num_heads, window_size, float(scale), is_bf16,
                _build.stream_ptr(qkv.device))
    _build.check("swin_attention_bwd", status, "fused_swin_attention backward")
    _build.count_launch(fused_swin_attention, "bwd_launches")
    return dqkv, dbias


_swin_bwd_op = _build.define_op(
    "swin_attention_bwd(Tensor qkv, Tensor dout, Tensor bias, Tensor? mask, "
    "int window_size, int num_heads, float scale) -> (Tensor, Tensor)",
    cpu=_swin_bwd_cpu, cuda=_swin_bwd_cuda, fake=_swin_bwd_fake)


def fused_swin_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor,
                             bias: torch.Tensor, mask: Optional[torch.Tensor],
                             *, window_size: int, num_heads: int,
                             scale: float):
    """The backward of fused_swin_attention, given the output gradient
    dout (B, H, W, C) in qkv's dtype → (dqkv (B, H, W, 3, C) in qkv's dtype,
    dbias (heads, N, N) float32), through
    `thyroid_tpu_torch::swin_attention_bwd`. Its launches count on
    fused_swin_attention.bwd_launches."""
    return _swin_bwd_op(qkv, dout, bias, mask, int(window_size),
                        int(num_heads), float(scale))


class _SwinAttention(torch.autograd.Function):
    """custom_vjp of the JAX package: the residuals are the inputs (qkv,
    bias, mask), never the probabilities; the backward recomputes them."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, window_size, num_heads, scale):
        ctx.save_for_backward(qkv, bias, mask)
        ctx.cfg = dict(window_size=window_size, num_heads=num_heads,
                       scale=scale)
        return _swin_fwd_op(qkv, bias, mask, window_size, num_heads, scale)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        qkv, bias, mask = ctx.saved_tensors
        # the incoming gradient rounded to qkv's dtype, as _swin_attn_ad_bwd
        dqkv, dbias = fused_swin_attention_bwd(
            qkv, grad.to(qkv.dtype).contiguous(), bias, mask, **ctx.cfg)
        return dqkv, dbias.to(bias.dtype), None, None, None, None


def fused_swin_attention(qkv: torch.Tensor, bias: torch.Tensor,
                         mask: Optional[torch.Tensor] = None, *,
                         window_size: int, num_heads: int,
                         scale: Optional[float] = None,
                         rows_per_step: Optional[int] = None) -> torch.Tensor:
    """qkv (B, H, W, 3, C) — already LN'd, projected and rolled if shifted;
    bias (heads, N, N) the gathered relative-position bias; mask (nW, N, N)
    shift mask or None → (B, H, W, C) attention output in qkv's dtype,
    windows already reversed.

    Differentiable in qkv and bias (dqkv in qkv's dtype, dbias in bias's);
    the mask gets no gradient. `rows_per_step` is accepted and ignored: it
    tiled the TPU grid."""
    del rows_per_step
    _check_windows(qkv, bias, mask, window_size, num_heads)
    if scale is None:
        scale = (qkv.shape[-1] // num_heads) ** -0.5
    return _SwinAttention.apply(qkv, bias, mask, window_size, num_heads,
                                float(scale))


fused_swin_attention.launches = 0
fused_swin_attention.bwd_launches = 0


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


def _block_args(qkv, residual, proj_kernel, proj_bias, bias, mask,
                num_heads):
    """The kernel's operands after its checks: the projection in qkv's
    dtype, its bias, the position bias and the mask in float32."""
    c = qkv.shape[-1]
    if residual.dtype != qkv.dtype:
        raise TypeError(f"residual {residual.dtype} != qkv {qkv.dtype}")
    dh = c // num_heads
    if qkv.dtype == torch.bfloat16 and (dh % 8 or dh > 64):
        raise ValueError(f"head width {dh}: the bf16 kernel takes head widths "
                         f"that are multiples of 8 up to 64")
    wp = proj_kernel.to(qkv.dtype).contiguous()
    bp = (proj_bias.float() if proj_bias is not None
          else torch.zeros(c, dtype=torch.float32, device=qkv.device)).contiguous()
    bias, mask_f = _f32(bias), _f32(mask)
    _check_cuda("fused_swin_block_attention", qkv, bias.shape[-1], residual,
                wp, bp, bias, mask_f)
    return wp, bp, bias, mask_f


def _block_cpu(qkv, residual, proj_kernel, proj_bias, bias, mask, window_size,
               num_heads, scale):
    return swin_block_attention_plain(
        qkv, residual, proj_kernel, proj_bias, bias, mask,
        window_size=window_size, num_heads=num_heads, scale=scale).contiguous()


def _block_fake(qkv, residual, proj_kernel, proj_bias, bias, mask,
                window_size, num_heads, scale):
    _block_args(qkv, residual, proj_kernel, proj_bias, bias, mask, num_heads)
    return torch.empty_like(residual)


def _block_cuda(qkv, residual, proj_kernel, proj_bias, bias, mask, window_size,
                num_heads, scale):
    wp, bp, bias, mask_f = _block_args(qkv, residual, proj_kernel, proj_bias,
                                       bias, mask, num_heads)
    b, hh, ww, _, c = qkv.shape
    is_bf16 = int(qkv.dtype == torch.bfloat16)
    y = torch.empty_like(residual)
    if b == 0:
        return y
    # float32: the attention's output before the projection
    work = None if is_bf16 else torch.empty(b, hh, ww, c, dtype=torch.float32,
                                            device=qkv.device)
    fn = _build.function("swin_attention", "tt_swin_block_attention",
                         [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(qkv), _build.ptr(residual), _build.ptr(wp),
                _build.ptr(bp), _build.ptr(bias),
                _build.ptr(mask_f) if mask_f is not None else None,
                _build.ptr(y), _build.ptr(work) if work is not None else None,
                b, hh, ww, c, num_heads, window_size, float(scale), is_bf16,
                _build.stream_ptr(qkv.device))
    _build.check("swin_attention", status, "fused_swin_block_attention")
    _build.count_launch(fused_swin_block_attention)
    return y


_block_op = _build.define_op(
    "swin_block_attention(Tensor qkv, Tensor residual, Tensor proj_kernel, "
    "Tensor? proj_bias, Tensor bias, Tensor? mask, int window_size, "
    "int num_heads, float scale) -> Tensor",
    cpu=_block_cpu, cuda=_block_cuda, fake=_block_fake)


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
    → (B, H, W, C) in qkv's dtype
    (`thyroid_tpu_torch::swin_block_attention`)."""
    refuse_autograd("fused_swin_block_attention", "training uses "
                    "fused_swin_attention, as in the JAX package, where this "
                    "serving call has no autodiff", qkv, residual,
                    proj_kernel, proj_bias, bias)
    b, hh, ww, _, c = qkv.shape
    _check_windows(qkv, bias, mask, window_size, num_heads)
    if tuple(residual.shape) != (b, hh, ww, c):
        raise ValueError(f"qkv {tuple(qkv.shape)} / residual "
                         f"{tuple(residual.shape)} do not match")
    if scale is None:
        scale = (c // num_heads) ** -0.5
    return _block_op(qkv, residual, proj_kernel, proj_bias, bias, mask,
                     int(window_size), int(num_heads), float(scale))


fused_swin_block_attention.launches = 0


def swin_ln_attention_plain(x: torch.Tensor, ln_scale: torch.Tensor,
                            ln_bias: torch.Tensor, qkv_kernel: torch.Tensor,
                            qkv_bias: Optional[torch.Tensor],
                            bias: torch.Tensor,
                            mask: Optional[torch.Tensor], *,
                            window_size: int, num_heads: int, scale: float,
                            eps: float = 1e-5) -> torch.Tensor:
    """Plain version of fused_swin_ln_attention, in the JAX kernel's order:
    LayerNorm in float32 with the fast variance max(0, E[x²] − μ²),
    (x − μ)·rsqrt(var + eps)·γ + β, rounded to x's dtype; q/k/v = xn W
    accumulated in float32 (W rounded to x's dtype) plus the float32 QKV
    bias; q·scale in float32; W-MSA in float32 (softmax e / Σe); the
    output (B, H, W, C) in x's dtype."""
    b, hh, ww, c = x.shape
    ws, cdt = window_size, x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    xn = (xf - mu) * torch.rsqrt(var + eps)
    xn = (xn * ln_scale.float() + ln_bias.float()).to(cdt).float()
    qkv = xn @ qkv_kernel.to(cdt).float()
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.float()
    q, k, v = (_window_heads(qkv[..., i * c:(i + 1) * c], ws, num_heads)
               for i in range(3))
    o = window_attention_reference(q * scale, k, v, bias, mask, scale=1.0)
    return _heads_window(o, ws, hh, ww).to(cdt)


def _ln_attention_args(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, bias,
                       mask, num_heads):
    """The kernel's operands after its checks: LN parameters, QKV bias,
    position bias and mask in float32, the QKV kernel in x's dtype."""
    c = x.shape[-1]
    dh = c // num_heads
    if x.dtype == torch.bfloat16 and (dh % 8 or dh > 64 or c > _MAX_LN_WIDTH):
        raise ValueError(f"width {c}, head width {dh}: the bf16 kernel takes C "
                         f"up to {_MAX_LN_WIDTH} and head widths that are "
                         f"multiples of 8 up to 64")
    args = (ln_scale.float().contiguous(), ln_bias.float().contiguous(),
            qkv_kernel.to(x.dtype).contiguous(),
            _f32(qkv_bias), _f32(bias), _f32(mask))
    _check_cuda("fused_swin_ln_attention", x, bias.shape[-1], *args)
    return args


def _ln_attention_cpu(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, bias, mask,
                      window_size, num_heads, scale, eps):
    return swin_ln_attention_plain(
        x, ln_scale, ln_bias, qkv_kernel, qkv_bias, bias, mask,
        window_size=window_size, num_heads=num_heads, scale=scale,
        eps=eps).contiguous()


def _ln_attention_fake(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, bias, mask,
                       window_size, num_heads, scale, eps):
    _ln_attention_args(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, bias, mask,
                       num_heads)
    return torch.empty_like(x)


def _ln_attention_cuda(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, bias, mask,
                       window_size, num_heads, scale, eps):
    g, beta, w, bq, bias_f, mask_f = _ln_attention_args(
        x, ln_scale, ln_bias, qkv_kernel, qkv_bias, bias, mask, num_heads)
    b, hh, ww, c = x.shape
    out = torch.empty_like(x)
    if b == 0:
        return out
    # the normalised rows, which the bf16 kernel streams above C = 1024
    work = torch.empty(b * hh * ww * c, dtype=x.dtype, device=x.device) \
        if x.dtype == torch.bfloat16 and c > _LN_RESIDENT_WIDTH else None
    fn = _build.function("swin_ln_attention", "tt_swin_ln_attention",
                         [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
                         + [ctypes.c_float, ctypes.c_float, ctypes.c_int,
                            ctypes.c_void_p])
    status = fn(_build.ptr(x), _build.ptr(g), _build.ptr(beta), _build.ptr(w),
                _build.ptr(bq) if bq is not None else None, _build.ptr(bias_f),
                _build.ptr(mask_f) if mask_f is not None else None,
                _build.ptr(out), _build.ptr(work) if work is not None else None,
                b, hh, ww, c, num_heads, window_size, float(scale),
                float(eps), int(x.dtype == torch.bfloat16),
                _build.stream_ptr(x.device))
    _build.check("swin_ln_attention", status, "fused_swin_ln_attention")
    _build.count_launch(fused_swin_ln_attention)
    return out


_ln_attention_op = _build.define_op(
    "swin_ln_attention(Tensor x, Tensor ln_scale, Tensor ln_bias, "
    "Tensor qkv_kernel, Tensor? qkv_bias, Tensor bias, Tensor? mask, "
    "int window_size, int num_heads, float scale, float eps) -> Tensor",
    cpu=_ln_attention_cpu, cuda=_ln_attention_cuda, fake=_ln_attention_fake)


def fused_swin_ln_attention(x: torch.Tensor, ln_scale: torch.Tensor,
                            ln_bias: torch.Tensor, qkv_kernel: torch.Tensor,
                            qkv_bias: Optional[torch.Tensor],
                            bias: torch.Tensor,
                            mask: Optional[torch.Tensor] = None, *,
                            window_size: int, num_heads: int,
                            scale: Optional[float] = None,
                            eps: float = 1e-5) -> torch.Tensor:
    """LN + QKV + W-MSA in one serving kernel: x (B, H, W, C) the raw
    residual stream, already rolled if shifted; ln_scale, ln_bias (C,);
    qkv_kernel (C, 3C); qkv_bias (3C,) or None; bias (heads, N, N) the
    gathered relative-position bias; mask (nW, N, N) or None → (B, H, W, C)
    attention output before the out-projection, in x's dtype
    (`thyroid_tpu_torch::swin_ln_attention`). Forward only: training keeps
    fused_swin_attention, as in the JAX package."""
    refuse_autograd("fused_swin_ln_attention", "training uses "
                    "fused_swin_attention, as in the JAX package", x,
                    ln_scale, ln_bias, qkv_kernel, qkv_bias, bias)
    b, hh, ww, c = x.shape
    ws, n = window_size, window_size * window_size
    if hh % ws or ww % ws or c % num_heads:
        raise ValueError(f"({hh}, {ww}, {c}) does not tile into {ws}x{ws} "
                         f"windows of {num_heads} heads")
    if tuple(qkv_kernel.shape) != (c, 3 * c):
        raise ValueError(f"qkv_kernel {tuple(qkv_kernel.shape)} is not "
                         f"{(c, 3 * c)}")
    nw = (hh // ws) * (ww // ws)
    if tuple(bias.shape) != (num_heads, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} is not {(num_heads, n, n)}")
    if mask is not None and tuple(mask.shape) != (nw, n, n):
        raise ValueError(f"mask {tuple(mask.shape)} is not {(nw, n, n)}")
    if scale is None:
        scale = (c // num_heads) ** -0.5
    return _ln_attention_op(x, ln_scale, ln_bias, qkv_kernel, qkv_bias, bias,
                            mask, int(ws), int(num_heads), float(scale),
                            float(eps))


fused_swin_ln_attention.launches = 0
