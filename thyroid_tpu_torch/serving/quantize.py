"""Int8 post-training-quantized serving (counterpart of
thyroid_tpu/serving/quantize.py).

Under `int8_serving()` every eligible flax nn.Dense / nn.Conv call site of
the port's models computes

    y = (q(x) :: s8 · q(W) :: s8) :: s32 · (s_x · s_w)  (+ bias in float32)

with a dynamic per-tensor activation scale s_x = max|x| / 127 and static
per-output-channel weight scales s_w = max|W| / 127, both float32, values
rounded half to even (`torch.round`, as `jnp.round`) and clipped to ±127.
The result is cast to the layer's dtype. Weights are quantized on every
call from the live float32 parameters, so any variable tree serves
quantized as it is.

Which calls: the JAX package intercepts `nn.Dense.__call__` and
`nn.Conv.__call__` only. The port's models route exactly those call sites
through `dense_site` / `conv_site` (`models/layers.py` `dense_layer`,
`models/cnn/efficientnet.py` `conv_nhwc` and `pointwise`, the patch
embeddings); the math JAX writes out from raw parameters (Swin's qkv, MLP
and merge reduction, and everything inside a kernel) stays float. A
layer is eligible when both its contraction sides reach `min_features`
and, for a convolution, it is not grouped (unless `skip_depthwise` is
off). JAX's gate on dilation has nothing to act on here: no conv of the
port's models is dilated, and `conv_site` takes no dilation.

The int32 contraction is `torch._int_mm` (cuBLASLt's int8 GEMM on the
card, exact integer arithmetic on the CPU); JAX computes it outside any
kernel too (`lax.dot_general` / `conv_general_dilated` with an int32
result). A convolution is an explicit zero pad with JAX's padding rule,
an im2col of the int8 values and one such product. The card's `_int_mm`
wants more than 16 rows and K and N multiples of 8: `int_matmul` pads
with zero rows and columns, which leaves the product exact.

The switch is a context variable, so it holds for the thread (or
context) that entered it: `InferenceEngine.run` enters it around each
forward, in whichever thread runs the forward (the BatchAggregator's
worker included).

CAVEAT, as in JAX: s_x is global over the batch, so a request's
probabilities depend on the requests it was batched with. A mesh engine
(serving/engine.py) runs a bucket as shards, one thread each: under
`exchanging` every shard's max|x| is combined into the bucket's before
each layer quantizes (`MaxExchange`), so s_x stays global over the whole
bucket, padding rows included, as JAX's global array gives it.
"""
from __future__ import annotations

import contextvars
import dataclasses
import threading
from contextlib import contextmanager
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
from torch.nn import functional as F


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """What to quantize.

    min_features: skip layers whose contraction is thinner than this on
        either side (classifier heads, squeeze convs of narrow blocks).
    skip_depthwise: leave grouped convs (depthwise MBConv stages) alone.
    accumulate_int32: the s8×s8→s32 product (False dequantizes before a
        float32 product, for numerics A/B only).
    """

    min_features: int = 32
    skip_depthwise: bool = True
    accumulate_int32: bool = True


_CONFIG: contextvars.ContextVar[Optional[QuantConfig]] = \
    contextvars.ContextVar("int8_serving", default=None)
# observer(kernel, a, b, y) of every int32 product: the layer's float
# kernel parameter, the int8 operands a (M, K) and b (K, N), the int32 y
Observer = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], None]
_OBSERVER: contextvars.ContextVar[Optional[Observer]] = \
    contextvars.ContextVar("int8_observer", default=None)


class MaxExchange:
    """The bucket's max|x| from its `n` shards' threads: each layer's
    `combine` waits for every shard's maximum and gives each the largest
    (exact), on its own device. A shard that fails breaks the barrier, so
    the others raise instead of waiting."""

    def __init__(self, n: int, timeout: float = 600.0):
        self.n = n
        self.slots: list = [None] * n
        self.barrier = threading.Barrier(n, timeout=timeout)

    def combine(self, shard: int, amax: torch.Tensor) -> torch.Tensor:
        self.slots[shard] = amax
        self.barrier.wait()
        out = torch.stack([s.to(amax.device) for s in self.slots]).amax()
        self.barrier.wait()          # every shard has read the slots
        return out

    def abort(self) -> None:
        self.barrier.abort()


_EXCHANGE: contextvars.ContextVar[Optional[Tuple[MaxExchange, int]]] = \
    contextvars.ContextVar("int8_exchange", default=None)


@contextmanager
def exchanging(exchange: Optional[MaxExchange], shard: int):
    """Inside, shard `shard` of a bucket takes its activation scales from
    `exchange` (None: its own maxima)."""
    token = _EXCHANGE.set(None if exchange is None else (exchange, shard))
    try:
        yield
    finally:
        _EXCHANGE.reset(token)


@contextmanager
def int8_serving(cfg: Optional[QuantConfig] = None):
    """Every eligible nn.Dense / nn.Conv call site inside runs in int8:

        with int8_serving():
            logits = model(x)
    """
    token = _CONFIG.set(cfg or QuantConfig())
    try:
        yield
    finally:
        _CONFIG.reset(token)


@contextmanager
def observing(observer: Observer):
    """Hand every int32 product computed inside to `observer` (the tests
    record which layers were quantized; the card's check records the
    operands)."""
    token = _OBSERVER.set(observer)
    try:
        yield
    finally:
        _OBSERVER.reset(token)


def quantized_apply(model: torch.nn.Module, *args,
                    cfg: Optional[QuantConfig] = None, **kwargs):
    """One-shot helper: `model(*args, **kwargs)` under `int8_serving`. The
    port's model holds its weights, so there is no `variables` argument."""
    with int8_serving(cfg):
        return model(*args, **kwargs)


def _quantize_weight(w: torch.Tensor, out_axis: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: (w_q, s_w) with w ≈ w_q · s_w
    along `out_axis`; s_w has shape (w.shape[out_axis],)."""
    wf = w.float()
    axes = tuple(i for i in range(w.dim()) if i != out_axis)
    s = torch.clamp_min(wf.abs().amax(dim=axes) / 127.0, 1e-12)
    shape = [1] * w.dim()
    shape[out_axis] = w.shape[out_axis]
    wq = torch.clamp(torch.round(wf / s.reshape(shape)), -127, 127).to(torch.int8)
    return wq, s


def _quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric dynamic per-tensor int8: (x_q, s_x), s_x a 0-d tensor."""
    xf = x.float()
    amax = xf.abs().amax()
    shared = _EXCHANGE.get()
    if shared is not None:
        amax = shared[0].combine(shared[1], amax)
    s = torch.clamp_min(amax / 127.0, 1e-12)
    xq = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return xq, s


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 a (M, K) and b (K, N) through
    `torch._int_mm` in the card's shapes (`padded_int_mm`) on every
    device, so that a program traced on the CPU serves on the card."""
    return padded_int_mm(a, b)


def padded_int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """`torch._int_mm` under the card's shape rules: rows padded past 16
    and K and N to multiples of 8 with zeros (the product stays exact),
    a row-major, b column-major."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = max(_round_up(m, 8), 24), _round_up(k, 8), _round_up(n, 8)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    bt = b.t()
    if (np_, kp) != (n, k):
        bt = F.pad(bt, (0, kp - k, 0, np_ - n))
    y = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return y[:m, :n]


def _product(kernel: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = int_matmul(a, b)
    observer = _OBSERVER.get()
    if observer is not None:
        observer(kernel, a, b, y)
    return y


def _finish(y: torch.Tensor, scale: Optional[torch.Tensor],
            bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """float32 product (· scale) (+ float32 bias) → dtype."""
    y = y.float()
    if scale is not None:
        y = y * scale
    if bias is not None:
        y = y + bias.float()
    return y.to(dtype)


def dense_eligible(x: torch.Tensor, kernel: torch.Tensor, cfg: QuantConfig) -> bool:
    return x.shape[-1] >= cfg.min_features and kernel.shape[1] >= cfg.min_features


def conv_eligible(x: torch.Tensor, kernel: torch.Tensor, groups: int,
                  cfg: QuantConfig) -> bool:
    if groups > 1 and cfg.skip_depthwise:
        return False
    cin = x.shape[-1] // groups
    return cin >= cfg.min_features and kernel.shape[0] >= cfg.min_features


def dense_int8(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
               dtype: torch.dtype, cfg: QuantConfig) -> torch.Tensor:
    """JAX's `_dense_int8`: x (..., K) against the (K, N) kernel."""
    wq, sw = _quantize_weight(kernel, out_axis=1)
    xq, sx = _quantize_act(x)
    a = xq.reshape(-1, x.shape[-1])
    if cfg.accumulate_int32:
        y = _finish(_product(kernel, a, wq), sx * sw, bias, dtype)
    else:
        y = _finish((a.float() * sx) @ (wq.float() * sw), None, bias, dtype)
    return y.reshape(*x.shape[:-1], kernel.shape[1])


Padding = Any   # "SAME", "VALID", an int, or one int / (lo, hi) per spatial dim


def conv_pads(padding: Padding, size: Sequence[int], k: Sequence[int],
              stride: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """(lo, hi) per spatial dim by lax's rule: "SAME" pads
    max((ceil(n / s) - 1)·s + k - n, 0) split with the smaller half low."""
    if isinstance(padding, str):
        if padding == "VALID":
            return tuple((0, 0) for _ in size)
        if padding != "SAME":
            raise ValueError(f"padding {padding!r} is not SAME or VALID")
        pads = []
        for n, kk, s in zip(size, k, stride):
            total = max((-(-n // s) - 1) * s + kk - n, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    if isinstance(padding, int):
        return tuple((padding, padding) for _ in size)
    return tuple((p, p) if isinstance(p, int) else (int(p[0]), int(p[1]))
                 for p in padding)


def _pair(v) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: Tuple[int, int],
            pads) -> Tuple[torch.Tensor, int, int]:
    """NHWC x → (B·Ho·Wo, kh·kw·C) patches in (kh, kw, C) order, and
    (Ho, Wo); x zero-padded by `pads` first."""
    b, h, w, c = x.shape
    (pt, pb), (pl, pr) = pads
    if pt or pb or pl or pr:
        xp = x.new_zeros(b, h + pt + pb, w + pl + pr, c)
        xp[:, pt:pt + h, pl:pl + w] = x
        x = xp
    sh, sw = stride
    ho, wo = (x.shape[1] - kh) // sh + 1, (x.shape[2] - kw) // sw + 1
    if (kh, kw, sh, sw) == (1, 1, 1, 1):
        return x.reshape(-1, c), ho, wo
    s0, s1, s2, s3 = x.stride()
    cols = x.as_strided((b, ho, wo, kh, kw, c), (s0, sh * s1, sw * s2, s1, s2, s3))
    return cols.reshape(b * ho * wo, kh * kw * c), ho, wo


def conv_int8(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
              dtype: torch.dtype, cfg: QuantConfig, stride: Any = 1,
              padding: Padding = 0, groups: int = 1) -> torch.Tensor:
    """JAX's `_conv_int8` on NHWC x with the port's (out, in / groups, kh,
    kw) kernel → NHWC in `dtype`. Grouped convolutions (only with
    skip_depthwise off) take one product per group."""
    o, cin_g, kh, kw = kernel.shape
    stride = _pair(stride)
    pads = conv_pads(padding, x.shape[1:3], (kh, kw), stride)
    wq, sw = _quantize_weight(kernel, out_axis=0)
    xq, sx = _quantize_act(x)
    b = x.shape[0]
    if not cfg.accumulate_int32:
        xd = F.pad((xq.float() * sx).permute(0, 3, 1, 2),
                   (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
        y = F.conv2d(xd, wq.float() * sw.reshape(-1, 1, 1, 1), stride=stride,
                     groups=groups).permute(0, 2, 3, 1)
        return _finish(y, None, bias, dtype)
    o_g = o // groups
    outs = []
    for g in range(groups):
        xg = xq if groups == 1 else xq[..., g * cin_g:(g + 1) * cin_g]
        a, ho, wo = _im2col(xg, kh, kw, stride, pads)
        wg = wq[g * o_g:(g + 1) * o_g].permute(2, 3, 1, 0).reshape(kh * kw * cin_g, o_g)
        outs.append(_product(kernel, a, wg))
    y = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return _finish(y, sx * sw, bias, dtype).reshape(b, ho, wo, o)


def dense_site(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
               dtype: torch.dtype) -> Optional[torch.Tensor]:
    """An nn.Dense call site: its int8 result under `int8_serving` when
    the layer is eligible, else None (the caller computes it in float)."""
    cfg = _CONFIG.get()
    if cfg is None or not dense_eligible(x, kernel, cfg):
        return None
    return dense_int8(x, kernel, bias, dtype, cfg)


def conv_site(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
              dtype: torch.dtype, stride: Any = 1, padding: Padding = 0,
              groups: int = 1) -> Optional[torch.Tensor]:
    """An nn.Conv call site on NHWC x: as `dense_site`."""
    cfg = _CONFIG.get()
    if cfg is None or not conv_eligible(x, kernel, groups, cfg):
        return None
    return conv_int8(x, kernel, bias, dtype, cfg, stride, padding, groups)
