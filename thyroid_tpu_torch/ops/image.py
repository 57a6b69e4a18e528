"""Batched image ops on the serving path (counterpart of thyroid_tpu/ops/image.py).

Only the main-path subset: uint16 coercion, the cv2-rule bilinear resize,
the bisection quantile, per-image adaptive normalisation and
standardisation. Images are NHWC float32, as in the JAX package.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

UINT16_MAX = 65535.0


def to_uint16_scale(x: torch.Tensor) -> torch.Tensor:
    """uint8/uint16/float → float32 on the uint16 value scale (uint8 ×257,
    so 255 → 65535)."""
    if x.dtype == torch.uint8:
        return x.to(torch.float32) * 257.0
    return x.to(torch.float32)


def normalize_uint16(x: torch.Tensor) -> torch.Tensor:
    """uint16 scale → [0, 1]."""
    return x / UINT16_MAX


def _bilinear_weight_matrix(in_size: int, out_size: int,
                            device: torch.device) -> torch.Tensor:
    """Dense (out, in) bilinear sampling matrix with cv2.INTER_LINEAR
    coordinates: src = (dst + 0.5)·scale − 0.5, clamped at the borders, no
    antialiasing. A source at or past the last pixel puts its full weight
    on that pixel."""
    scale = in_size / out_size
    src = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) \
        * scale - 0.5
    sx = torch.floor(src)
    fx = src - sx
    fx = torch.where(sx < 0, torch.zeros_like(fx), fx)
    sx = torch.clamp(sx, min=0)
    fx = torch.where(sx >= in_size - 1, torch.ones_like(fx), fx)
    sx = torch.clamp(sx, max=max(in_size - 2, 0)).to(torch.int64)
    i1 = torch.clamp(sx + 1, max=in_size - 1)
    rows = torch.arange(out_size, device=device)
    w = torch.zeros(out_size, in_size, dtype=torch.float32, device=device)
    w.index_put_((rows, sx), 1.0 - fx, accumulate=True)
    w.index_put_((rows, i1), fx, accumulate=True)
    return w


def resize_bilinear(x: torch.Tensor,
                    size: Union[int, Tuple[int, int]]) -> torch.Tensor:
    """(B, H, W, C) → (B, h, w, C) as two dense weight-matrix products
    (cv2.INTER_LINEAR rule), f32."""
    if isinstance(size, int):
        size = (size, size)
    _, h, w, _ = x.shape
    wh = _bilinear_weight_matrix(h, size[0], x.device)
    ww = _bilinear_weight_matrix(w, size[1], x.device)
    out = torch.einsum("oh,bhwc->bowc", wh, x)
    return torch.einsum("pw,bowc->bopc", ww, out).contiguous()


def per_image_quantile_fast(x: torch.Tensor, q: float,
                            iters: int = 22) -> torch.Tensor:
    """Per-image quantile by value-space bisection: the bracket starts at
    the image's min/max and each step keeps the half where
    count(x ≤ mid) crosses float32(q·(N−1)); the answer is the last
    bracket's midpoint. x (B, ...) → (B, 1, 1, 1), float32."""
    b = x.shape[0]
    flat = x.reshape(b, -1).to(torch.float32)
    n = flat.shape[1]
    target = torch.tensor(q * (n - 1), dtype=torch.float32, device=x.device)
    lo = flat.amin(dim=1)
    hi = flat.amax(dim=1)
    for _ in range(iters):
        mid = (lo + hi) * 0.5
        cnt = (flat <= mid[:, None]).sum(dim=1).to(torch.float32)
        go_up = cnt <= target
        lo, hi = torch.where(go_up, mid, lo), torch.where(go_up, hi, mid)
    return ((lo + hi) * 0.5).reshape(b, 1, 1, 1)


def adaptive_normalize(x: torch.Tensor, method: str = "percentile",
                       percentiles: Tuple[float, float] = (1.0, 99.0),
                       eps: float = 1e-8) -> torch.Tensor:
    """Per-image normalisation to [0, 1]. "percentile" clips to the
    bisection percentiles and scales, through the fused kernel
    (ops/percentile.py); "minmax" scales by the image's range."""
    if method == "percentile":
        from .percentile import fused_percentile_normalize

        return fused_percentile_normalize(x, percentiles=percentiles, eps=eps)
    if method == "minmax":
        b = x.shape[0]
        flat = x.reshape(b, -1)
        x_min = flat.amin(dim=1).reshape(b, 1, 1, 1)
        x_max = flat.amax(dim=1).reshape(b, 1, 1, 1)
        return (x - x_min) / (x_max - x_min + eps)
    raise ValueError(f"unknown normalisation method {method!r}")


def standardize(x: torch.Tensor, mean: Sequence[float],
                std: Sequence[float]) -> torch.Tensor:
    """Channelwise (x − mean) / std."""
    mean_t = torch.tensor(mean, dtype=x.dtype, device=x.device).reshape(1, 1, 1, -1)
    std_t = torch.tensor(std, dtype=x.dtype, device=x.device).reshape(1, 1, 1, -1)
    return (x - mean_t) / std_t
