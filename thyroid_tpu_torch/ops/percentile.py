"""Per-image bisection percentiles (counterpart of thyroid_tpu/ops/percentile.py).

Two wrappers of `csrc/percentile.cu`, each calling its op (ops/_build.py
`define_op`), which launches the CUDA kernel on a CUDA tensor and runs its
plain PyTorch version on a CPU tensor:
- `fused_percentile_normalize` (plain: `percentile_normalize_plain`):
  per-image 1st/99th-percentile clip and scale;
- `fused_stats_quantile` (plain: `stats_quantile_plain`): per-image mean,
  std, max, min and one percentile, for the quality pipeline.
Both compute the same bisection brackets as `per_image_quantile_fast`
(see the kernels' source note); `percentile_normalize_launch` and
`stats_quantile_launch` report how each launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from . import _build
from .image import per_image_quantile_fast, quality_stats

_DTYPES = (torch.float32, torch.bfloat16)


def percentile_normalize_plain(x: torch.Tensor,
                               percentiles: Tuple[float, float] = (1.0, 99.0),
                               iters: int = 22,
                               eps: float = 1e-8) -> torch.Tensor:
    """Plain PyTorch version: the two bisection quantiles, clip and scale,
    in float32; the result in x's dtype."""
    xf = x.to(torch.float32)
    p_lo = per_image_quantile_fast(xf, percentiles[0] / 100.0, iters)
    p_hi = per_image_quantile_fast(xf, percentiles[1] / 100.0, iters)
    p_lo = p_lo.reshape((x.shape[0],) + (1,) * (x.dim() - 1))
    p_hi = p_hi.reshape(p_lo.shape)
    y = torch.minimum(torch.maximum(xf, p_lo), p_hi)
    return ((y - p_lo) / (p_hi - p_lo + eps)).to(x.dtype)


def _check_percentile(x: torch.Tensor) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused_percentile_normalize takes float32 or "
                        f"bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_percentile_normalize needs a contiguous tensor")


def _percentile_cpu(x, p_lo, p_hi, iters, eps):
    return percentile_normalize_plain(x, (p_lo, p_hi), iters, eps).contiguous()


def _percentile_fake(x, p_lo, p_hi, iters, eps):
    _check_percentile(x)
    return torch.empty_like(x)


def _percentile_cuda(x, p_lo, p_hi, iters, eps):
    _check_percentile(x)
    b = x.shape[0]
    n = x.numel() // b if b else 0
    y = torch.empty_like(x)
    if b == 0 or n == 0:
        return y
    # thresholds rounded to float32 as the JAX kernel does
    t_lo = float(np.float32(p_lo / 100.0 * (n - 1)))
    t_hi = float(np.float32(p_hi / 100.0 * (n - 1)))
    fn = _build.function("percentile", "tt_percentile_normalize", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(x), _build.ptr(y), b, n, t_lo, t_hi, eps, iters,
                int(x.dtype == torch.bfloat16), _build.stream_ptr(x.device))
    _build.check("percentile", status, "fused_percentile_normalize")
    _build.count_launch(fused_percentile_normalize)
    return y


_percentile_op = _build.define_op(
    "percentile_normalize(Tensor x, float p_lo, float p_hi, int iters, "
    "float eps) -> Tensor",
    cpu=_percentile_cpu, cuda=_percentile_cuda, fake=_percentile_fake)


def fused_percentile_normalize(x: torch.Tensor,
                               percentiles: Tuple[float, float] = (1.0, 99.0),
                               iters: int = 22,
                               eps: float = 1e-8) -> torch.Tensor:
    """x (B, H, W, C) → same shape and dtype, each image clipped to its
    bisection percentiles and scaled to [0, 1]
    (`thyroid_tpu_torch::percentile_normalize`)."""
    return _percentile_op(x, float(percentiles[0]), float(percentiles[1]),
                          int(iters), float(eps))


fused_percentile_normalize.launches = 0


def stats_quantile_plain(x: torch.Tensor, q: float,
                         iters: int = 22) -> Dict[str, torch.Tensor]:
    """Plain version of fused_stats_quantile: quality_stats plus the
    bisection quantile."""
    stats = quality_stats(x)
    stats["quantile"] = per_image_quantile_fast(x, q, iters).reshape(x.shape[0])
    return stats


_STATS = ("mean", "std", "max", "min", "quantile")


def _check_stats(x: torch.Tensor) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"fused_stats_quantile takes float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("fused_stats_quantile needs a contiguous tensor")
    if x.numel() == 0:
        raise ValueError("fused_stats_quantile needs a non-empty batch of "
                         "non-empty images")


def _stats_cpu(x, q, iters):
    stats = stats_quantile_plain(x, q, iters)
    return torch.stack([stats[k] for k in _STATS])


def _stats_fake(x, q, iters):
    _check_stats(x)
    return x.new_empty(5, x.shape[0])


def _stats_cuda(x, q, iters):
    _check_stats(x)
    b = x.shape[0]
    n = x.numel() // b
    out = torch.empty(5, b, dtype=torch.float32, device=x.device)
    fn = _build.function("percentile", "tt_stats_quantile", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    status = fn(_build.ptr(x), _build.ptr(out), b, n,
                float(np.float32(q * (n - 1))), iters,
                _build.stream_ptr(x.device))
    _build.check("percentile", status, "fused_stats_quantile")
    _build.count_launch(fused_stats_quantile)
    return out


_stats_op = _build.define_op(
    "stats_quantile(Tensor x, float q, int iters) -> Tensor",
    cpu=_stats_cpu, cuda=_stats_cuda, fake=_stats_fake)


def fused_stats_quantile(x: torch.Tensor, q: float,
                         iters: int = 22) -> Dict[str, torch.Tensor]:
    """x (B, H, W, C) float32 → dict of (B,) float32: "mean", "std"
    (population), "max", "min" and the bisection "quantile" at q
    (`thyroid_tpu_torch::stats_quantile`, whose (5, B) rows these are)."""
    return dict(zip(_STATS, _stats_op(x, float(q), int(iters)).unbind(0)))


fused_stats_quantile.launches = 0


def percentile_normalize_launch(x: torch.Tensor) -> Dict[str, int]:
    """How fused_percentile_normalize launches on the CUDA tensor x (B, ...):
    a cluster of `cluster` CTAs of `threads` threads per image, each image
    `staged` in the CTAs' shared memory (`stage_bytes` a CTA) or streamed
    from global memory, the kernel's static shared bytes and registers a
    thread, and the clusters the card holds at once."""
    b = x.shape[0]
    n = x.numel() // b
    out = (ctypes.c_int * 7)()
    fn = _build.function("percentile", "tt_percentile_normalize_config", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int)])
    _build.check("percentile", fn(_build.ptr(x), b, n,
                                  int(x.dtype == torch.bfloat16), out),
                 "percentile_normalize_launch")
    return dict(zip(("cluster", "threads", "staged", "stage_bytes",
                     "static_bytes", "registers", "clusters_at_once"), out))


def stats_quantile_launch(x: torch.Tensor) -> Dict[str, int]:
    """How fused_stats_quantile launches on the CUDA tensor x: a cluster of
    `cluster` CTAs of `threads` threads per image, the image `staged` in
    the CTAs' shared memory (`stage_bytes` a CTA) or streamed from global
    memory, the kernel's static shared bytes and registers a thread, and
    the clusters the card holds at once."""
    b = x.shape[0]
    n = x.numel() // b
    out = (ctypes.c_int * 7)()
    fn = _build.function("percentile", "tt_stats_quantile_config", [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    _build.check("percentile", fn(_build.ptr(x), n, out), "stats_quantile_launch")
    return dict(zip(("cluster", "threads", "staged", "stage_bytes",
                     "static_bytes", "registers", "clusters_at_once"), out))
