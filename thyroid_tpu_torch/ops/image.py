"""Batched image ops (counterpart of thyroid_tpu/ops/image.py).

The serving and quality paths' subset: uint16 coercion, the cv2-rule
bilinear resize, the bisection quantile, per-image adaptive normalisation
and standardisation; gamma correction, the quality statistics and issue
masks, the 3×3 median, the bilateral filter and the artifact-suppression
chain. Images are NHWC float32, as in the JAX package. `anscombe`,
`gaussian_blur` and `elastic_deform` wait for the augmentation slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------- quality


def gamma_correct(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """Gamma on the uint16 scale: floor((x/65535)^γ · 65535), the floor
    being the uint16 cast of the reference's round trip.

    Rounded as the JAX program computes it: the division is a product
    with float32(1/65535) (XLA's form of a division by a constant, and
    PyTorch's on CUDA), and the power exp(γ·log(x)) is taken in float64
    and rounded once to float32, which reproduces XLA's float32 power on
    every integer input 0..65535 (the floors agree; torch.pow's float32
    power differs on a few)."""
    xn = torch.clamp(x * (1.0 / UINT16_MAX), 0.0, 1.0)
    g = float(np.float32(gamma))
    return torch.floor(torch.exp(torch.log(xn.double()) * g).float() * UINT16_MAX)


def quality_stats(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-image mean, population std (ddof 0), max and min over H, W, C:
    x (B, H, W, C) → dict of (B,) tensors."""
    flat = x.reshape(x.shape[0], -1)
    return {"mean": flat.mean(dim=1),
            "std": flat.std(dim=1, correction=0),
            "max": flat.amax(dim=1),
            "min": flat.amin(dim=1)}


def quality_issue_masks(
    x: torch.Tensor,
    extreme_dark_threshold: float = 150.0,
    low_contrast_threshold: float = 80.0,
    artifact_ratio_threshold: float = 30.0,
    stats: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, torch.Tensor]:
    """(B,) bool masks: extreme_dark (mean < 150), low_contrast (not dark
    and std < 80), artifacts (mean > 0 and max/mean > 30). `stats` passes
    precomputed per-image statistics (ops/percentile.py
    fused_stats_quantile)."""
    s = stats if stats is not None else quality_stats(x)
    dark = s["mean"] < extreme_dark_threshold
    low_contrast = ~dark & (s["std"] < low_contrast_threshold)
    ratio = s["max"] / torch.clamp(s["mean"], min=1e-8)
    artifacts = (s["mean"] > 0) & (ratio > artifact_ratio_threshold)
    return {"extreme_dark": dark, "low_contrast": low_contrast,
            "artifacts": artifacts}


# Paeth's 19-comparator median-of-9 exchange network (the JAX package's
# sequence; it selects the 5th order statistic exactly)
MEDIAN9_NET = ((1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7),
               (1, 2), (4, 5), (7, 8), (0, 3), (5, 8), (4, 7),
               (3, 6), (1, 4), (2, 5), (4, 7), (4, 2), (6, 4),
               (4, 2))


def _pad_hw(x: torch.Tensor, r: int, mode: str) -> torch.Tensor:
    """Pad the H and W axes of NHWC x by r: "replicate" is cv2's
    BORDER_REPLICATE, "reflect" its BORDER_REFLECT_101."""
    return F.pad(x.permute(0, 3, 1, 2), (r, r, r, r), mode=mode) \
        .permute(0, 2, 3, 1)


def median_filter_3x3(x: torch.Tensor) -> torch.Tensor:
    """3×3 median with edge replication (cv2.medianBlur(ksize=3)) through
    the 19-comparator network. x (B, H, W, C)."""
    h, w = x.shape[1], x.shape[2]
    xp = _pad_hw(x, 1, "replicate")
    p = [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    for i, j in MEDIAN9_NET:
        p[i], p[j] = torch.minimum(p[i], p[j]), torch.maximum(p[i], p[j])
    return p[4]


def bilateral_taps(d: int, sigma_space: float):
    """[(dy, dx, spatial weight)] of cv2's circular d×d window (taps with
    √(dy² + dx²) > d // 2 skipped), in row-major order; the weights are
    exp(−r²/(2σ²)) in float64, rounded to float32 where they are used."""
    r = d // 2
    taps = []
    for dy in range(2 * r + 1):
        for dx in range(2 * r + 1):
            r2 = (dy - r) ** 2 + (dx - r) ** 2
            if r2 <= r * r:
                taps.append((dy, dx, float(np.exp(-r2 / (2.0 * sigma_space ** 2)))))
    return taps


def bilateral_filter(x: torch.Tensor, d: int = 5, sigma_color: float = 50.0,
                     sigma_space: float = 50.0) -> torch.Tensor:
    """Bilateral filter on the 8-bit scale (cv2.bilateralFilter: circular
    window, BORDER_REFLECT_101). x (B, H, W, C); d odd.

    Tap weights are float32, w = exp(−(tap − x)² · c)·ws with
    c = float32(1/(2σc²)); the taps are summed one at a time in row-major
    order in float64, acc += tap·w and norm += w, and acc / norm is rounded
    once to float32. The CUDA stencil (csrc/stencil.cu) repeats that
    sequence. A float32 sum would make a flat region's value depend on the
    order of the sum (a flat 3 comes out 2.9999998 or 3.0000002), and the
    artifact chain floors it; in float64 a flat region gives its value
    exactly, as the JAX quality program on the CPU does."""
    if d % 2 == 0:
        raise ValueError(f"bilateral_filter takes an odd d, got {d}")
    r = d // 2
    h, w = x.shape[1], x.shape[2]
    xp = _pad_hw(x, r, "reflect")
    inv = 1.0 / (2.0 * sigma_color ** 2)
    acc = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    norm = torch.zeros_like(acc)
    for dy, dx, sw in bilateral_taps(d, sigma_space):
        tap = xp[:, dy:dy + h, dx:dx + w]
        diff = tap - x
        cw = torch.exp(-(diff * diff) * inv) * sw
        acc = acc + tap.double() * cw.double()
        norm = norm + cw.double()
    return (acc / norm).to(x.dtype)


def suppress_artifacts(
    x: torch.Tensor,
    percentile: float = 99.9,
    bilateral_d: int = 5,
    bilateral_sigma_color: float = 50.0,
    bilateral_sigma_space: float = 50.0,
    p_high: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Artifact suppression (reference quality_preprocessing.py:149-170):
    clip each image to its `percentile` (bisection quantile, or the
    precomputed (B, 1, 1, 1) `p_high`), to 8 bit by truncation, 3×3
    median, and the bilateral of the median where the median still holds
    a value above 250; back to the uint16 scale (×256). Both filters run
    for the whole batch in one fused_median_bilateral call."""
    from .stencil import fused_median_bilateral

    if p_high is None:
        p_high = per_image_quantile_fast(x, percentile / 100.0)
    x8 = torch.floor(torch.minimum(torch.clamp(x, min=0.0), p_high) / 256.0)
    med, bil = fused_median_bilateral(
        x8, d=bilateral_d, sigma_color=bilateral_sigma_color,
        sigma_space=bilateral_sigma_space)
    needs_bilateral = (med.reshape(x.shape[0], -1).amax(dim=1) > 250.0) \
        .reshape(-1, 1, 1, 1)
    # cv2's bilateral returns uint8: truncation before the upscale
    return torch.where(needs_bilateral, torch.floor(bil), med) * 256.0
