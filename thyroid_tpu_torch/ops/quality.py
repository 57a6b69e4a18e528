"""Branchless quality-aware preprocessing (counterpart of
thyroid_tpu/ops/quality.py).

The reference branches per image in Python (quality_preprocessing.py
QualityAwarePreprocessor.preprocess_image:194-228); here every branch runs
for the whole batch and a per-image mask selects:

    artifacts?         → percentile clip + median + (bilateral if still bright)
    extreme dark?      → gamma 0.8, then CLAHE(clip 2.0, grid 16×16)
    elif low contrast? → CLAHE(clip 0.03, grid 32×32)
    guard              → blend back if the mean moved >10× or <0.1×

Input and output are float32 NHWC on the uint16 scale [0, 65535]. On a
CUDA tensor the statistics, the stencil and the CLAHE apply run as CUDA
kernels (ops/percentile.py, ops/stencil.py, ops/clahe.py).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .clahe import clahe_uint16, clahe_uint16_dual
from .image import (adaptive_normalize, gamma_correct, quality_issue_masks,
                    suppress_artifacts)
from .percentile import fused_stats_quantile


class QualityParams(NamedTuple):
    """The reference's parameter table (quality_preprocessing.py:38-56)."""

    extreme_dark_gamma: float = 0.8
    extreme_dark_clip: float = 2.0
    extreme_dark_grid: Tuple[int, int] = (16, 16)
    low_contrast_clip: float = 0.03
    low_contrast_grid: Tuple[int, int] = (32, 32)
    artifact_percentile: float = 99.9
    extreme_dark_threshold: float = 150.0
    low_contrast_threshold: float = 80.0
    artifact_ratio_threshold: float = 30.0


_F32_0_7 = float(np.float32(0.7))


def _per_image_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1).reshape(-1, 1, 1, 1)


def quality_preprocess(x: torch.Tensor,
                       params: QualityParams = QualityParams(),
                       merged: Optional[bool] = None) -> torch.Tensor:
    """Batched quality-aware preprocessing; x (B, H, W, 1) uint16-scale
    float32.

    merged: both CLAHE branches through one histogram pass and one apply
    (`clahe_uint16_dual`), per image equal to the two-pass form because
    the dark and low-contrast branches exclude each other. None turns it
    on when the fine grid is twice the coarse grid and divides the frame
    (the JAX package on the CPU decides the same)."""
    processed, stats, _ = quality_branches(x, params, merged)
    # 4) over-correction guard (reference: validate_preprocessing:172-192)
    too_bright, too_dark = over_correction(processed, stats["mean"])
    blended_bright = torch.floor(x * 0.5 + processed * 0.5)
    # x·0.7 + processed·0.3 with the first product fused into the sum, as
    # the JAX program compiles it (exact in float64, then one rounding)
    blended_dark = torch.floor(
        (x.double() * _F32_0_7 + (processed * 0.3).double()).to(torch.float32))
    return torch.where(too_bright, blended_bright,
                       torch.where(too_dark, blended_dark, processed))


def quality_branches(x: torch.Tensor, params: QualityParams = QualityParams(),
                     merged: Optional[bool] = None):
    """Steps 1-3 of `quality_preprocess`: (the frames before the guard,
    the fused statistics, the (B,) issue masks)."""
    stats = fused_stats_quantile(x, q=params.artifact_percentile / 100.0)
    masks = quality_issue_masks(
        x, extreme_dark_threshold=params.extreme_dark_threshold,
        low_contrast_threshold=params.low_contrast_threshold,
        artifact_ratio_threshold=params.artifact_ratio_threshold,
        stats=stats)
    m_art = masks["artifacts"].reshape(-1, 1, 1, 1)
    m_dark = masks["extreme_dark"].reshape(-1, 1, 1, 1)
    m_lc = masks["low_contrast"].reshape(-1, 1, 1, 1)

    # 1) artifacts first (reference order: preprocess_image:199-205)
    art = suppress_artifacts(x, percentile=params.artifact_percentile,
                             p_high=stats["quantile"].reshape(-1, 1, 1, 1))
    processed = torch.where(m_art, art, x)

    gc, gf = params.extreme_dark_grid, params.low_contrast_grid
    if merged is None:
        h, w = x.shape[1], x.shape[2]
        merged = (tuple(gf) == (2 * gc[0], 2 * gc[1])
                  and h % gf[0] == 0 and w % gf[1] == 0)
    if merged:
        # 2+3) one dual-grid CLAHE; dark images see the gamma-corrected frame
        clahe_in = torch.where(
            m_dark, gamma_correct(processed, params.extreme_dark_gamma),
            processed)
        eq = clahe_uint16_dual(
            clahe_in, masks["extreme_dark"],
            clip_coarse=params.extreme_dark_clip, grid_coarse=gc,
            clip_fine=params.low_contrast_clip, grid_fine=gf)
        processed = torch.where(m_dark | m_lc, eq, processed)
    else:
        # 2) extreme dark: gamma → CLAHE(2.0, 16×16); 3) elif low contrast
        dark = clahe_uint16(gamma_correct(processed, params.extreme_dark_gamma),
                            clip_limit=params.extreme_dark_clip, grid=gc)
        lc = clahe_uint16(processed, clip_limit=params.low_contrast_clip,
                          grid=gf)
        processed = torch.where(m_dark, dark, torch.where(m_lc, lc, processed))
    return processed, stats, masks


def over_correction(processed: torch.Tensor, orig_mean: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(too_bright, too_dark), each (B, 1, 1, 1): the processed frame's
    mean above 10× or below 0.1× the original's."""
    orig_mean = orig_mean.reshape(-1, 1, 1, 1)
    proc_mean = _per_image_mean(processed)
    return proc_mean > orig_mean * 10.0, proc_mean < orig_mean * 0.1


def quality_preprocess_and_normalize(
        x: torch.Tensor, params: QualityParams = QualityParams(),
        normalize_method: str = "percentile") -> torch.Tensor:
    """quality_preprocess → per-image percentile (1, 99) normalisation to
    [0, 1] (reference create_quality_aware_transform,
    quality_preprocessing.py:342-393)."""
    return adaptive_normalize(quality_preprocess(x, params),
                              method=normalize_method, percentiles=(1.0, 99.0))
