"""Serving preprocess (counterpart of thyroid_tpu/data/pipeline.py, the
`prepare_images(quality=False)` path)."""
from __future__ import annotations

import torch

from ..ops.image import adaptive_normalize, resize_bilinear, to_uint16_scale

# ImageNet statistics for 3-channel models (gray→RGB repeat + ImageNet
# normalisation, as the JAX package trains them)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# images preprocessed in one piece; larger batches go in chunks of this size
CHUNK = 512


def prepare_images(raw: torch.Tensor, img_size: int,
                   quality: bool = False) -> torch.Tensor:
    """Raw frames (N, H, W, C) → (N, img_size, img_size, C) float32 in
    [0, 1]: uint16 scale → bilinear resize → per-image 1st/99th percentile
    normalisation, on raw's device."""
    if quality:
        raise NotImplementedError(
            "the quality pipeline is not ported (ROADMAP Queue 1: "
            "Quality pipeline)")

    def one_chunk(x: torch.Tensor) -> torch.Tensor:
        x = resize_bilinear(to_uint16_scale(x), img_size)
        return adaptive_normalize(x, method="percentile",
                                  percentiles=(1.0, 99.0))

    n = raw.shape[0]
    if n <= CHUNK:
        return one_chunk(raw)
    return torch.cat([one_chunk(raw[s:s + CHUNK]) for s in range(0, n, CHUNK)])
