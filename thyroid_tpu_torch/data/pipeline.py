"""Device-resident batch pipeline (counterpart of thyroid_tpu/data/pipeline.py).

`prepare_images` preprocesses raw frames once on the device (the serving
engine uses it per request): uint16 scale → with `quality`, the
quality-aware pipeline (ops/quality.py) in chunks of 32 frames → resize →
per-image percentile normalisation. `DevicePipeline` keeps a
whole split's prepared images on the device and materialises each batch
with a gather, the gray→RGB repeat for 3-channel models and `standardize`:
- train: a shuffled permutation per epoch (from the caller's
  `torch.Generator`), the last partial batch wrapped around to the start of
  the epoch's order, so every batch has the same shape;
- eval: sequential, the last batch padded with its last row at weight 0,
  so that metrics are exact.
Augmentation and `create_data_loaders` (which needs the dataset's PNG/TIFF
decoding) are not ported (ROADMAP Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from ..ops.image import (adaptive_normalize, resize_bilinear, standardize,
                         to_uint16_scale)
from ..ops.platform import DeviceLike, resolve_device
from ..ops.quality import quality_preprocess

# ImageNet statistics for 3-channel models (gray→RGB repeat + ImageNet
# normalisation, as the JAX package trains them)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# frames preprocessed in one piece; larger batches go in chunks of this size
CHUNK = 512
# the same with the quality pipeline, whose full-resolution intermediates
# (filters, CLAHE) this bounds; its math is per image, so chunking changes
# no value
QUALITY_CHUNK = 32


def prepare_images(raw: torch.Tensor, img_size: int,
                   quality: bool = False) -> torch.Tensor:
    """Raw frames (N, H, W, C) → (N, img_size, img_size, C) float32 in
    [0, 1]: uint16 scale → [quality pipeline, the reference's parameter
    table] → bilinear resize → per-image 1st/99th percentile
    normalisation, on raw's device."""

    def one_chunk(x: torch.Tensor) -> torch.Tensor:
        x = to_uint16_scale(x)
        if quality:
            x = quality_preprocess(x)
        x = resize_bilinear(x, img_size)
        return adaptive_normalize(x, method="percentile",
                                  percentiles=(1.0, 99.0))

    n = raw.shape[0]
    chunk = QUALITY_CHUNK if quality else CHUNK
    if n <= chunk:
        return one_chunk(raw)
    return torch.cat([one_chunk(raw[s:s + chunk]) for s in range(0, n, chunk)])


@dataclass
class Batch:
    image: torch.Tensor    # (B, S, S, C) float32, standardized
    label: torch.Tensor    # (B,) int64
    weight: torch.Tensor   # (B,) float32, 0 for padding rows


class DevicePipeline:
    """One split, prepared once and kept on `device` (the card unless the
    CPU is asked for)."""

    def __init__(self, images_u16: np.ndarray, labels: np.ndarray,
                 batch_size: int = 32, img_size: int = 224,
                 mean=(0.5,), std=(0.5,),
                 quality_preprocessing: bool = False,
                 augmentation_level: str = "none", train: bool = False,
                 out_channels: int = 1, device: DeviceLike = None):
        if augmentation_level != "none":
            raise NotImplementedError(
                f"augmentation_level={augmentation_level!r}: augmentation is "
                "not ported (ROADMAP Queue 1: Augmentation)")
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.img_size = int(img_size)
        self.mean = tuple(float(m) for m in np.atleast_1d(mean))
        self.std = tuple(float(s) for s in np.atleast_1d(std))
        self.train = train
        self.out_channels = int(out_channels)
        self.n = len(labels)
        self.labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64,
                                      device=self.device)
        raw = torch.from_numpy(np.asarray(images_u16, np.float32)).to(self.device)
        self.cache = prepare_images(raw, self.img_size,
                                    quality=bool(quality_preprocessing))
        del raw

    def make_batch(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows `idx` of the cache, gray→RGB for 3-channel models,
        standardized."""
        x = self.cache.index_select(0, idx)
        if self.out_channels == 3 and x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        return standardize(x, self.mean, self.std)

    def steps_per_epoch(self) -> int:
        return max(1, -(-self.n // self.batch_size))

    def epoch(self, generator: Optional[torch.Generator] = None
              ) -> Iterator[Batch]:
        """Yield one epoch's batches. Training draws the epoch's order from
        `generator` (a CPU generator), which it needs."""
        bs, n_steps = self.batch_size, self.steps_per_epoch()
        pos = torch.arange(n_steps * bs)
        if self.train:
            if generator is None:
                raise ValueError("a training epoch needs a torch.Generator")
            order = torch.randperm(self.n, generator=generator)
            idx = order[pos % self.n]
            weight = torch.ones(n_steps * bs)
        else:
            idx = torch.clamp(pos, max=self.n - 1)
            weight = (pos < self.n).float()
        idx = idx.to(self.device)
        weight = weight.to(self.device)
        for step in range(n_steps):
            sel = idx[step * bs:(step + 1) * bs]
            yield Batch(image=self.make_batch(sel),
                        label=self.labels.index_select(0, sel),
                        weight=weight[step * bs:(step + 1) * bs])
