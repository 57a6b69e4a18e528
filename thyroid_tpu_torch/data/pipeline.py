"""Device-resident batch pipeline (counterpart of thyroid_tpu/data/pipeline.py).

`prepare_images` preprocesses raw frames once on the device (the serving
engine uses it per request): uint16 scale → with `quality`, the
quality-aware pipeline (ops/quality.py) in chunks of 32 frames → resize →
per-image percentile normalisation. `DevicePipeline` keeps a
whole split's prepared images on the device and materialises each batch
with a gather, the training augmentation (ops/augment.py: the level
ladder, or RandAugment and patch quality in "vit" mode, drawn from the
caller's device generator), the gray→RGB repeat for 3-channel models and
`standardize`:
- train: a shuffled permutation per epoch (from the caller's
  `torch.Generator`), the last partial batch wrapped around to the start of
  the epoch's order, so every batch has the same shape;
- eval: sequential, never augmented, the last batch padded with its last
  row at weight 0, so that metrics are exact.
`create_data_loaders` decodes each split of a corpus on disk
(data/dataset.py) into a DevicePipeline.

On a process mesh (parallel/mesh.py) a pipeline's `sharding` (a
RowSharding over the data axis, or the one `epoch` is given) makes each
rank yield its contiguous rows of every global batch, as JAX's
`device_put(batch, sharding)` places them: the order and padding are the
global batch's, and an augmented batch is drawn and augmented whole on
every rank (the draws are the one process's) before the rank keeps its
rows; so is a batch that the trainer mixes (`epoch(mix=)`: MixUp/CutMix
on the global batch, as JAX's step mixes the global array).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from ..models.registry import cfg_get
from ..ops.augment import train_augment, vit_augment
from ..ops.image import (adaptive_normalize, resize_bilinear, standardize,
                         to_uint16_scale)
from ..ops.platform import DeviceLike, resolve_device
from ..ops.quality import quality_preprocess
from .dataset import CARSThyroidDataset

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
    # a mixed batch (epoch(mix=)): the second labels (B,) and λ (a scalar)
    label_b: Optional[torch.Tensor] = None
    lam: Optional[torch.Tensor] = None


class DevicePipeline:
    """One split, prepared once and kept on `device` (the card unless the
    CPU is asked for)."""

    def __init__(self, images_u16: np.ndarray, labels: np.ndarray,
                 batch_size: int = 32, img_size: int = 224,
                 mean=(0.5,), std=(0.5,),
                 quality_preprocessing: bool = False,
                 augmentation_level: str = "none",
                 augment_mode: str = "standard", train: bool = False,
                 out_channels: int = 1,
                 vit_aug_params: Optional[dict] = None,
                 device: DeviceLike = None, sharding: Any = None):
        self.device = resolve_device(device)
        self.sharding = sharding
        self.augmentation_level = augmentation_level
        self.augment_mode = augment_mode
        self.vit_aug_params = dict(vit_aug_params or {})
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

    def augments(self) -> bool:
        """Whether training batches are augmented."""
        return self.train and self.augmentation_level != "none"

    def make_batch(self, idx: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Rows `idx` of the cache, augmented in a training pipeline (the
        draws from `generator`, on the cache's device), gray→RGB for
        3-channel models, standardized."""
        x = self.cache.index_select(0, idx)
        if self.augments():
            if generator is None:
                raise ValueError("an augmented batch needs a torch.Generator")
            if self.augment_mode == "vit":
                x = vit_augment(x, generator, **self.vit_aug_params)
            else:
                x = train_augment(x, generator, level=self.augmentation_level)
        if self.out_channels == 3 and x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        return standardize(x, self.mean, self.std)

    def steps_per_epoch(self) -> int:
        return max(1, -(-self.n // self.batch_size))

    def epoch(self, generator: Optional[torch.Generator] = None,
              aug_generator: Optional[torch.Generator] = None,
              sharding: Any = None,
              mix: Optional[Callable] = None) -> Iterator[Batch]:
        """Yield one epoch's batches. Training draws the epoch's order from
        `generator` (a CPU generator), which it needs, and an augmented
        pipeline its batches' augmentation from `aug_generator` (on the
        pipeline's device). With `sharding` (default: the pipeline's own)
        each batch is this rank's rows of the global batch. `mix` (image,
        label) → (mixed image, second labels, λ) is applied to each global
        batch before the rank keeps its rows."""
        sharding = self._sharding(sharding)
        bs, n_steps = self.batch_size, self.steps_per_epoch()
        if sharding is not None:
            sharding.rows(bs)
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
            w = weight[step * bs:(step + 1) * bs]
            label = self.labels.index_select(0, sel)
            if sharding is not None and not self.augments() and mix is None:
                sel = sharding.take(sel)
                yield Batch(image=self.make_batch(sel),
                            label=self.labels.index_select(0, sel),
                            weight=sharding.take(w))
                continue
            batch = Batch(image=self.make_batch(sel, aug_generator),
                          label=label, weight=w)
            if mix is not None:
                batch.image, batch.label_b, batch.lam = mix(batch.image, label)
            if sharding is not None:
                for key in ("image", "label", "weight", "label_b"):
                    if getattr(batch, key) is not None:
                        setattr(batch, key, sharding.take(getattr(batch, key)))
            yield batch

    def _sharding(self, sharding: Any) -> Any:
        """The rows this process takes: `sharding`, else the pipeline's
        own; both given must agree."""
        if sharding is None:
            return self.sharding
        if self.sharding is not None and \
                (self.sharding.count, self.sharding.index) != \
                (sharding.count, sharding.index):
            raise ValueError("the pipeline is sharded otherwise than the "
                             "epoch asks for")
        return sharding


def create_data_loaders(dataset_config: Any,
                        splits: tuple[str, ...] = ("train", "val", "test"),
                        augment_mode: str = "standard",
                        model_config: Any = None,
                        device: DeviceLike = None,
                        sharding: Any = None) -> dict[str, DevicePipeline]:
    """A DevicePipeline per split of the dataset config's corpus, on
    `device` (the card unless the CPU is asked for).

    A model of 3 input channels gets gray→RGB with ImageNet statistics
    unless the dataset config pins 3-channel mean and std. Without
    `apply_augmentations` the level is "none"; the train split is
    augmented at the level ("standard") or by vit_augment with the
    config's RandAugment and patch-quality keys ("vit"). `sharding` (a
    parallel.batch_sharding) gives every pipeline this rank's rows of
    each batch, as JAX's places each batch with it."""
    level = cfg_get(dataset_config, "augmentation_level", "medium")
    if not cfg_get(dataset_config, "apply_augmentations", True):
        level = "none"
    out_channels = int(cfg_get(model_config, "in_channels", 1) or 1) \
        if model_config is not None else 1
    mean = tuple(np.atleast_1d(cfg_get(dataset_config, "mean", (0.5,))))
    std = tuple(np.atleast_1d(cfg_get(dataset_config, "std", (0.5,))))
    if out_channels == 3 and len(mean) == 1:
        mean, std = IMAGENET_MEAN, IMAGENET_STD
    # the ViT augmentation flags; the magnitude follows the level ladder
    vit_aug_params = {
        "use_randaugment": bool(cfg_get(dataset_config, "use_randaugment", True)),
        "use_patch_quality": bool(cfg_get(dataset_config, "use_patch_quality", True)),
        "randaugment_n": int(cfg_get(dataset_config, "randaugment_n", 2)),
        "randaugment_m": float(cfg_get(
            dataset_config, "randaugment_m",
            {"light": 5.0, "medium": 9.0, "heavy": 14.0}.get(level, 9.0))),
    }
    device = resolve_device(device)
    out: dict[str, DevicePipeline] = {}
    for split in splits:
        ds = CARSThyroidDataset(dataset_config, split=split)
        out[split] = DevicePipeline(
            ds.load_images(),
            ds.labels,
            batch_size=cfg_get(dataset_config, "batch_size", 32),
            img_size=cfg_get(dataset_config, "img_size", 224),
            mean=mean,
            std=std,
            quality_preprocessing=cfg_get(dataset_config,
                                           "quality_preprocessing", False),
            augmentation_level=level if split == "train" else "none",
            augment_mode=augment_mode,
            train=(split == "train"),
            out_channels=out_channels,
            vit_aug_params=vit_aug_params,
            device=device,
            sharding=sharding,
        )
    return out
