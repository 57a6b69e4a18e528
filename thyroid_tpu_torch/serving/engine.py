"""Bucketed inference (counterpart of thyroid_tpu/serving/engine.py).

Requests carry raw frames (N, S, S, 1) on the uint16 scale. Each request
is padded up to the smallest batch bucket that holds it (repeating its
last frame), or cut into chunks of the largest bucket, and every bucket
runs the same program: `prepare_images` (with the quality-aware pipeline
when the engine was built with `quality=True`) → gray→RGB for 3-channel
models → `standardize` → the model → float32 softmax. The padding rows are sliced
off. Fixed buckets keep the kernels' shapes to a small known set.
"""
from __future__ import annotations

import threading
from typing import Any, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD, prepare_images
from ..models.base import create_and_init
from ..models.from_jax import load_jax_variables
from ..models.registry import cfg_get
from ..ops.image import standardize
from ..ops.platform import DeviceLike, resolve_device

DEFAULT_BUCKETS = (1, 8, 32, 128)
RAW_SIDE = 512   # the CARS frame side warmup feeds


class InferenceEngine:
    """Bucketed batch inference over one model; thread-safe `predict`.

    `variables` is a JAX variable tree ({"params": …, "batch_stats": …},
    nested dicts of arrays) carried in through `load_jax_variables`, as the
    JAX engine takes it; `params` a bare parameter tree, {"params":
    params}, for a model without BatchNorm statistics; neither draws random
    weights from seed 0. The frames are resized to the config's `img_size`, else
    224, as the JAX engine does.
    `quality` runs the quality-aware preprocessing (artifact filters,
    gamma, CLAHE, ops/quality.py) on each request's raw frames before the
    resize, as `scripts/serve.py --quality` does for the JAX engine; the
    frame sides must then be divisible by its 32×32 CLAHE grid.
    `device` None means the CUDA card, and raises when there is none.
    int8 serving (`quantize`) and serving on a mesh are not ported."""

    def __init__(self, model_config: Any,
                 params: Optional[Mapping[str, Any]] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 quality: bool = False,
                 device: DeviceLike = None,
                 variables: Optional[Mapping[str, Any]] = None,
                 quantize: Optional[str] = None,
                 mesh: Any = None):
        if model_config is None:
            raise ValueError("need model_config")
        if quantize is not None:
            raise NotImplementedError("int8 serving is not ported (ROADMAP "
                                      "Queue 1: Serving, the rest)")
        if mesh is not None:
            raise NotImplementedError("serving on a mesh is not ported "
                                      "(ROADMAP Queue 1: Parallelism)")
        if params is not None and variables is not None:
            raise ValueError("pass params or variables, not both")
        self.device = resolve_device(device)
        self.model_config = model_config
        self.model = create_and_init(model_config, seed=0, device=self.device)
        if params is not None:
            variables = {"params": params}
        if variables is not None:
            load_jax_variables(self.model, variables)
        self.img_size = int(cfg_get(model_config, "img_size", 224))
        self.in_channels = int(cfg_get(model_config, "in_channels", 1))
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.quality = bool(quality)
        if self.in_channels == 3:
            self.mean, self.std = IMAGENET_MEAN, IMAGENET_STD
        else:
            self.mean, self.std = (0.5,), (0.5,)
        self._lock = threading.Lock()

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """One bucket: raw frames on the engine's device → probabilities."""
        with torch.inference_mode():
            x = prepare_images(x, self.img_size, quality=self.quality)
            if self.in_channels == 3 and x.shape[-1] == 1:
                x = x.repeat(1, 1, 1, 3)
            x = standardize(x, self.mean, self.std)
            logits = self.model(x)
            return torch.softmax(logits.float(), dim=-1)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def warmup(self) -> None:
        """Run every bucket once on zero frames (first-call set-up)."""
        for b in self.buckets:
            x = torch.zeros(b, RAW_SIDE, RAW_SIDE, 1, device=self.device)
            with self._lock:
                self.run(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """images (N, S, S[, 1]) raw frames → (N, num_classes) float32
        probabilities. N may exceed the largest bucket; it is chunked."""
        images = np.asarray(images, np.float32)
        if images.ndim == 3:
            images = images[..., None]
        n = images.shape[0]
        top = self.buckets[-1]
        outs: List[np.ndarray] = []
        for start in range(0, n, top):
            chunk = images[start:start + top]
            m = chunk.shape[0]
            b = self.bucket_for(m)
            if m < b:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], b - m, axis=0)], axis=0)
            x = torch.from_numpy(chunk).to(self.device)
            with self._lock:
                probs = self.run(x)
            outs.append(probs.cpu().numpy()[:m])
        return np.concatenate(outs, axis=0)
