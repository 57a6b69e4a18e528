"""Bucketed inference and request aggregation (counterpart of
thyroid_tpu/serving/engine.py).

Requests carry raw frames (N, S, S, 1) on the uint16 scale, or frames
already resized and normalised to [0, 1] with `raw_inputs=False`. Each
request is padded up to the smallest batch bucket that holds it
(repeating its last frame), or cut into chunks of the largest bucket, and
every bucket runs the same program: `prepare_images` for raw frames (with
the quality-aware pipeline when the engine was built with
`quality=True`) → gray→RGB for 3-channel models → `standardize` → the
model (its eligible Dense/Conv layers in int8 with `quantize="int8"`,
serving/quantize.py) → float32 softmax. The padding rows are sliced off.
Fixed buckets keep the kernels' shapes to a small known set.

`BatchAggregator` coalesces single-image requests into bucket-sized
engine calls: it dispatches when `max_batch` requests are queued or the
oldest has waited `max_delay_ms`, the throughput/latency trade of the
HTTP front end (serving/server.py); it lives in serving/aggregator.py, so
that the front end serves an export bundle without the model code.

On a device mesh (`mesh=`, parallel.create_mesh(shape, devices=[...]))
the engine keeps one replica of the model on each device along
`mesh_axis` (a device listed twice shares one), rounds its buckets up to
multiples of the axis size exactly as JAX's does, and runs each bucket as
that many equal shards, one thread each, gathering the rows in order on
`device`; int8's activation scale stays global over the bucket
(serving/quantize.py MaxExchange). The shards run in copies of the
caller's context, so `int8_serving`-style switches reach them.
"""
from __future__ import annotations

import contextvars
import copy
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from ..data.pipeline import IMAGENET_MEAN, IMAGENET_STD, prepare_images
from ..models.base import create_and_init
from ..models.from_jax import load_jax_variables
from ..models.registry import cfg_get
from ..ops.image import standardize
from ..ops.platform import DeviceLike, resolve_device
from ..parallel.mesh import Mesh, axis_devices
from .aggregator import BatchAggregator  # noqa: F401  (JAX's module holds it)
from .quantize import MaxExchange, exchanging, int8_serving

DEFAULT_BUCKETS = (1, 8, 32, 128)
RAW_SIDE = 512   # the CARS frame side warmup feeds raw engines


def _indexed(dev: torch.device) -> torch.device:
    """A bare "cuda" as the card it means (the current one)."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class InferenceEngine:
    """Bucketed batch inference over one model; thread-safe `predict`.

    `variables` is a JAX variable tree ({"params": …, "batch_stats": …},
    nested dicts of arrays) carried in through `load_jax_variables`, as the
    JAX engine takes it; `params` a bare parameter tree, {"params":
    params}, for a model without BatchNorm statistics; `checkpoint` a
    port checkpoint directory (training/checkpoint.py), whose
    metadata["model_config"] stands in for `model_config` when none is
    given. Without weights the model is drawn from seed 0, then
    warm-started from the config's `pretrained` / `pretrained_path` torch
    checkpoint when one is found (models/import_torch.py). The frames are
    resized to the config's `img_size`, else 224, as the JAX engine does.
    `quality` runs the quality-aware preprocessing (artifact filters,
    gamma, CLAHE, ops/quality.py) on each request's raw frames before the
    resize, as `serve.py --quality` does; the frame sides must then be
    divisible by its 32×32 CLAHE grid. `raw_inputs=False` takes frames
    already at `img_size` in [0, 1] and skips the preparation. `mean` and
    `std` override the normalisation (default: ImageNet's for 3-channel
    models, 0.5 / 0.5 otherwise). `quantize="int8"` serves the eligible
    Dense/Conv layers in int8 (the model built with `token_kernels` off, as
    in JAX). `device` None means the CUDA card, and raises when there is
    none. `mesh` (a device mesh) serves each bucket sharded over the
    devices along `mesh_axis` (see the module docstring); `device` is
    then where requests arrive and probabilities are gathered."""

    def __init__(self, model_config: Any = None,
                 params: Optional[Mapping[str, Any]] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 quality: bool = False,
                 device: DeviceLike = None,
                 variables: Optional[Mapping[str, Any]] = None,
                 quantize: Optional[str] = None,
                 mesh: Any = None,
                 checkpoint: Optional[str] = None,
                 raw_inputs: bool = True,
                 mean: Optional[Sequence[float]] = None,
                 std: Optional[Sequence[float]] = None,
                 mesh_axis: str = "data"):
        if mesh is not None and (not isinstance(mesh, Mesh)
                                 or mesh.is_process_mesh):
            raise TypeError("InferenceEngine(mesh=) takes a device mesh "
                            "(parallel.create_mesh(shape, devices=[...])), "
                            f"got {mesh!r}")
        if params is not None and variables is not None:
            raise ValueError("pass params or variables, not both")
        if params is not None:
            variables = {"params": params}
        if checkpoint is not None:
            from ..training.checkpoint import load_checkpoint

            variables, metadata = load_checkpoint(checkpoint)
            if model_config is None:
                model_config = metadata.get("model_config")
                if model_config is None:
                    raise ValueError(
                        f"checkpoint {checkpoint} has no model_config "
                        "metadata; pass model_config explicitly")
        if model_config is None:
            raise ValueError("need model_config or checkpoint")
        if quantize not in (None, "int8"):
            raise ValueError(f"quantize must be None or 'int8', got {quantize!r}")
        self.device = resolve_device(device)
        self.model_config = model_config
        if quantize is not None:
            # the int8 call sites are the nn.Dense/nn.Conv ones; kernels 2-3
            # read raw parameters, so the ViTs take their plain blocks
            model_config = dict(model_config.to_dict()
                                if hasattr(model_config, "to_dict")
                                else model_config)
            model_config["token_kernels"] = False
        self.quantize = quantize
        # as the JAX engine: the config's warm start only without weights
        self.model = create_and_init(model_config, seed=0, device=self.device,
                                     pretrained=variables is None)
        if variables is not None:
            load_jax_variables(self.model, variables)
        self.mesh = mesh
        if mesh is not None:
            n = int(mesh.shape[mesh_axis])
            buckets = sorted({max(-(-int(b) // n) * n, n) for b in buckets})
            self.shard_devices = [_indexed(d) for d in axis_devices(mesh, mesh_axis)]
            # one replica a device; copies of the weights, not new draws
            self.replicas = {_indexed(self.device): self.model}
            for dev in self.shard_devices:
                if dev not in self.replicas:
                    self.replicas[dev] = copy.deepcopy(self.model).to(dev)
            self._pool = ThreadPoolExecutor(n, thread_name_prefix="shard")
        self.img_size = int(cfg_get(model_config, "img_size", 224))
        self.in_channels = int(cfg_get(model_config, "in_channels", 1))
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.quality = bool(quality)
        self.raw_inputs = bool(raw_inputs)
        if mean is None or std is None:
            if self.in_channels == 3:
                mean, std = IMAGENET_MEAN, IMAGENET_STD
            else:
                mean, std = (0.5,), (0.5,)
        self.mean, self.std = tuple(mean), tuple(std)
        self._lock = threading.Lock()

    def program(self, x: torch.Tensor,
                model: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
                ) -> torch.Tensor:
        """The serving program of one bucket, frames → probabilities, with
        `model` (the engine's own by default) as the forward. `run` calls
        it; serving/export.py traces it with the weights as an input, so
        that a bundle cannot drift from the engine."""
        model = self.model if model is None else model
        if self.raw_inputs:
            x = prepare_images(x, self.img_size, quality=self.quality)
        if self.in_channels == 3 and x.shape[-1] == 1:
            x = x.repeat(1, 1, 1, 3)
        x = standardize(x, self.mean, self.std)
        if self.quantize == "int8":
            with int8_serving():
                logits = model(x)
        else:
            logits = model(x)
        return torch.softmax(logits.float(), dim=-1)

    def run(self, x: torch.Tensor) -> torch.Tensor:
        """One bucket: frames on the engine's device → probabilities (on a
        mesh, its shards on their devices, gathered in order)."""
        if self.mesh is None:
            with torch.inference_mode():
                return self.program(x)
        n = len(self.shard_devices)
        shards = torch.split(x, x.shape[0] // n)
        exchange = MaxExchange(n) if self.quantize == "int8" else None

        def shard(i: int) -> torch.Tensor:
            dev = self.shard_devices[i]
            try:
                with torch.inference_mode(), exchanging(exchange, i):
                    return self.program(shards[i].to(dev), self.replicas[dev])
            except BaseException:
                if exchange is not None:
                    exchange.abort()
                raise

        futures = [self._pool.submit(contextvars.copy_context().run, shard, i)
                   for i in range(n)]
        errors = [f.exception() for f in futures]
        first = [e for e in errors if e is not None
                 and not isinstance(e, threading.BrokenBarrierError)]
        if first or any(errors):
            raise (first or [e for e in errors if e is not None])[0]
        return torch.cat([f.result().to(self.device) for f in futures])

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def warmup(self) -> None:
        """Run every bucket once on zero frames (first-call set-up)."""
        side = RAW_SIDE if self.raw_inputs else self.img_size
        for b in self.buckets:
            x = torch.zeros(b, side, side, 1, device=self.device)
            with self._lock:
                self.run(x)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, images: np.ndarray) -> np.ndarray:
        """images (N, S, S[, 1]) raw frames (or prepared ones with
        raw_inputs=False) → (N, num_classes) float32 probabilities. N may
        exceed the largest bucket; it is chunked."""
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
