"""Model lifecycle helpers (counterpart of thyroid_tpu/models/base.py)."""
from __future__ import annotations

from typing import Any

import torch

from ..ops.platform import DeviceLike, resolve_device
from .import_torch import maybe_load_pretrained
from .registry import ModelRegistry
from . import cnn, ensemble, vit  # noqa: F401  (register every model family)


def create_and_init(config: Any, seed: int = 0, device: DeviceLike = None,
                    pretrained: bool = True) -> torch.nn.Module:
    """Registry create + random init from `seed` → the model in eval mode
    on `device` (the card unless the CPU is asked for). The weights are
    drawn on the CPU, so a seed gives the same model on every device.
    With `pretrained` (the default), the config's `pretrained` /
    `pretrained_path` then warm-start it from a local torch checkpoint
    (import_torch.maybe_load_pretrained), on the CPU, before it moves; a
    caller that carries its own weights in passes False."""
    dev = resolve_device(device)
    model = ModelRegistry.create_model(config)
    model.init_weights(torch.Generator().manual_seed(int(seed)))
    if pretrained:
        maybe_load_pretrained(config, model)
    return model.to(dev).eval()


def num_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
