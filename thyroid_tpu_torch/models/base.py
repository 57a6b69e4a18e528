"""Model lifecycle helpers (counterpart of thyroid_tpu/models/base.py)."""
from __future__ import annotations

from typing import Any

import torch

from ..ops.platform import DeviceLike, resolve_device
from .registry import ModelRegistry
from . import cnn, vit  # noqa: F401  (register the EfficientNet and Swin families)


def create_and_init(config: Any, seed: int = 0,
                    device: DeviceLike = None) -> torch.nn.Module:
    """Registry create + random init from `seed` → the model in eval mode
    on `device` (the card unless the CPU is asked for). The weights are
    drawn on the CPU, so a seed gives the same model on every device."""
    dev = resolve_device(device)
    model = ModelRegistry.create_model(config)
    model.init_weights(torch.Generator().manual_seed(int(seed)))
    return model.to(dev).eval()


def num_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
