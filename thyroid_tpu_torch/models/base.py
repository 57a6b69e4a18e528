"""Model lifecycle helpers (counterpart of thyroid_tpu/models/base.py)."""
from __future__ import annotations

import logging
from typing import Any

import torch

from ..ops.platform import DeviceLike, resolve_device
from .import_torch import find_pretrained_file
from .registry import ModelRegistry, cfg_get
from . import cnn, ensemble, vit  # noqa: F401  (register every model family)

logger = logging.getLogger(__name__)


def check_pretrained(config: Any) -> None:
    """Honour `pretrained` / `pretrained_path` as far as the port can: when
    the JAX package would warm-start from a local torch checkpoint
    (find_pretrained_file finds one), raise, since the importers are not
    ported; when it finds none, warn and go on from the seeded weights, as
    the JAX package does."""
    path = cfg_get(config, "pretrained_path", None)
    if not path and not cfg_get(config, "pretrained", False):
        return
    name = str(cfg_get(config, "name", ""))
    found = find_pretrained_file(name, path)
    if found is not None:
        raise NotImplementedError(
            f"warm start of {name} from {found} is not ported (ROADMAP "
            "Queue 1: Warm start from local torch checkpoints)")
    logger.warning(
        "pretrained requested for %s but no local checkpoint found (set "
        "pretrained_path or $THYROID_PRETRAINED_DIR) — training from "
        "scratch", name)


def create_and_init(config: Any, seed: int = 0, device: DeviceLike = None,
                    pretrained: bool = True) -> torch.nn.Module:
    """Registry create + random init from `seed` → the model in eval mode
    on `device` (the card unless the CPU is asked for). The weights are
    drawn on the CPU, so a seed gives the same model on every device.
    With `pretrained` (the default), the config's `pretrained` /
    `pretrained_path` go through check_pretrained first; a caller that
    carries its own weights in passes False."""
    if pretrained:
        check_pretrained(config)
    dev = resolve_device(device)
    model = ModelRegistry.create_model(config)
    model.init_weights(torch.Generator().manual_seed(int(seed)))
    return model.to(dev).eval()


def num_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
