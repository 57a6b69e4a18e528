"""Device resolution (counterpart of thyroid_tpu/ops/tpu_platform.py).

The port runs on the CUDA card unless the caller asks for the CPU. A
missing card is an error, never a silent fall back to the CPU.
"""
from __future__ import annotations

import os
from typing import Union

import torch
import torch.distributed as dist

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None → "cuda"; under a process group (torchrun, parallel.spawn) a
    bare "cuda" is the process's card, cuda:{LOCAL_RANK mod the cards}.
    Raises when a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available() \
            and (dist.is_initialized() or "LOCAL_RANK" in os.environ):
        local = int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def refuse_autograd(name: str, reason: str, *tensors) -> None:
    """Raise when `name`, a forward-only kernel wrapper, is called where
    autograd would record it: grad mode on and any input requiring grad.
    Its gradients would otherwise be silently wrong or absent."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward: {reason}")
