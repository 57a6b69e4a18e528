"""Warm starts from local torch checkpoints (counterpart of
thyroid_tpu/models/import_torch.py). For now only the search for the file:
the importers that turn a timm/torchvision state_dict into the model's
parameters are not ported (ROADMAP Queue 1: Warm start from local torch
checkpoints), so `models/base.py` refuses a found file rather than
training from scratch without a word."""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional


def find_pretrained_file(name: str, pretrained_path: Optional[str] = None,
                         search_dirs: Optional[List[str]] = None) -> Optional[str]:
    """A local torch checkpoint for model `name`: `pretrained_path` when it
    exists (and None when it does not), else the first
    `{name}.{pth,pt,ckpt}` under `search_dirs`, $THYROID_PRETRAINED_DIR,
    then ./weights."""
    if pretrained_path:
        return pretrained_path if Path(pretrained_path).exists() else None
    dirs = list(search_dirs or [])
    if os.environ.get("THYROID_PRETRAINED_DIR"):
        dirs.append(os.environ["THYROID_PRETRAINED_DIR"])
    dirs.append("weights")
    for d in dirs:
        for ext in (".pth", ".pt", ".ckpt"):
            p = Path(d) / f"{name}{ext}"
            if p.exists():
                return str(p)
    return None
