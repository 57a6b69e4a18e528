"""Loss functions (counterpart of thyroid_tpu/training/losses.py): the
cross-entropy the "ce" loss mode uses and the MixUp/CutMix objective."""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean weighted CE over the batch in float32; labels are int class
    ids. With weights, Σ w·CE / max(Σ w, 1e-6)."""
    num_classes = logits.shape[-1]
    onehot = F.one_hot(labels.long(), num_classes).float()
    if label_smoothing > 0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    logp = torch.log_softmax(logits.float(), dim=-1)
    per_sample = -(onehot * logp).sum(dim=-1)
    if weights is None:
        return per_sample.mean()
    w = weights.float()
    return (per_sample * w).sum() / torch.clamp(w.sum(), min=1e-6)


def mixed_cross_entropy(logits: torch.Tensor, labels_a: torch.Tensor,
                        labels_b: torch.Tensor, lam,
                        label_smoothing: float = 0.0,
                        weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The MixUp/CutMix objective λ·CE(y_a) + (1 − λ)·CE(y_b)."""
    return lam * cross_entropy(logits, labels_a, label_smoothing, weights) + \
        (1.0 - lam) * cross_entropy(logits, labels_b, label_smoothing, weights)
