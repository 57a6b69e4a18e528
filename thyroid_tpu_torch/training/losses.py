"""Loss functions (counterpart of thyroid_tpu/training/losses.py): the
cross-entropy of the "ce" loss mode, the MixUp/CutMix objective, the
distillation losses (soft KL at a temperature, hard CE on the teacher's
argmax) and the progressive α schedule, DeiT's dual-head loss without a
teacher, and the normalisation of tuple outputs to logits."""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def soft_distillation(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor,
                      temperature: float = 4.0) -> torch.Tensor:
    """KL(softmax(teacher/T) ‖ softmax(student/T)) · T², the batch mean;
    the teacher's probabilities clipped to [1e-9, 1] inside the log."""
    t = temperature
    s = torch.log_softmax(student_logits.float() / t, dim=-1)
    p = torch.softmax(teacher_logits.float() / t, dim=-1)
    kl = (p * (torch.log(torch.clamp(p, 1e-9, 1.0)) - s)).sum(dim=-1)
    return kl.mean() * t * t


def hard_distillation(student_logits: torch.Tensor,
                      teacher_logits: torch.Tensor) -> torch.Tensor:
    """CE against the teacher's argmax, no smoothing and no weights."""
    return cross_entropy(student_logits, torch.argmax(teacher_logits, dim=-1))


def distillation_loss(student_outputs, teacher_logits: torch.Tensor,
                      labels: torch.Tensor, alpha=0.7,
                      temperature: float = 4.0,
                      distillation_type: str = "soft",
                      label_smoothing: float = 0.0,
                      weights: Optional[torch.Tensor] = None):
    """(1 − α)·CE(class head, y) + α·distill(dist head, teacher) → (loss,
    {class_loss, distillation_loss, teacher_agreement}). A DeiT student's
    tuple is (cls, dist); a plain student uses its logits for both terms.
    teacher_agreement is the share of the batch whose class-head argmax is
    the teacher's."""
    if isinstance(student_outputs, tuple):
        cls_logits, dist_logits = student_outputs
    else:
        cls_logits = dist_logits = student_outputs
    class_loss = cross_entropy(cls_logits, labels, label_smoothing, weights)
    if distillation_type == "hard":
        dist = hard_distillation(dist_logits, teacher_logits)
    else:
        dist = soft_distillation(dist_logits, teacher_logits, temperature)
    loss = (1.0 - alpha) * class_loss + alpha * dist
    agree = (torch.argmax(cls_logits, -1) == torch.argmax(teacher_logits, -1))
    return loss, {"class_loss": class_loss, "distillation_loss": dist,
                  "teacher_agreement": agree.float().mean()}


def progressive_alpha(epoch: int,
                      schedule: Optional[Sequence[Sequence[float]]] = None,
                      default: float = 0.7) -> float:
    """Piecewise-constant α(epoch) from [[start_epoch, alpha], ...]: the
    last entry whose start is at most `epoch`, else the first entry's α;
    `default` when the schedule is empty."""
    if not schedule:
        return default
    alpha = float(schedule[0][1])
    for start, a in schedule:
        if epoch >= start:
            alpha = float(a)
    return alpha


def deit_dual_loss(outputs: Tuple[torch.Tensor, torch.Tensor],
                   labels: torch.Tensor, label_smoothing: float = 0.0,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """0.5·CE(cls) + 0.5·CE(dist): DeiT trained without a teacher."""
    cls_logits, dist_logits = outputs
    return 0.5 * cross_entropy(cls_logits, labels, label_smoothing, weights) \
        + 0.5 * cross_entropy(dist_logits, labels, label_smoothing, weights)


def classification_outputs_to_logits(outputs) -> torch.Tensor:
    """Plain logits of a model output: a tuple (DeiT's two heads,
    Inception's main and aux heads) averages its members, as JAX's does."""
    if isinstance(outputs, tuple):
        return sum(outputs) / len(outputs)
    return outputs
