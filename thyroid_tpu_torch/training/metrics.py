"""Classification metrics over sufficient statistics (counterpart of
thyroid_tpu/training/metrics.py).

Each batch adds confusion counts, the weighted loss and its weight sum to
a small dict of device tensors (`update_metric_state`, no host read); the
epoch's scores and labels stay on the device as a list; `finalize_metric_state`
reads everything back once and returns the reference's metric set under the
same keys and prefixes as the JAX package.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

EPS = 1e-6


class ConfusionStats(NamedTuple):
    tp: torch.Tensor
    fp: torch.Tensor
    tn: torch.Tensor
    fn: torch.Tensor


def confusion_stats(preds: torch.Tensor, labels: torch.Tensor,
                    weights: Optional[torch.Tensor] = None) -> ConfusionStats:
    """Binary confusion counts; positive class = 1 (cancerous)."""
    if weights is None:
        weights = torch.ones(labels.shape, dtype=torch.float32,
                             device=labels.device)
    preds, labels = preds.long(), labels.long()
    w = weights.float()
    tp = (w * ((preds == 1) & (labels == 1))).sum()
    fp = (w * ((preds == 1) & (labels == 0))).sum()
    tn = (w * ((preds == 0) & (labels == 0))).sum()
    fn = (w * ((preds == 0) & (labels == 1))).sum()
    return ConfusionStats(tp, fp, tn, fn)


def accuracy(s: ConfusionStats) -> torch.Tensor:
    return (s.tp + s.tn) / torch.clamp(s.tp + s.tn + s.fp + s.fn, min=EPS)


def sensitivity(s: ConfusionStats) -> torch.Tensor:
    """Recall of the positive class."""
    return s.tp / torch.clamp(s.tp + s.fn, min=EPS)


def specificity(s: ConfusionStats) -> torch.Tensor:
    return s.tn / torch.clamp(s.tn + s.fp, min=EPS)


def precision(s: ConfusionStats) -> torch.Tensor:
    """PPV."""
    return s.tp / torch.clamp(s.tp + s.fp, min=EPS)


def npv(s: ConfusionStats) -> torch.Tensor:
    """TN/(TN+FN+1e-6), the reference's exact formula."""
    return s.tn / (s.tn + s.fn + EPS)


def f1_score(s: ConfusionStats) -> torch.Tensor:
    p = precision(s)
    r = sensitivity(s)
    return 2 * p * r / torch.clamp(p + r, min=EPS)


def auroc(scores, labels, weights=None) -> float:
    """Exact AUROC via the Mann-Whitney U statistic with midranks for ties;
    rows of weight 0 are dropped. `scores` are P(class=1)."""
    scores = np.asarray(scores, dtype=np.float64)
    labels = np.asarray(labels)
    if weights is not None:
        keep = np.asarray(weights) > 0
        scores, labels = scores[keep], labels[keep]
    pos = scores[labels == 1]
    neg = scores[labels == 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    allv = np.concatenate([pos, neg])
    order = np.argsort(allv, kind="mergesort")
    ranks = np.empty(len(order), dtype=np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    sorted_v = allv[order]
    i = 0
    while i < len(sorted_v):
        j = i
        while j + 1 < len(sorted_v) and sorted_v[j + 1] == sorted_v[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = (i + j) / 2.0 + 1.0
        i = j + 1
    r_pos = ranks[: len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2.0
    return float(u / (len(pos) * len(neg)))


def zero_metric_state(aux_keys: tuple = (),
                      device=None) -> Dict[str, torch.Tensor]:
    state = {k: torch.zeros((), dtype=torch.float32, device=device)
             for k in ("tp", "fp", "tn", "fn", "loss_sum", "w_sum")}
    for k in aux_keys:
        state[f"aux_{k}"] = torch.zeros((), dtype=torch.float32, device=device)
    return state


def update_metric_state(mstate: Dict[str, torch.Tensor], probs: torch.Tensor,
                        labels: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        loss: Optional[torch.Tensor] = None,
                        aux: Optional[Dict[str, torch.Tensor]] = None):
    """Batch update → (new state, P(class=1) scores). Loss and aux scalars
    accumulate weighted by the batch's weight sum."""
    score1 = probs[:, 1] if probs.dim() == 2 else probs
    preds = (score1 >= 0.5).long()
    w = torch.ones_like(score1) if weights is None else weights.float()
    s = confusion_stats(preds, labels, w)
    w_sum = w.sum()
    new = dict(mstate)
    for k, v in zip(("tp", "fp", "tn", "fn"), s):
        new[k] = mstate[k] + v
    new["w_sum"] = mstate["w_sum"] + w_sum
    if loss is not None:
        new["loss_sum"] = mstate["loss_sum"] + loss.float() * w_sum
    for k, v in (aux or {}).items():
        key = f"aux_{k}"
        if key in mstate:
            new[key] = mstate[key] + v.float() * w_sum
    return new, score1


def finalize_metric_state(mstate: Dict[str, torch.Tensor], scores=None,
                          labels=None, weights=None,
                          prefix: str = "") -> Dict[str, float]:
    """One host read-back at epoch end → the reference's full metric set."""
    host = {k: v.detach().cpu() for k, v in mstate.items()}
    s = ConfusionStats(*(host[k] for k in ("tp", "fp", "tn", "fn")))
    out = {
        "acc": float(accuracy(s)),
        "f1": float(f1_score(s)),
        "sensitivity": float(sensitivity(s)),
        "specificity": float(specificity(s)),
        "ppv": float(precision(s)),
        "npv": float(npv(s)),
    }
    if scores:
        sc = torch.cat([t.detach().float().reshape(-1) for t in scores]).cpu().numpy()
        lb = torch.cat([t.reshape(-1) for t in labels]).cpu().numpy()
        wt = torch.cat([t.reshape(-1) for t in weights]).cpu().numpy() \
            if weights else None
        out["auc"] = auroc(sc, lb, wt)
    w_sum = float(host["w_sum"])
    if w_sum > 0:
        out["loss"] = float(host["loss_sum"]) / w_sum
        for k, v in host.items():
            if k.startswith("aux_"):
                out[k[4:]] = float(v) / w_sum
    return {f"{prefix}{k}": v for k, v in out.items()}
