"""Evaluation artefacts: TTA inference, the binary report, ROC points,
single-checkpoint and k-fold ensemble evaluation, the confusion/ROC figure
(counterpart of thyroid_tpu/analysis/evaluation.py).

The forwards are the models' eval forwards on their device, hand-written
kernels included: kernel 1 prepares each split once, and a Swin, ViT or
DeiT forward runs kernels 2-4 (2-3) as served, five times a batch with
TTA.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import cnn, ensemble, vit  # noqa: F401  (register the model families)
from ..models.from_jax import load_jax_variables
from ..models.registry import ModelRegistry, cfg_get
from ..ops.augment import tta_views
from ..ops.platform import DeviceLike, resolve_device
from ..training.checkpoint import load_checkpoint
from ..training.metrics import auroc
from .gradcam import Variables, apply_model


def eval_batches(pipeline):
    """The batches of one epoch of `pipeline`: an eval pipeline's in order;
    a training pipeline's order and augmentation drawn from seed 0."""
    gen = torch.Generator().manual_seed(0)
    aug = torch.Generator(device=pipeline.device).manual_seed(0)
    return pipeline.epoch(gen, aug)


def predict_probs(model: torch.nn.Module, variables: Variables, pipeline,
                  tta: bool = False) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (probs (N, 2), labels (N,), weights (N,)) over a DevicePipeline,
    the padding rows (weight 0) dropped. With `tta` the probabilities are
    the mean over ops/augment.py's five TTA views. `variables` None runs
    the model's own tensors."""
    all_p, all_l, all_w = [], [], []
    with torch.no_grad():
        for batch in eval_batches(pipeline):
            if tta:
                views = tta_views(batch.image)
                probs = sum(_apply_probs(model, variables, v)
                            for v in views) / len(views)
            else:
                probs = _apply_probs(model, variables, batch.image)
            all_p.append(probs)
            all_l.append(batch.label)
            all_w.append(batch.weight)
    p = torch.cat(all_p).cpu().numpy()
    l = torch.cat(all_l).cpu().numpy()
    w = torch.cat(all_w).cpu().numpy()
    keep = w > 0
    return p[keep], l[keep], w[keep]


def _apply_probs(model, variables, images) -> torch.Tensor:
    out = apply_model(model, variables, images, train=False)
    if isinstance(out, tuple):
        out = out[0]
    return torch.softmax(out.float(), dim=-1)


def binary_report(probs: np.ndarray, labels: np.ndarray) -> Dict[str, Any]:
    """Accuracy, AUC and the confusion-derived sensitivity, specificity,
    PPV, NPV and F1 at threshold 0.5, with the confusion matrix [[tn, fp],
    [fn, tp]]."""
    preds = (probs[:, 1] >= 0.5).astype(int)
    tp = int(((preds == 1) & (labels == 1)).sum())
    fp = int(((preds == 1) & (labels == 0)).sum())
    tn = int(((preds == 0) & (labels == 0)).sum())
    fn = int(((preds == 0) & (labels == 1)).sum())
    eps = 1e-6
    return {
        "accuracy": (tp + tn) / max(len(labels), 1),
        "auc": auroc(probs[:, 1], labels),
        "sensitivity": tp / max(tp + fn, eps),
        "specificity": tn / max(tn + fp, eps),
        "ppv": tp / max(tp + fp, eps),
        "npv": tn / (tn + fn + eps),
        "f1": 2 * tp / max(2 * tp + fp + fn, eps),
        "confusion_matrix": [[tn, fp], [fn, tp]],
    }


def roc_curve_points(probs1: np.ndarray, labels: np.ndarray,
                     n_thresholds: int = 101) -> Tuple[np.ndarray, np.ndarray]:
    """(fpr, tpr) over a sweep of thresholds from 1 down to 0."""
    thresholds = np.linspace(0.0, 1.0, n_thresholds)
    pos = labels == 1
    neg = ~pos
    tpr = np.array([(probs1[pos] >= t).mean() if pos.any() else 0.0
                    for t in thresholds])
    fpr = np.array([(probs1[neg] >= t).mean() if neg.any() else 0.0
                    for t in thresholds])
    return fpr[::-1], tpr[::-1]


def load_model(checkpoint_path: str | Path, model_config: Any = None,
               device: DeviceLike = None
               ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """(the model a checkpoint holds, in eval mode on `device` (the card
    unless the CPU is asked for), its metadata). Without `model_config`
    the model is rebuilt from the config the checkpoint's metadata stores,
    so that no architecture flag it was trained with is lost; a
    checkpoint without one raises."""
    variables, meta = load_checkpoint(checkpoint_path)
    if model_config is None:
        model_config = meta.get("model_config")
        if model_config is None:
            raise ValueError(
                f"checkpoint {checkpoint_path} has no stored model_config; "
                "pass model_config explicitly")
    model = ModelRegistry.create_model(model_config)
    load_jax_variables(model, variables)
    return model.to(resolve_device(device)).eval(), meta


def evaluate_checkpoint(checkpoint_path: str | Path, model_config: Any = None,
                        pipeline=None, tta: bool = False,
                        device: DeviceLike = None) -> Dict[str, Any]:
    """binary_report of a checkpoint over `pipeline` (on the same device),
    with the checkpoint's path and metadata."""
    model, meta = load_model(checkpoint_path, model_config, device)
    probs, labels, _ = predict_probs(model, None, pipeline, tta=tta)
    report = binary_report(probs, labels)
    report["checkpoint"] = str(checkpoint_path)
    report["checkpoint_metadata"] = meta
    return report


def evaluate_ensemble_kfold(
    member_specs: Sequence[Dict[str, Any]],
    fold_pipelines: Dict[int, Any],
    weights: Optional[Sequence[float]] = None,
    output_path: Optional[str | Path] = None,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """A weighted-probability ensemble evaluated per fold, then over the
    folds; default member weights 0.5 / 0.25 / 0.25.

    member_specs: [{"model": config, "checkpoints": {fold: path}}, ...];
    the pipelines on `device` (the card unless the CPU is asked for).

    All three of the ensemble's combination modes come from one forward per
    member and fold: weighted probability averaging (the primary mode),
    simple averaging, and weighted voting (the normalised vote mass), with
    each member's own fold reports beside them.
    """
    if weights is None:
        weights = [0.5, 0.25, 0.25][: len(member_specs)]
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    fold_reports: Dict[str, Any] = {}
    mode_fold_reports: Dict[str, Dict[str, Any]] = {
        "weighted_average": {}, "simple_average": {}, "weighted_voting": {}}
    member_fold_reports: Dict[str, Dict[str, Any]] = {}
    dev = resolve_device(device)
    # one module per member, refilled from each fold's checkpoint
    member_models = [ModelRegistry.create_model(s["model"]).to(dev).eval()
                     for s in member_specs]
    for fold, pipeline in fold_pipelines.items():
        member_probs, labels = [], None
        for spec, model in zip(member_specs, member_models):
            variables, _ = load_checkpoint(spec["checkpoints"][fold])
            load_jax_variables(model, variables)
            probs, labels, _ = predict_probs(model, None, pipeline)
            member_probs.append(probs)
            name = cfg_get(spec["model"], "name", str(len(member_probs)))
            member_fold_reports.setdefault(name, {})[f"fold_{fold}"] = \
                binary_report(probs, labels)
        mp = np.stack(member_probs)                       # (M, N, 2)
        wc = w.reshape(-1, 1, 1)
        votes = np.eye(mp.shape[-1])[mp.argmax(-1)]       # (M, N, 2) one-hot
        combined = {
            "weighted_average": (mp * wc).sum(0),
            "simple_average": mp.mean(0),
            "weighted_voting": (votes * wc).sum(0),
        }
        for mode, cp in combined.items():
            mode_fold_reports[mode][f"fold_{fold}"] = binary_report(cp, labels)
        fold_reports[f"fold_{fold}"] = \
            mode_fold_reports["weighted_average"][f"fold_{fold}"]

    def _agg(reports: Dict[str, Any]) -> Dict[str, Any]:
        accs = [r["accuracy"] for r in reports.values()]
        aucs = [r["auc"] for r in reports.values() if np.isfinite(r["auc"])]
        return {"mean_accuracy": float(np.mean(accs)),
                "std_accuracy": float(np.std(accs)),
                "mean_auc": float(np.mean(aucs)) if aucs else None}

    summary = {
        "weights": w.tolist(),
        "folds": fold_reports,
        **_agg(fold_reports),
        "modes": {mode: {**_agg(reports), "folds": reports}
                  for mode, reports in mode_fold_reports.items()},
        "members": {name: {**_agg(reports), "folds": reports}
                    for name, reports in member_fold_reports.items()},
    }
    if output_path:
        Path(output_path).parent.mkdir(parents=True, exist_ok=True)
        with open(output_path, "w") as f:
            json.dump(summary, f, indent=2, default=str)
    return summary


def confusion_roc_figure(
    reports: Dict[str, Dict[str, Any]],
    roc_data: Dict[str, Tuple[np.ndarray, np.ndarray]],
    output_path: Optional[str | Path] = None,
):
    """Each model's confusion matrix and a combined ROC plot; saved to
    `output_path` (None returns the figure)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(reports)
    fig, axes = plt.subplots(1, n + 1, figsize=(4 * (n + 1), 4))
    axes = np.atleast_1d(axes)
    for ax, (name, rep) in zip(axes[:-1], reports.items()):
        cm = np.asarray(rep["confusion_matrix"])
        ax.imshow(cm, cmap="Blues")
        for i in range(2):
            for j in range(2):
                ax.text(j, i, str(int(cm[i, j])), ha="center", va="center")
        ax.set_title(f"{name}\nacc={rep['accuracy']:.3f}")
        ax.set_xticks([0, 1], ["normal", "cancer"])
        ax.set_yticks([0, 1], ["normal", "cancer"])
        ax.set_xlabel("predicted")
        ax.set_ylabel("true")
    ax = axes[-1]
    for name, (fpr, tpr) in roc_data.items():
        auc_val = reports.get(name, {}).get("auc", float("nan"))
        ax.plot(fpr, tpr, label=f"{name} (AUC={auc_val:.3f})")
    ax.plot([0, 1], [0, 1], "k--", alpha=0.4)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.set_title("ROC")
    ax.legend(fontsize=8)
    fig.tight_layout()
    if output_path:
        fig.savefig(output_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig
