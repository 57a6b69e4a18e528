"""The data-quality report (counterpart of
thyroid_tpu/data/quality_report.py): reports/quality_report.json with the
schema the quality preprocessing reads,

    dataset_stats.{split}.metrics = {
        num_images, mean_intensity, std_intensity, min, max, per_image,
        quality_issues: {extreme_dark: [...], low_contrast: [...],
                         potential_artifacts: [...]}   # per-split indices
    }

and a summary. The statistics and issue masks are ops/image.py's
quality_stats and quality_issue_masks, batched on the device (the card
unless the CPU is asked for).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch

from ..ops.image import quality_issue_masks, quality_stats, to_uint16_scale
from ..ops.platform import DeviceLike, resolve_device
from .dataset import CARSThyroidDataset


def analyze_split(images_u16: np.ndarray,
                  device: DeviceLike = None) -> Dict[str, Any]:
    """Per-split statistics and issue index lists of a (N, H, W, 1) uint16
    array."""
    x = to_uint16_scale(torch.from_numpy(images_u16.astype(np.float32))
                        .to(resolve_device(device)))
    s = quality_stats(x)
    stats = {k: v.cpu().numpy() for k, v in s.items()}
    masks = {k: v.cpu().numpy()
             for k, v in quality_issue_masks(x, stats=s).items()}
    return {
        "num_images": int(len(images_u16)),
        "mean_intensity": float(stats["mean"].mean()),
        "std_intensity": float(stats["std"].mean()),
        "min": float(stats["min"].min()),
        "max": float(stats["max"].max()),
        "per_image": {
            "mean": stats["mean"].tolist(),
            "std": stats["std"].tolist(),
            "max": stats["max"].tolist(),
        },
        "quality_issues": {
            "extreme_dark": np.nonzero(masks["extreme_dark"])[0].tolist(),
            "low_contrast": np.nonzero(masks["low_contrast"])[0].tolist(),
            "potential_artifacts": np.nonzero(masks["artifacts"])[0].tolist(),
        },
    }


def generate_quality_report(
    dataset_config: Any,
    output_path: str | Path = "reports/quality_report.json",
    splits: tuple[str, ...] = ("train", "val", "test"),
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """analyze_split of each split of the dataset config's corpus, written
    to `output_path` with the summary (totals, issue counts, the clean
    fraction)."""
    report: Dict[str, Any] = {"dataset_stats": {}}
    for split in splits:
        ds = CARSThyroidDataset(dataset_config, split=split)
        metrics = analyze_split(ds.load_images(), device)
        report["dataset_stats"][split] = {"metrics": metrics}
    total = sum(report["dataset_stats"][s]["metrics"]["num_images"] for s in splits)
    issues = {
        k: sum(len(report["dataset_stats"][s]["metrics"]["quality_issues"][k]) for s in splits)
        for k in ("extreme_dark", "low_contrast", "potential_artifacts")
    }
    report["summary"] = {
        "total_images": total,
        "issue_counts": issues,
        "clean_fraction": 1.0 - min(1.0, sum(issues.values()) / max(total, 1)),
    }
    out = Path(output_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report
