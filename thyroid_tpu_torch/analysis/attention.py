"""Attention-map analysis over the models' capture path (counterpart of
thyroid_tpu/analysis/attention.py): the class-token attention heatmap,
attention rollout, gradient patch importance, Swin's per-stage activity
maps and the overlay figure.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .gradcam import Variables, apply_model, capture_forward, upsample


def collect_attention_maps(model: torch.nn.Module, variables: Variables,
                           image: torch.Tensor) -> List[np.ndarray]:
    """Every captured attention tensor (B, heads, N, N), as float32 numpy,
    in the order of the sorted capture keys. That is the JAX package's
    order, which sorts its keys as strings: from 11 blocks on it runs 0,
    1, 10, 11, 2, …, 9, not in depth order (the rollout multiplies them so,
    and the Trainer's logging draws the last, block 9 of a 12-block ViT)."""
    _, inter = capture_forward(model, variables, image)
    out = []
    for name, v in inter.items():
        if "attention" in name and v.dim() == 4 and v.shape[-1] == v.shape[-2]:
            out.append(v.float().cpu().numpy())
    return out


def cls_attention_heatmap(attn: np.ndarray, has_cls: bool = True) -> np.ndarray:
    """The head-averaged class-token row (or, without a class token, the
    mean row) of the first image's attention, as a max-normalised square
    map."""
    a = attn[0].mean(axis=0)             # (N, N)
    row = a[0, 1:] if has_cls else a.mean(axis=0)
    side = int(np.sqrt(len(row)))
    row = row[: side * side]
    hm = row.reshape(side, side)
    return hm / hm.max() if hm.max() > 0 else hm


def attention_rollout(attn_maps: List[np.ndarray],
                      residual: float = 0.5) -> np.ndarray:
    """Attention rollout (Abnar & Zuidema): the head-averaged attention of
    each map, mixed with the identity and row-normalised, multiplied over
    the maps in the order given; the class-token row as a square map."""
    joint: Optional[np.ndarray] = None
    for attn in attn_maps:
        a = attn[0].mean(axis=0)
        a = residual * a + (1 - residual) * np.eye(a.shape[-1])
        a = a / a.sum(axis=-1, keepdims=True)
        joint = a if joint is None else a @ joint
    row = joint[0, 1:]
    side = int(np.sqrt(len(row)))
    hm = row[: side * side].reshape(side, side)
    return hm / hm.max() if hm.max() > 0 else hm


def gradient_patch_importance(model: torch.nn.Module, variables: Variables,
                              image: torch.Tensor, patch_size: int = 16,
                              class_idx: Optional[int] = None) -> np.ndarray:
    """|d score / d input| of the eval forward, pooled per patch and
    max-normalised. Autograd runs through the model as it was built: the
    token kernels 2 and 3 (ViT/DeiT with `token_kernels`) have backward
    kernels, the serving windows attention of a Swin built with its
    kernels has none and raises (ops/platform.py refuse_autograd), on the
    card and on the CPU alike; build the model with `token_kernels:
    false` / `use_pallas_attention: false` for the plain path, as the
    analysis CLI does."""
    img = image.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        out = apply_model(model, variables, img, train=False)
        if isinstance(out, tuple):
            out = out[0]
        c = class_idx if class_idx is not None else int(torch.argmax(out[0]))
        (g,) = torch.autograd.grad(out[0, c], img)
    g = np.abs(g.float().cpu().numpy())[0, :, :, 0]
    h, w = g.shape
    ph, pw = h // patch_size, w // patch_size
    g = g[: ph * patch_size, : pw * patch_size]
    pooled = g.reshape(ph, patch_size, pw, patch_size).mean(axis=(1, 3))
    return pooled / pooled.max() if pooled.max() > 0 else pooled


def swin_stage_feature_maps(model: torch.nn.Module, variables: Variables,
                            image: torch.Tensor) -> List[np.ndarray]:
    """Per-stage activity maps of a Swin: the channel std of each stage's
    tokens (before its merge) for the first image, max-normalised."""
    _, inter = capture_forward(model, variables, image)
    maps = []
    for name, v in inter.items():
        if "stage_features" in name:
            arr = v[0].float().cpu().numpy()
            side = int(np.sqrt(arr.shape[0]))
            stds = arr.std(axis=-1)[: side * side].reshape(side, side)
            maps.append(stds / stds.max() if stds.max() > 0 else stds)
    return maps


def attention_figure(image: np.ndarray, heatmaps: Dict[str, np.ndarray],
                     output_path: Optional[str] = None):
    """The input and each heatmap over it, three panels a row; saved to
    `output_path` (None returns the figure)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(heatmaps) + 1
    cols = min(3, n)
    rows = -(-n // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(5 * cols, 5 * rows))
    axes = np.atleast_1d(axes).ravel()
    axes[0].imshow(image.squeeze(), cmap="gray")
    axes[0].set_title("input")
    h, w = image.shape[:2]
    for ax, (name, hm) in zip(axes[1:], heatmaps.items()):
        ax.imshow(image.squeeze(), cmap="gray")
        ax.imshow(upsample(hm, h, w), cmap="jet", alpha=0.45)
        ax.set_title(name)
    for ax in axes:
        ax.axis("off")
    if output_path:
        fig.savefig(output_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig
