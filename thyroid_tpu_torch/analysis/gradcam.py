"""GradCAM over the models' capture path (counterpart of
thyroid_tpu/analysis/gradcam.py).

The capture forward (`forward(x, capture=True)`) records the GradCAM
target: the tokens after the final norm for ViT, DeiT and Swin
("final_tokens"), the last feature map for the CNNs ("features"). Both sit
just before the classification head, so the gradient of the class score
with respect to them is the gradient through the re-applied head, which
autograd takes here where the JAX package takes jax.grad. The capture
forward runs without gradients and no hand-written kernel; only the head
is differentiated.

Weighting as the JAX package's: channel weights are the gradients pooled
over all positions, heatmap = ReLU(mean_c w_c · act_c), max-normalised,
the class (and distillation) token stripped when the token count is not
square.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.func import functional_call

from ..ops.image import resize_bilinear

Variables = Optional[Mapping[str, torch.Tensor]]


def apply_model(model: torch.nn.Module, variables: Variables,
                x: torch.Tensor, **kw):
    """model(x, **kw) with its own tensors, or with `variables` ({port
    name: tensor}, as TrainState.variables gives) in their place."""
    if variables is None:
        return model(x, **kw)
    return functional_call(model, dict(variables), (x,), kw)


def capture_forward(model: torch.nn.Module, variables: Variables,
                    image: torch.Tensor) -> Tuple[Any, Dict[str, torch.Tensor]]:
    """The eval forward with capture, without gradients → (output,
    intermediates by key in the JAX package's order)."""
    with torch.no_grad():
        return apply_model(model, variables, image, train=False, capture=True)


def _final_activation(intermediates: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The GradCAM target among the captured tensors: ViT/DeiT/Swin record
    'final_tokens', CNNs 'features'."""
    for key in ("final_tokens", "features"):
        hits = [v for name, v in intermediates.items() if key in name]
        if hits:
            return hits[-1]
    raise ValueError(f"no GradCAM target in intermediates: {list(intermediates)}")


def gradcam(model: torch.nn.Module, variables: Variables,
            image: torch.Tensor,
            class_idx: Optional[int] = None) -> Tuple[np.ndarray, int, float]:
    """→ (heatmap in [0, 1], predicted or queried class, confidence).

    image: (1, H, W, C) preprocessed input on the model's device;
    `variables` None runs the model's own tensors."""
    logits, inter = capture_forward(model, variables, image)
    if isinstance(logits, tuple):
        logits = logits[0]
    probs = torch.softmax(logits, dim=-1)
    cls = int(class_idx) if class_idx is not None else int(torch.argmax(logits[0]))
    confidence = float(probs[0, cls])
    act = _final_activation(inter)
    eps = torch.zeros_like(act, requires_grad=True)
    with torch.enable_grad():
        score = _apply_head(model, variables, act + eps)[0, cls]
        (grads,) = torch.autograd.grad(score, eps)
    heatmap = _weight_and_pool(act.float().cpu().numpy(),
                               grads.float().cpu().numpy())
    return heatmap, cls, confidence


def _head(model: torch.nn.Module, variables: Variables):
    """(kernel, bias) of the classification head, `head`, `fc` or
    `classifier` as the JAX package looks them up."""
    name = next(n for n in ("head", "fc", "classifier")
                if hasattr(model, n) and hasattr(getattr(model, n), "kernel"))
    module = getattr(model, name)
    if variables is None:
        return module.kernel, module.bias
    return variables[f"{name}.kernel"], variables.get(f"{name}.bias")


def _apply_head(model: torch.nn.Module, variables: Variables,
                act: torch.Tensor) -> torch.Tensor:
    """The classification head re-applied to a (perturbed) captured
    activation, by the JAX package's rule: tokens (B, N, D) pool the class
    token where the model has `pool_type` "cls" and `class_token`, else
    the mean of all tokens (so DeiT, which has neither attribute, the mean
    over its class and distillation tokens too); conv features (B, H, W,
    C) their spatial mean."""
    kernel, bias = _head(model, variables)
    if act.dim() == 3:
        pool_cls = getattr(model, "pool_type", "gap") == "cls" and \
            getattr(model, "class_token", False)
        feat = act[:, 0] if pool_cls else act.mean(dim=1)
    else:
        feat = act.mean(dim=(1, 2))
    out = feat.float() @ kernel.float()
    return out + bias.float() if bias is not None else out


def _weight_and_pool(act: np.ndarray, grads: np.ndarray) -> np.ndarray:
    """Pool the gradients over positions → weight the channels → mean →
    ReLU → max-normalise; strip the class/distillation tokens when the
    token count is not a perfect square."""
    act = act[0]
    grads = grads[0]
    if act.ndim == 3:  # conv features (H, W, C)
        weights = grads.mean(axis=(0, 1))
        heat = np.maximum((act * weights).mean(axis=-1), 0.0)
        return heat / heat.max() if heat.max() > 0 else heat
    # token features (N, D)
    n, _ = act.shape
    weights = grads.mean(axis=0)
    side = int(np.sqrt(n))
    if side * side != n:
        for strip in (1, 2):  # CLS / CLS+dist tokens
            side = int(np.sqrt(n - strip))
            if side * side == n - strip:
                act = act[strip:]
                break
        else:
            raise ValueError(f"token count {n} is not square(+1|+2)")
    heat = np.maximum((act * weights).mean(axis=-1), 0.0)
    heat = heat / heat.max() if heat.max() > 0 else heat
    return heat.reshape(side, side)


def upsample(heatmap: np.ndarray, h: int, w: int) -> np.ndarray:
    """A heatmap bilinearly resized to (h, w) (ops/image.py resize_bilinear,
    cv2's INTER_LINEAR rule), on the CPU."""
    hm = torch.from_numpy(np.asarray(heatmap, np.float32)[None, :, :, None])
    return resize_bilinear(hm, (h, w))[0, :, :, 0].numpy()


def gradcam_overlay(heatmap: np.ndarray, image: np.ndarray,
                    output_path: Optional[str] = None, title: str = ""):
    """Input, heatmap and a contour overlay side by side; saved to
    `output_path` (None returns the figure)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h, w = image.shape[:2]
    hm = upsample(heatmap, h, w)
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(image.squeeze(), cmap="gray")
    axes[0].set_title("input")
    axes[1].imshow(hm, cmap="jet")
    axes[1].set_title("Grad-CAM")
    axes[2].imshow(image.squeeze(), cmap="gray")
    axes[2].imshow(hm, cmap="jet", alpha=0.4)
    axes[2].contour(hm, levels=[0.5, 0.75], colors="cyan", linewidths=1.0)
    axes[2].set_title(title or "overlay")
    for ax in axes:
        ax.axis("off")
    if output_path:
        fig.savefig(output_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return None
    return fig
