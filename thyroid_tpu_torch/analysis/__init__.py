"""The analysis over the capture path and the eval forward (counterpart of
thyroid_tpu/analysis/, less charts.py and figures.py): GradCAM, attention
maps and rollout, TTA and checkpoint / k-fold ensemble evaluation. The
figure functions import matplotlib when called; `cli.py` drives them.
"""
from .gradcam import gradcam, gradcam_overlay
from .attention import (
    collect_attention_maps, cls_attention_heatmap, attention_rollout,
    gradient_patch_importance, swin_stage_feature_maps, attention_figure,
)
from .evaluation import (
    predict_probs, binary_report, roc_curve_points, evaluate_checkpoint,
    evaluate_ensemble_kfold, confusion_roc_figure,
)

__all__ = [
    "gradcam", "gradcam_overlay", "collect_attention_maps",
    "cls_attention_heatmap", "attention_rollout", "gradient_patch_importance",
    "swin_stage_feature_maps", "attention_figure", "predict_probs",
    "binary_report", "roc_curve_points", "evaluate_checkpoint",
    "evaluate_ensemble_kfold", "confusion_roc_figure",
]
