"""Warm starts from local torch checkpoints (counterpart of
thyroid_tpu/models/import_torch.py): timm / torchvision state_dicts turned
into the JAX variable tree of a registered model, which
models/from_jax.py:load_jax_variables then loads into the port's module.

Every importer returns the tree the JAX package's importer of the same
name returns on the same state_dict, float32 numpy arrays in the JAX
layouts:
- conv weight  OIHW → HWIO
- linear weight (out, in) → (in, out)
- BatchNorm  weight/bias/running_mean/running_var → scale/bias + batch_stats
- first conv RGB → grayscale by channel averaging, grayscale → C channels
  by repetition over C
- learnable pos-embed resized bicubically on a token-grid mismatch, with
  cv2's INTER_CUBIC rules written out in numpy (the card's machine has no
  cv2)
A classifier head whose class count differs from the model's is skipped and
keeps its seeded init. `maybe_load_pretrained` applies a config's
`pretrained` / `pretrained_path` to a freshly initialised module.
"""
from __future__ import annotations

import copy
import logging
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from .from_jax import load_jax_variables, to_jax_variables
from .registry import cfg_get

logger = logging.getLogger(__name__)


def _np(t) -> np.ndarray:
    if hasattr(t, "detach"):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def conv_to_flax(w, in_channels: Optional[int] = None) -> np.ndarray:
    """OIHW → HWIO, averaging RGB→gray when in_channels=1 vs torch's 3."""
    w = _np(w).transpose(2, 3, 1, 0)  # HWIO
    if in_channels is not None and w.shape[2] != in_channels:
        if in_channels == 1:
            w = w.mean(axis=2, keepdims=True)
        elif w.shape[2] == 1:
            w = np.repeat(w, in_channels, axis=2) / in_channels
        else:
            raise ValueError(f"cannot adapt conv from {w.shape[2]} to "
                             f"{in_channels} input channels")
    return w


def linear_to_flax(w) -> np.ndarray:
    return _np(w).T


# cv2's INTER_CUBIC kernel parameter
_CUBIC_A = np.float32(-0.75)


def _cubic_taps(dst: int, src: int) -> Tuple[np.ndarray, np.ndarray]:
    """(source indices (dst, 4), weights (dst, 4)) of cv2.resize's
    INTER_CUBIC along one axis of `src` samples resized to `dst`: half-pixel
    centres, the source position and its weights in float32, a = −0.75,
    indices clamped at the border, no antialiasing when shrinking."""
    scale = 1.0 / (dst / src)
    fx = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5) \
        .astype(np.float32)
    sx = np.floor(fx)
    x = (fx - sx).astype(np.float32)
    a, one = _CUBIC_A, np.float32(1)
    x1, rx = x + one, one - x
    w0 = ((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a
    w1 = ((a + 2) * x - (a + 3)) * x * x + one
    w2 = ((a + 2) * rx - (a + 3)) * rx * rx + one
    w3 = one - w0 - w1 - w2
    idx = np.clip(sx.astype(np.int64)[:, None] + np.arange(-1, 3), 0, src - 1)
    return idx, np.stack([w0, w1, w2, w3], axis=1).astype(np.float32)


def _cubic_axis(grid: np.ndarray, dst: int, axis: int) -> np.ndarray:
    idx, w = _cubic_taps(dst, grid.shape[axis])
    shape = [1] * grid.ndim
    shape[axis] = dst
    taps = [np.take(grid, idx[:, k], axis=axis)
            * w[:, k].astype(grid.dtype).reshape(shape) for k in range(4)]
    return ((taps[0] + taps[1]) + taps[2]) + taps[3]


def bicubic_resize(grid: np.ndarray, side: int) -> np.ndarray:
    """cv2.resize(grid, (side, side), interpolation=cv2.INTER_CUBIC) of an
    (h, w, channels) float array, any number of channels: each row
    resized first, then each column, in the array's float type (float32
    unless float64), as cv2 does."""
    grid = np.asarray(grid)
    if grid.dtype != np.float64:
        grid = grid.astype(np.float32)
    if grid.shape[:2] == (side, side):
        return grid.copy()
    return _cubic_axis(_cubic_axis(grid, side, 1), side, 0)


def interpolate_pos_embed(pe: np.ndarray, target_tokens: int,
                          num_prefix_tokens: int = 1) -> np.ndarray:
    """Bicubic grid interpolation of a (1, N+prefix, D) learnable pos-embed
    (reference: deit_models.py:166-188)."""
    prefix = pe[:, :num_prefix_tokens]
    grid = pe[0, num_prefix_tokens:]
    n_old = grid.shape[0]
    side_old = int(np.sqrt(n_old))
    side_new = int(np.sqrt(target_tokens - num_prefix_tokens))
    if side_old * side_old != n_old:
        raise ValueError(f"pos-embed token count {n_old} is not square")
    grid = grid.reshape(side_old, side_old, -1)
    grid = bicubic_resize(grid, side_new)
    grid = grid.reshape(1, side_new * side_new, -1)
    return np.concatenate([prefix, grid], axis=1)


def _set(tree: Dict, path: Tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


# ---------------------------------------------------------------------------
# ResNet (torchvision naming: conv1, bn1, layerX.Y.convZ/bnZ/downsample)
# ---------------------------------------------------------------------------

def import_resnet(state_dict: Mapping[str, Any], in_channels: int = 1,
                  num_classes: Optional[int] = 2) -> Dict[str, Any]:
    """→ {"params": ..., "batch_stats": ...} matching models.cnn.resnet.ResNet.

    The classifier head is skipped when its shape mismatches num_classes
    (warm start keeps a fresh head, like the reference's strict=False loads).
    """
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def bn(src_prefix: str, dst: Tuple[str, ...]) -> None:
        _set(params, dst + ("scale",), _np(state_dict[f"{src_prefix}.weight"]))
        _set(params, dst + ("bias",), _np(state_dict[f"{src_prefix}.bias"]))
        _set(stats, dst + ("mean",), _np(state_dict[f"{src_prefix}.running_mean"]))
        _set(stats, dst + ("var",), _np(state_dict[f"{src_prefix}.running_var"]))

    _set(params, ("conv1", "kernel"),
         conv_to_flax(state_dict["conv1.weight"], in_channels))
    bn("bn1", ("bn1", "BatchNorm_0"))
    # our ResNet names: layer{s}_{i} / ConvBN_{j} {Conv_0, BatchNorm_0}
    layer_sizes: Dict[int, int] = {}
    for key in state_dict:
        m = key.split(".")
        if m[0].startswith("layer") and m[1].isdigit():
            s = int(m[0][5:])
            layer_sizes[s] = max(layer_sizes.get(s, 0), int(m[1]) + 1)
    for s in sorted(layer_sizes):
        for i in range(layer_sizes[s]):
            src = f"layer{s}.{i}"
            dst_block = f"layer{s}_{i}"
            n_convs = len({k.split(".")[2] for k in state_dict
                           if k.startswith(f"{src}.conv")})
            for c in range(1, n_convs + 1):
                dst = (dst_block, f"ConvBN_{c - 1}")
                _set(params, dst + ("Conv_0", "kernel"),
                     conv_to_flax(state_dict[f"{src}.conv{c}.weight"]))
                bn(f"{src}.bn{c}", dst + ("BatchNorm_0",))
            if f"{src}.downsample.0.weight" in state_dict:
                dst = (dst_block, "downsample")
                _set(params, dst + ("Conv_0", "kernel"),
                     conv_to_flax(state_dict[f"{src}.downsample.0.weight"]))
                bn(f"{src}.downsample.1", dst + ("BatchNorm_0",))
    fc_w = _np(state_dict["fc.weight"])
    if num_classes is None or fc_w.shape[0] == num_classes:
        _set(params, ("fc", "kernel"), linear_to_flax(state_dict["fc.weight"]))
        _set(params, ("fc", "bias"), _np(state_dict["fc.bias"]))
    # our bn1 path: the stem BN is named 'bn1' directly (not nested)
    params["bn1"] = params["bn1"]["BatchNorm_0"]
    stats["bn1"] = stats["bn1"]["BatchNorm_0"]
    return {"params": params, "batch_stats": stats}


# ---------------------------------------------------------------------------
# ViT / DeiT (timm naming: patch_embed.proj, blocks.N.{norm1,attn.qkv,...})
# ---------------------------------------------------------------------------

def import_vit(state_dict: Mapping[str, Any], in_channels: int = 1,
               num_classes: Optional[int] = 2,
               target_tokens: Optional[int] = None,
               distillation: bool = False) -> Dict[str, Any]:
    """→ {"params": ...} matching models.vit.vit.VisionTransformer /
    models.vit.deit.DeiT."""
    params: Dict[str, Any] = {}
    prefix_tokens = 2 if distillation else 1

    _set(params, ("patch_embed", "proj", "kernel"),
         conv_to_flax(state_dict["patch_embed.proj.weight"], in_channels))
    _set(params, ("patch_embed", "proj", "bias"),
         _np(state_dict["patch_embed.proj.bias"]))
    params["cls_token"] = _np(state_dict["cls_token"])
    if distillation and "dist_token" in state_dict:
        params["dist_token"] = _np(state_dict["dist_token"])
    pe = _np(state_dict["pos_embed"])
    if target_tokens is not None and pe.shape[1] != target_tokens:
        pe = interpolate_pos_embed(pe, target_tokens, prefix_tokens)
    params["pos_embed"] = pe

    depth = 1 + max(int(k.split(".")[1]) for k in state_dict
                    if k.startswith("blocks."))
    for i in range(depth):
        src = f"blocks.{i}"
        dst = f"block_{i}"

        def ln(name_src, name_dst):
            _set(params, (dst, name_dst, "scale"),
                 _np(state_dict[f"{src}.{name_src}.weight"]))
            _set(params, (dst, name_dst, "bias"),
                 _np(state_dict[f"{src}.{name_src}.bias"]))

        ln("norm1", "LayerNorm_0")
        ln("norm2", "LayerNorm_1")
        att = (dst, "Attention_0")
        _set(params, att + ("Dense_0", "kernel"),
             linear_to_flax(state_dict[f"{src}.attn.qkv.weight"]))
        if f"{src}.attn.qkv.bias" in state_dict:
            _set(params, att + ("Dense_0", "bias"),
                 _np(state_dict[f"{src}.attn.qkv.bias"]))
        _set(params, att + ("Dense_1", "kernel"),
             linear_to_flax(state_dict[f"{src}.attn.proj.weight"]))
        _set(params, att + ("Dense_1", "bias"),
             _np(state_dict[f"{src}.attn.proj.bias"]))
        mlp = (dst, "Mlp_0")
        _set(params, mlp + ("Dense_0", "kernel"),
             linear_to_flax(state_dict[f"{src}.mlp.fc1.weight"]))
        _set(params, mlp + ("Dense_0", "bias"),
             _np(state_dict[f"{src}.mlp.fc1.bias"]))
        _set(params, mlp + ("Dense_1", "kernel"),
             linear_to_flax(state_dict[f"{src}.mlp.fc2.weight"]))
        _set(params, mlp + ("Dense_1", "bias"),
             _np(state_dict[f"{src}.mlp.fc2.bias"]))

    _set(params, ("norm", "scale"), _np(state_dict["norm.weight"]))
    _set(params, ("norm", "bias"), _np(state_dict["norm.bias"]))
    head_w = _np(state_dict.get("head.weight", np.zeros((0, 0))))
    if num_classes is None or head_w.shape[:1] == (num_classes,):
        _set(params, ("head", "kernel"), linear_to_flax(state_dict["head.weight"]))
        _set(params, ("head", "bias"), _np(state_dict["head.bias"]))
        if distillation and "head_dist.weight" in state_dict:
            _set(params, ("head_dist", "kernel"),
                 linear_to_flax(state_dict["head_dist.weight"]))
            _set(params, ("head_dist", "bias"),
                 _np(state_dict["head_dist.bias"]))
    return {"params": params}


# ---------------------------------------------------------------------------
# Swin (timm naming: patch_embed.proj/norm, layers.I.blocks.J.{norm1,attn.*,
# norm2,mlp.fc1/fc2}, layers.I.downsample.{reduction,norm}, norm, head)
# Reference anchor: swin_transformer.py:697-775 load_pretrained_swin_from_timm.
# ---------------------------------------------------------------------------

def import_swin(state_dict: Mapping[str, Any], in_channels: int = 1,
                num_classes: Optional[int] = 2) -> Dict[str, Any]:
    """→ {"params": ...} matching models.vit.swin.SwinTransformer.

    Relative-position bias tables transfer verbatim ((2w−1)², nH layout in
    both); relative_position_index buffers are recomputed constants here and
    are skipped. Medical-adaptation params (quality gates, contrast scales,
    uncertainty head) have no timm source and keep their fresh init."""
    params: Dict[str, Any] = {}

    def ln(src: str, dst: Tuple[str, ...]) -> None:
        _set(params, dst + ("scale",), _np(state_dict[f"{src}.weight"]))
        _set(params, dst + ("bias",), _np(state_dict[f"{src}.bias"]))

    _set(params, ("patch_embed", "kernel"),
         conv_to_flax(state_dict["patch_embed.proj.weight"], in_channels))
    _set(params, ("patch_embed", "bias"), _np(state_dict["patch_embed.proj.bias"]))
    if "patch_embed.norm.weight" in state_dict:
        ln("patch_embed.norm", ("patch_norm",))
    if "absolute_pos_embed" in state_dict:
        params["absolute_pos_embed"] = _np(state_dict["absolute_pos_embed"])

    n_stages = 1 + max(int(k.split(".")[1]) for k in state_dict
                       if k.startswith("layers."))
    for i in range(n_stages):
        blocks = {int(k.split(".")[3]) for k in state_dict
                  if k.startswith(f"layers.{i}.blocks.")}
        for j in sorted(blocks):
            src = f"layers.{i}.blocks.{j}"
            dst = (f"stage_{i}", f"block_{j}")
            ln(f"{src}.norm1", dst + ("norm1",))
            ln(f"{src}.norm2", dst + ("norm2",))
            att = dst + ("attn",)
            _set(params, att + ("relative_position_bias_table",),
                 _np(state_dict[f"{src}.attn.relative_position_bias_table"]))
            _set(params, att + ("qkv", "kernel"),
                 linear_to_flax(state_dict[f"{src}.attn.qkv.weight"]))
            if f"{src}.attn.qkv.bias" in state_dict:
                _set(params, att + ("qkv", "bias"),
                     _np(state_dict[f"{src}.attn.qkv.bias"]))
            _set(params, att + ("proj", "kernel"),
                 linear_to_flax(state_dict[f"{src}.attn.proj.weight"]))
            _set(params, att + ("proj", "bias"),
                 _np(state_dict[f"{src}.attn.proj.bias"]))
            mlp = dst + ("mlp",)
            _set(params, mlp + ("Dense_0", "kernel"),
                 linear_to_flax(state_dict[f"{src}.mlp.fc1.weight"]))
            _set(params, mlp + ("Dense_0", "bias"),
                 _np(state_dict[f"{src}.mlp.fc1.bias"]))
            _set(params, mlp + ("Dense_1", "kernel"),
                 linear_to_flax(state_dict[f"{src}.mlp.fc2.weight"]))
            _set(params, mlp + ("Dense_1", "bias"),
                 _np(state_dict[f"{src}.mlp.fc2.bias"]))
        if f"layers.{i}.downsample.reduction.weight" in state_dict:
            ds = (f"stage_{i}", "downsample")
            ln(f"layers.{i}.downsample.norm", ds + ("norm",))
            _set(params, ds + ("reduction", "kernel"),
                 linear_to_flax(state_dict[f"layers.{i}.downsample.reduction.weight"]))

    ln("norm", ("norm",))
    head_w = _np(state_dict.get("head.weight", np.zeros((0, 0))))
    if head_w.size and (num_classes is None or head_w.shape[0] == num_classes):
        _set(params, ("head", "kernel"), linear_to_flax(state_dict["head.weight"]))
        _set(params, ("head", "bias"), _np(state_dict["head.bias"]))
    return {"params": params}


# ---------------------------------------------------------------------------
# Swin, reference-NATIVE naming — checkpoints produced by the reference's own
# from-scratch stack (src/models/vit/swin_transformer.py), which differs from
# timm: bare-conv `patch_embed.{weight,bias}`, `patch_norm_layer`, Sequential
# MLP `mlp.{0,3}`, and medical extras `attn.contrast_scale` /
# `attn.quality_gate.*` / `downsample.quality_weight.*` / `uncertainty_head.*`
# plus dead `cls_token`/`pos_embed` inherited from VisionTransformerBase
# (never used by SwinTransformer.forward_features, :607-634).
# ---------------------------------------------------------------------------

def import_swin_reference(state_dict: Mapping[str, Any], in_channels: int = 1,
                          num_classes: Optional[int] = 2) -> Dict[str, Any]:
    """Reference-native Swin state_dict → flax params.

    Normalises the reference's naming to timm-style and delegates to
    `import_swin`, then transfers the medical extras that are ACTIVE in the
    reference's runtime path:
    - `attn.contrast_scale` (scales attention logits post-mask pre-softmax,
      swin_transformer.py:168-169) → our WindowAttention `contrast_scale`
      (only picked up by a model built with contrast_adaptive=True).
    - `uncertainty_head.{0,3}` (Linear→ReLU→Dropout→Linear, :587-593) →
      our `uncertainty_1`/`uncertainty_2`.
    Dropped as dead in the reference forward: `cls_token`/`pos_embed` (base-
    class leftovers), `attn.quality_gate.*` (gated on quality_scores that are
    always None, :177-179), `downsample.quality_weight.*` (the defective
    merge branch, :383-391), `patch_embed.quality_*`.
    """
    timm_like: Dict[str, Any] = {}
    contrast: Dict[Tuple[int, int], np.ndarray] = {}
    unc: Dict[str, Any] = {}
    for k, v in state_dict.items():
        if k in ("cls_token", "pos_embed") or ".quality_gate." in k \
                or ".quality_weight." in k or ".quality_score" in k:
            continue
        if k == "patch_embed.weight":
            timm_like["patch_embed.proj.weight"] = v
            continue
        if k == "patch_embed.bias":
            timm_like["patch_embed.proj.bias"] = v
            continue
        if k.startswith("patch_norm_layer."):
            timm_like["patch_embed.norm." + k.split(".", 1)[1]] = v
            continue
        if k.startswith("uncertainty_head."):
            unc[k] = v
            continue
        m = re.fullmatch(r"(layers\.\d+\.blocks\.\d+)\.mlp\.(\d+)\.(weight|bias)", k)
        if m:
            fc = {"0": "fc1", "3": "fc2"}[m.group(2)]
            timm_like[f"{m.group(1)}.mlp.{fc}.{m.group(3)}"] = v
            continue
        m = re.fullmatch(r"layers\.(\d+)\.blocks\.(\d+)\.attn\.contrast_scale", k)
        if m:
            contrast[(int(m.group(1)), int(m.group(2)))] = _np(v)
            continue
        timm_like[k] = v

    out = import_swin(timm_like, in_channels, num_classes)
    params = out["params"]
    for (i, j), cs in contrast.items():
        _set(params, (f"stage_{i}", f"block_{j}", "attn", "contrast_scale"), cs)
    if "uncertainty_head.0.weight" in unc:
        _set(params, ("uncertainty_1", "kernel"),
             linear_to_flax(unc["uncertainty_head.0.weight"]))
        _set(params, ("uncertainty_1", "bias"), _np(unc["uncertainty_head.0.bias"]))
        _set(params, ("uncertainty_2", "kernel"),
             linear_to_flax(unc["uncertainty_head.3.weight"]))
        _set(params, ("uncertainty_2", "bias"), _np(unc["uncertainty_head.3.bias"]))
    return out


# ---------------------------------------------------------------------------
# Name-based importers for DenseNet / EfficientNet / Inception (timm /
# torchvision key naming). Order-based matching (below) remains the fallback
# for checkpoints with unrecognised naming, but against genuine timm
# state_dicts these maps are robust to any module-registration-order
# difference (reference wrappers:
# src/models/cnn/{densenet.py:37-43,efficientnet.py:16,inception.py:13}).
# ---------------------------------------------------------------------------

class _NamedImport:
    """Collects params/batch_stats while mapping dotted torch names."""

    def __init__(self, state_dict: Mapping[str, Any]):
        self.sd = state_dict
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}

    def conv(self, src: str, dst: Tuple[str, ...],
             in_channels: Optional[int] = None, bias: bool = False) -> None:
        _set(self.params, dst + ("kernel",),
             conv_to_flax(self.sd[f"{src}.weight"], in_channels))
        if bias:
            _set(self.params, dst + ("bias",), _np(self.sd[f"{src}.bias"]))

    def bn(self, src: str, dst: Tuple[str, ...]) -> None:
        _set(self.params, dst + ("scale",), _np(self.sd[f"{src}.weight"]))
        _set(self.params, dst + ("bias",), _np(self.sd[f"{src}.bias"]))
        _set(self.stats, dst + ("mean",), _np(self.sd[f"{src}.running_mean"]))
        _set(self.stats, dst + ("var",), _np(self.sd[f"{src}.running_var"]))

    def convbn(self, src: str, dst: Tuple[str, ...],
               in_channels: Optional[int] = None) -> None:
        """timm/torchvision BasicConv2d ({src}.conv + {src}.bn) → our ConvBN
        ({dst}.Conv_0 + {dst}.BatchNorm_0)."""
        self.conv(f"{src}.conv", dst + ("Conv_0",), in_channels)
        self.bn(f"{src}.bn", dst + ("BatchNorm_0",))

    def dense(self, src: str, dst: Tuple[str, ...],
              num_classes: Optional[int]) -> bool:
        w = _np(self.sd[f"{src}.weight"])
        if num_classes is not None and w.shape[0] != num_classes:
            return False  # mismatched classifier head → keep fresh init
        _set(self.params, dst + ("kernel",), linear_to_flax(w))
        _set(self.params, dst + ("bias",), _np(self.sd[f"{src}.bias"]))
        return True

    def out(self) -> Dict[str, Any]:
        return {"params": self.params, "batch_stats": self.stats}


def import_densenet(state_dict: Mapping[str, Any], in_channels: int = 1,
                    num_classes: Optional[int] = 2) -> Dict[str, Any]:
    """timm/torchvision DenseNet naming (features.denseblockB.denselayerL.
    {norm1,conv1,norm2,conv2}, features.transitionB.{norm,conv},
    features.{conv0,norm0,norm5}, classifier) → models.cnn.densenet.DenseNet."""
    im = _NamedImport(state_dict)
    im.conv("features.conv0", ("conv0",), in_channels)
    im.bn("features.norm0", ("norm0",))
    blocks: Dict[int, set] = {}
    for k in state_dict:
        m = re.match(r"features\.denseblock(\d+)\.denselayer(\d+)\.", k)
        if m:
            blocks.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
    for b in sorted(blocks):
        for layer in sorted(blocks[b]):
            src = f"features.denseblock{b}.denselayer{layer}"
            dst = (f"denseblock{b}_layer{layer}",)
            im.bn(f"{src}.norm1", dst + ("BatchNorm_0",))
            im.conv(f"{src}.conv1", dst + ("Conv_0",))
            im.bn(f"{src}.norm2", dst + ("BatchNorm_1",))
            im.conv(f"{src}.conv2", dst + ("Conv_1",))
        if f"features.transition{b}.norm.weight" in state_dict:
            dst = (f"transition{b}",)
            im.bn(f"features.transition{b}.norm", dst + ("BatchNorm_0",))
            im.conv(f"features.transition{b}.conv", dst + ("Conv_0",))
    im.bn("features.norm5", ("norm_final",))  # torchvision: always 'norm5'
    im.dense("classifier", ("classifier",), num_classes)
    return im.out()


def import_efficientnet(state_dict: Mapping[str, Any], in_channels: int = 1,
                        num_classes: Optional[int] = 2) -> Dict[str, Any]:
    """timm EfficientNet naming (conv_stem/bn1, blocks.S.I.{conv_pw,bn1,
    conv_dw,bn2,se.conv_reduce,se.conv_expand,conv_pwl,bn3} for
    InvertedResidual / {conv_dw,bn1,se.*,conv_pw,bn2} for
    DepthwiseSeparableConv, conv_head/bn2, classifier) →
    models.cnn.efficientnet.EfficientNet."""
    im = _NamedImport(state_dict)
    im.conv("conv_stem", ("stem_conv",), in_channels)
    im.bn("bn1", ("stem_bn",))
    blocks: Dict[int, set] = {}
    for k in state_dict:
        m = re.match(r"blocks\.(\d+)\.(\d+)\.", k)
        if m:
            blocks.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
    for s in sorted(blocks):
        for i in sorted(blocks[s]):
            src = f"blocks.{s}.{i}"
            dst = (f"mbconv{s}_{i}",)
            se = dst + ("SqueezeExcite_0",)
            if f"{src}.conv_pwl.weight" in state_dict:  # InvertedResidual
                im.conv(f"{src}.conv_pw", dst + ("Conv_0",))
                im.bn(f"{src}.bn1", dst + ("BatchNorm_0",))
                im.conv(f"{src}.conv_dw", dst + ("Conv_1",))
                im.bn(f"{src}.bn2", dst + ("BatchNorm_1",))
                im.conv(f"{src}.se.conv_reduce", se + ("Conv_0",), bias=True)
                im.conv(f"{src}.se.conv_expand", se + ("Conv_1",), bias=True)
                im.conv(f"{src}.conv_pwl", dst + ("Conv_2",))
                im.bn(f"{src}.bn3", dst + ("BatchNorm_2",))
            else:  # DepthwiseSeparableConv (stage 0, expand_ratio 1)
                im.conv(f"{src}.conv_dw", dst + ("Conv_0",))
                im.bn(f"{src}.bn1", dst + ("BatchNorm_0",))
                im.conv(f"{src}.se.conv_reduce", se + ("Conv_0",), bias=True)
                im.conv(f"{src}.se.conv_expand", se + ("Conv_1",), bias=True)
                im.conv(f"{src}.conv_pw", dst + ("Conv_1",))
                im.bn(f"{src}.bn2", dst + ("BatchNorm_1",))
    im.conv("conv_head", ("head_conv",))
    im.bn("bn2", ("head_bn",))
    im.dense("classifier", ("classifier",), num_classes)
    return im.out()


# torchvision/timm inception_v3 module → our flax module (top level)
_V3_TOP = {
    "Conv2d_1a_3x3": "ConvBN_0", "Conv2d_2a_3x3": "ConvBN_1",
    "Conv2d_2b_3x3": "ConvBN_2", "Conv2d_3b_1x1": "ConvBN_3",
    "Conv2d_4a_3x3": "ConvBN_4",
    "Mixed_5b": "InceptionA_0", "Mixed_5c": "InceptionA_1",
    "Mixed_5d": "InceptionA_2", "Mixed_6a": "InceptionB_0",
    "Mixed_6b": "InceptionC_0", "Mixed_6c": "InceptionC_1",
    "Mixed_6d": "InceptionC_2", "Mixed_6e": "InceptionC_3",
    "Mixed_7a": "InceptionD_0", "Mixed_7b": "InceptionE_0",
    "Mixed_7c": "InceptionE_1",
}
# per-block branch → ConvBN index (our blocks create ConvBN in branch order)
_V3_BRANCH = {
    "InceptionA": {"branch1x1": 0, "branch5x5_1": 1, "branch5x5_2": 2,
                   "branch3x3dbl_1": 3, "branch3x3dbl_2": 4,
                   "branch3x3dbl_3": 5, "branch_pool": 6},
    "InceptionB": {"branch3x3": 0, "branch3x3dbl_1": 1, "branch3x3dbl_2": 2,
                   "branch3x3dbl_3": 3},
    "InceptionC": {"branch1x1": 0, "branch7x7_1": 1, "branch7x7_2": 2,
                   "branch7x7_3": 3, "branch7x7dbl_1": 4, "branch7x7dbl_2": 5,
                   "branch7x7dbl_3": 6, "branch7x7dbl_4": 7,
                   "branch7x7dbl_5": 8, "branch_pool": 9},
    "InceptionD": {"branch3x3_1": 0, "branch3x3_2": 1, "branch7x7x3_1": 2,
                   "branch7x7x3_2": 3, "branch7x7x3_3": 4, "branch7x7x3_4": 5},
    "InceptionE": {"branch1x1": 0, "branch3x3_1": 1, "branch3x3_2a": 2,
                   "branch3x3_2b": 3, "branch3x3dbl_1": 4, "branch3x3dbl_2": 5,
                   "branch3x3dbl_3a": 6, "branch3x3dbl_3b": 7,
                   "branch_pool": 8},
}


def import_inception_v3(state_dict: Mapping[str, Any], in_channels: int = 1,
                        num_classes: Optional[int] = 2) -> Dict[str, Any]:
    """torchvision/timm inception_v3 naming (Conv2d_*, Mixed_*, AuxLogits,
    fc) → models.cnn.inception.InceptionV3."""
    im = _NamedImport(state_dict)
    for src, dst in _V3_TOP.items():
        if dst.startswith("ConvBN"):
            im.convbn(src, (dst,),
                      in_channels if src == "Conv2d_1a_3x3" else None)
        else:
            family = dst.rsplit("_", 1)[0]
            for branch, idx in _V3_BRANCH[family].items():
                im.convbn(f"{src}.{branch}", (dst, f"ConvBN_{idx}"))
    if "AuxLogits.conv0.conv.weight" in state_dict:
        im.convbn("AuxLogits.conv0", ("aux_conv0",))
        im.convbn("AuxLogits.conv1", ("aux_conv1",))
        im.dense("AuxLogits.fc", ("aux_fc",), num_classes)
    im.dense("fc", ("fc",), num_classes)
    return im.out()


def _v4_top_map() -> list:
    """(torch src, flax dst) pairs for timm/Cadene inception_v4
    (features.0-21, BasicConv2d = .conv/.bn, Sequential branches)."""
    out = [(f"features.{i}", (f"ConvBN_{i}",)) for i in range(3)]  # stem
    out.append(("features.3.conv", ("ConvBN_3",)))  # Mixed_3a
    out += [(f"features.4.branch0.{j}", (f"ConvBN_{4 + j}",))
            for j in range(2)]  # Mixed_4a branch0
    out += [(f"features.4.branch1.{j}", (f"ConvBN_{6 + j}",))
            for j in range(4)]  # Mixed_4a branch1
    out.append(("features.5.conv", ("ConvBN_10",)))  # Mixed_5a
    for k in range(4):  # Inception_A ×4
        blk = f"features.{6 + k}"
        dst = f"InceptionV4A_{k}"
        out += [(f"{blk}.branch0", (dst, "ConvBN_0")),
                (f"{blk}.branch1.0", (dst, "ConvBN_1")),
                (f"{blk}.branch1.1", (dst, "ConvBN_2")),
                (f"{blk}.branch2.0", (dst, "ConvBN_3")),
                (f"{blk}.branch2.1", (dst, "ConvBN_4")),
                (f"{blk}.branch2.2", (dst, "ConvBN_5")),
                (f"{blk}.branch3.1", (dst, "ConvBN_6"))]
    out.append(("features.10.branch0", ("ConvBN_11",)))  # Reduction_A
    out += [(f"features.10.branch1.{j}", (f"ConvBN_{12 + j}",))
            for j in range(3)]
    for k in range(7):  # Inception_B ×7
        blk = f"features.{11 + k}"
        dst = f"InceptionV4B_{k}"
        out += [(f"{blk}.branch0", (dst, "ConvBN_0"))]
        out += [(f"{blk}.branch1.{j}", (dst, f"ConvBN_{1 + j}"))
                for j in range(3)]
        out += [(f"{blk}.branch2.{j}", (dst, f"ConvBN_{4 + j}"))
                for j in range(5)]
        out += [(f"{blk}.branch3.1", (dst, "ConvBN_9"))]
    out += [(f"features.18.branch0.{j}", (f"ConvBN_{15 + j}",))
            for j in range(2)]  # Reduction_B
    out += [(f"features.18.branch1.{j}", (f"ConvBN_{17 + j}",))
            for j in range(4)]
    for k in range(3):  # Inception_C ×3
        blk = f"features.{19 + k}"
        dst = f"InceptionV4C_{k}"
        out += [(f"{blk}.branch0", (dst, "ConvBN_0")),
                (f"{blk}.branch1_0", (dst, "ConvBN_1")),
                (f"{blk}.branch1_1a", (dst, "ConvBN_2")),
                (f"{blk}.branch1_1b", (dst, "ConvBN_3")),
                (f"{blk}.branch2_0", (dst, "ConvBN_4")),
                (f"{blk}.branch2_1", (dst, "ConvBN_5")),
                (f"{blk}.branch2_2", (dst, "ConvBN_6")),
                (f"{blk}.branch2_3a", (dst, "ConvBN_7")),
                (f"{blk}.branch2_3b", (dst, "ConvBN_8")),
                (f"{blk}.branch3.1", (dst, "ConvBN_9"))]
    return out


def import_inception_v4(state_dict: Mapping[str, Any], in_channels: int = 1,
                        num_classes: Optional[int] = 2) -> Dict[str, Any]:
    """timm/Cadene inception_v4 naming (features.0-21 Sequential,
    last_linear) → models.cnn.inception.InceptionV4."""
    im = _NamedImport(state_dict)
    for src, dst in _v4_top_map():
        im.convbn(src, dst, in_channels if src == "features.0" else None)
    head = "last_linear" if "last_linear.weight" in state_dict else "fc"
    im.dense(head, ("fc",), num_classes)
    return im.out()


# ---------------------------------------------------------------------------
# Generic order-based CNN importer (DenseNet / EfficientNet / Inception).
#
# Both torch's state_dict and a flax @nn.compact param tree preserve module
# CREATION order, and these architectures build layers in forward order in
# both frameworks — so conv/bn/linear slots align 1:1 as typed streams. This
# replaces three hand-written per-family mappings and fails loudly on any
# type or shape misalignment. (Reference source models are plain timm
# wrappers: src/models/cnn/{densenet,efficientnet,inception}.py.)
# The port's tree (from_jax.to_jax_variables) comes in named_parameters()
# order: each module registers its children in the order the JAX module
# creates them, so the two slot lists are equal
# (tests/test_torch_import_torch.py holds them so for each CNN family).
# ---------------------------------------------------------------------------

def _get(tree: Dict, path: Tuple[str, ...]):
    node = tree
    for p in path:
        node = node[p]
    return node


def _flax_slots(params: Dict, batch_stats: Dict) -> list:
    """Typed (kind, path) slots in creation order."""
    out = []

    def walk(node, stats, path):
        if not isinstance(node, dict):
            return
        keys = list(node.keys())
        if "kernel" in keys and hasattr(node["kernel"], "ndim"):
            nd = node["kernel"].ndim
            if nd == 4:
                out.append(("conv", path, "bias" in keys))
                return
            if nd == 2:
                out.append(("dense", path, "bias" in keys))
                return
        if set(keys) >= {"scale", "bias"} and isinstance(stats, dict) \
                and "mean" in stats:
            out.append(("bn", path))
            return
        if set(keys) == {"scale", "bias"}:
            out.append(("ln", path))
            return
        for k in keys:
            walk(node[k], stats.get(k) if isinstance(stats, dict) else None,
                 path + (k,))

    walk(params, batch_stats or {}, ())
    return out


def _torch_slots(state_dict: Mapping[str, Any]) -> list:
    """Typed (kind, arrays) slots in state_dict order."""
    items = [(k, _np(v)) for k, v in state_dict.items()
             if not k.endswith("num_batches_tracked")
             and "relative_position_index" not in k]
    out = []
    i = 0
    while i < len(items):
        k, v = items[i]
        if v.ndim == 4:
            bias = None
            if i + 1 < len(items) and items[i + 1][0].endswith(".bias") \
                    and items[i + 1][1].ndim == 1 \
                    and items[i + 1][1].shape[0] == v.shape[0]:
                bias = items[i + 1][1]
                i += 1
            out.append(("conv", v, bias))
        elif v.ndim == 2 and k.endswith(".weight"):
            bias = None
            if i + 1 < len(items) and items[i + 1][0].endswith(".bias"):
                bias = items[i + 1][1]
                i += 1
            out.append(("dense", v, bias))
        elif v.ndim == 1 and k.endswith(".weight"):
            rest = [items[i + j][0].rsplit(".", 1)[-1]
                    for j in range(1, 4) if i + j < len(items)]
            if rest[:3] == ["bias", "running_mean", "running_var"]:
                out.append(("bn", (v, items[i + 1][1], items[i + 2][1],
                                   items[i + 3][1])))
                i += 3
            elif rest[:1] == ["bias"]:
                out.append(("ln", (v, items[i + 1][1])))
                i += 1
            else:
                raise ValueError(f"unrecognised 1-D weight at '{k}'")
        else:
            raise ValueError(f"unrecognised tensor '{k}' shape {v.shape}")
        i += 1
    return out


def import_cnn_by_order(state_dict: Mapping[str, Any], variables: Dict[str, Any],
                        in_channels: Optional[int] = 1,
                        num_classes: Optional[int] = 2) -> Dict[str, Any]:
    """Align torch tensors to a freshly-initialised flax tree by creation
    order. Classifier heads whose out-dim mismatches num_classes are skipped
    (fresh head, like the reference's strict=False warm starts)."""
    params = copy.deepcopy(_plain(variables["params"]))
    stats = copy.deepcopy(_plain(variables.get("batch_stats") or {}))
    slots = _flax_slots(params, stats)
    stream = _torch_slots(state_dict)
    if len(slots) != len(stream):
        raise ValueError(f"layer-count mismatch: flax has {len(slots)} typed "
                         f"slots, torch checkpoint has {len(stream)}")
    first_conv = True
    for slot, item in zip(slots, stream):
        if slot[0] != item[0]:
            raise ValueError(f"slot type mismatch at {slot[1]}: flax {slot[0]} "
                             f"vs torch {item[0]}")
        kind, path = slot[0], slot[1]
        if kind == "conv":
            w = conv_to_flax(item[1], in_channels if first_conv else None)
            first_conv = False
            tgt = _get(params, path)
            if tuple(tgt["kernel"].shape) != w.shape:
                raise ValueError(f"conv shape mismatch at {path}: "
                                 f"{w.shape} vs {tuple(tgt['kernel'].shape)}")
            tgt["kernel"] = w
            if item[2] is not None and slot[2]:
                tgt["bias"] = item[2]
        elif kind == "bn":
            w, b, mean, var = item[1]
            tgt = _get(params, path)
            tgt["scale"], tgt["bias"] = w, b
            st = _get(stats, path)
            st["mean"], st["var"] = mean, var
        elif kind == "ln":
            w, b = item[1]
            tgt = _get(params, path)
            tgt["scale"], tgt["bias"] = w, b
        elif kind == "dense":
            w, b = item[1], item[2]
            tgt = _get(params, path)
            if tuple(tgt["kernel"].shape) != w.T.shape:
                continue  # mismatched classifier head → keep fresh init
            tgt["kernel"] = linear_to_flax(w)
            if b is not None and slot[2]:
                tgt["bias"] = b
    out: Dict[str, Any] = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def _plain(tree) -> Dict:
    """Mappings → nested plain dicts (leaves untouched)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return tree


def merge_imported(variables: Dict[str, Any],
                   imported: Dict[str, Any]) -> Dict[str, Any]:
    """Overlay imported leaves onto freshly-initialised variables (leaves
    missing from the import — e.g. a fresh head, quality-scoring convs — keep
    their init). Shapes must match where both exist. A leaf the fresh tree
    lacks is kept as imported, as in the JAX package, whose apply ignores
    it; `maybe_load_pretrained` drops it before loading (`_fitted`)."""

    def overlay(dst, src):
        out = dict(dst)
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(out.get(k), (dict,)):
                out[k] = overlay(out[k], v)
            else:
                if k in out and hasattr(out[k], "shape") and \
                        tuple(out[k].shape) != tuple(np.shape(v)):
                    raise ValueError(
                        f"shape mismatch importing '{k}': "
                        f"{np.shape(v)} vs {tuple(out[k].shape)}")
                out[k] = np.asarray(v)
        return out

    merged = dict(variables)
    for coll in imported:
        merged[coll] = overlay(_plain(variables.get(coll, {})), imported[coll])
    return merged


def _fitted(merged: Mapping[str, Any], fresh: Mapping[str, Any],
            path: str = "") -> Tuple[Dict[str, Any], List[str]]:
    """(`merged` cut to the leaves of `fresh`, the paths cut away): the
    JAX package's apply reads only the variables its modules declare and
    ignores the rest, such as a reference-native Swin's contrast scales or
    uncertainty head on a model built without them; the port's strict
    loader takes only what the model has."""
    kept: Dict[str, Any] = {}
    dropped: List[str] = []
    for k, v in merged.items():
        where = f"{path}/{k}" if path else str(k)
        if k not in fresh:
            dropped.append(where)
        elif hasattr(fresh[k], "items"):
            if hasattr(v, "items"):
                kept[k], lost = _fitted(v, fresh[k], where)
                dropped += lost
            else:
                dropped.append(where)
        else:
            kept[k] = v
    return kept, dropped


def import_for_model(name: str, state_dict: Mapping[str, Any],
                     variables: Dict[str, Any], in_channels: int = 1,
                     num_classes: Optional[int] = 2,
                     target_tokens: Optional[int] = None) -> Dict[str, Any]:
    """Family dispatch: torch/timm state_dict → JAX collections for the
    registered model `name`."""
    if name.startswith("resnet"):
        return import_resnet(state_dict, in_channels, num_classes)
    if name.startswith("swin"):
        # the reference's own from-scratch checkpoints carry its native
        # naming (bare-conv patch_embed, patch_norm_layer, Sequential mlp)
        if "patch_norm_layer.weight" in state_dict \
                or "patch_embed.weight" in state_dict:
            return import_swin_reference(state_dict, in_channels, num_classes)
        return import_swin(state_dict, in_channels, num_classes)
    if name.startswith("deit"):
        return import_vit(state_dict, in_channels, num_classes,
                          target_tokens=target_tokens, distillation=True)
    if name.startswith("vit"):
        return import_vit(state_dict, in_channels, num_classes,
                          target_tokens=target_tokens)
    # DenseNet/EfficientNet/Inception: name-based maps when the checkpoint
    # carries genuine timm/torchvision naming (robust to registration-order
    # differences); order-based alignment as the fallback for rewritten or
    # exotic checkpoints.
    if name.startswith("densenet"):
        if "features.conv0.weight" in state_dict:
            return import_densenet(state_dict, in_channels, num_classes)
        return import_cnn_by_order(state_dict, variables, in_channels,
                                   num_classes)
    if name.startswith("efficientnet"):
        if "conv_stem.weight" in state_dict:
            return import_efficientnet(state_dict, in_channels, num_classes)
        return import_cnn_by_order(state_dict, variables, in_channels,
                                   num_classes)
    if name.startswith("inception"):
        if "Conv2d_1a_3x3.conv.weight" in state_dict:
            return import_inception_v3(state_dict, in_channels, num_classes)
        if "features.0.conv.weight" in state_dict:
            return import_inception_v4(state_dict, in_channels, num_classes)
        return import_cnn_by_order(state_dict, variables, in_channels,
                                   num_classes)
    raise ValueError(f"no importer for model family '{name}'")


def find_pretrained_file(name: str, pretrained_path: Optional[str] = None,
                         search_dirs: Optional[List[str]] = None) -> Optional[str]:
    """A local torch checkpoint for model `name`: `pretrained_path` when it
    exists (and None when it does not), else the first
    `{name}.{pth,pt,ckpt}` under `search_dirs`, $THYROID_PRETRAINED_DIR,
    then ./weights. Nothing is downloaded."""
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


def maybe_load_pretrained(config: Any, model: torch.nn.Module) -> torch.nn.Module:
    """Honor `pretrained: true` / `pretrained_path` from a model config on
    `model`, a freshly initialised module of that config on the CPU: its
    tensors are overwritten in place by the torch checkpoint's
    (find_pretrained_file), imported over the model's own JAX tree and
    loaded by load_jax_variables; the leaves the checkpoint does not cover
    keep their init. Without a config key it returns the model untouched;
    when no local file exists it warns and returns it untouched."""
    path = cfg_get(config, "pretrained_path", None)
    if not path and not cfg_get(config, "pretrained", False):
        return model
    name = str(cfg_get(config, "name", ""))
    found = find_pretrained_file(name, path)
    if found is None:
        logger.warning(
            "pretrained requested for %s but no local checkpoint found "
            "(set pretrained_path or $THYROID_PRETRAINED_DIR; this "
            "environment cannot download timm weights) — training from "
            "scratch", name)
        return model
    state_dict = load_torch_checkpoint(found)
    variables = to_jax_variables(model)
    pe = variables["params"].get("pos_embed")
    imported = import_for_model(
        name, state_dict, variables,
        in_channels=int(cfg_get(config, "in_channels", 1)),
        num_classes=int(cfg_get(config, "num_classes", 2)),
        target_tokens=pe.shape[1] if pe is not None else None)
    merged, dropped = _fitted(merge_imported(variables, imported), variables)
    if dropped:
        logger.debug("%s: leaves of %s that the model has no place for, "
                     "dropped: %s", name, found, ", ".join(dropped))
    load_jax_variables(model, merged)
    logger.info("warm-started %s from %s", name, found)
    return model


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Load a .pth/.ckpt file; unwraps Lightning 'state_dict' envelopes and
    strips the reference's 'model.model.'/'model.' prefixes (reference:
    scripts/run_ensemble_kfold_evaluation.py:98-103)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    out = {}
    for k, v in sd.items():
        for prefix in ("model.model.", "model."):
            if k.startswith(prefix):
                k = k[len(prefix):]
                break
        out[k] = v
    return out
