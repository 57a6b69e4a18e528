"""Carry JAX parameters into the port.

`params` is the JAX `variables["params"]` tree as nested dicts of numpy
arrays. The port's modules name their parameters after the JAX leaves, so
a leaf at path a/b/c fills the port parameter "a.b.c". The one layout
change is the patch-embed convolution: flax's HWIO kernel becomes
PyTorch's OIHW weight. Dense kernels stay (in, out), the layout the fused
kernels take.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_CONV_KERNELS = {"patch_embed.kernel": "patch_embed.weight"}


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path + "."))
        else:
            flat[path] = np.asarray(val)
    return flat


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """Fill every parameter of `model` from the JAX tree `params`, in
    place. Strict: raises on a leaf the model has no place for, on a model
    parameter no leaf fills, and on any shape mismatch."""
    state = dict(model.named_parameters())
    filled = set()
    for path, arr in _flatten(params).items():
        name = _CONV_KERNELS.get(path, path)
        if name not in state:
            raise KeyError(f"JAX leaf {path} has no parameter in the port model")
        if name != path:
            arr = arr.transpose(3, 2, 0, 1)          # HWIO → OIHW
        p = state[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{path}: JAX shape {arr.shape} != port "
                             f"{tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.ascontiguousarray(arr, np.float32)))
        filled.add(name)
    missing = sorted(set(state) - filled)
    if missing:
        raise KeyError(f"port parameters with no JAX leaf: {missing}")


def jax_tree(named: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """{port parameter name: tensor} → the JAX parameter tree (nested dicts)
    of float32 CPU tensors, conv weights OIHW → HWIO. `load_jax_params`
    takes it back."""
    inverse = {v: k for k, v in _CONV_KERNELS.items()}
    tree: Dict[str, Any] = {}
    for name, p in named.items():
        t = p.detach().float().cpu()
        if name in inverse:
            t = t.permute(2, 3, 1, 0).contiguous()    # OIHW → HWIO
            name = inverse[name]
        node = tree
        *parents, leaf = name.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def to_jax_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of load_jax_params: the model's parameters as a JAX
    parameter tree of float32 numpy arrays."""

    def numpy(tree):
        return {k: numpy(v) if isinstance(v, dict) else v.numpy()
                for k, v in tree.items()}

    return numpy(jax_tree(dict(model.named_parameters())))
