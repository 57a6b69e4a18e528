"""Carry JAX variables into the port, and back.

`variables` is a JAX variable tree as nested dicts of arrays:
{"params": …} and, for a model with BatchNorm, {"batch_stats": …}. The
port's modules name their parameters after the JAX leaves and their
persistent buffers after the `batch_stats` leaves, so a leaf at path a/b/c
fills the port tensor "a.b.c". A module whose tensors are laid out or named
otherwise declares it in a class attribute `jax_layout`, {JAX leaf: (port
tensor, axes of the JAX array in the port's order)}: the convolutions'
HWIO kernels are OIHW in the port (`layers.ConvParams`, Swin's
`PatchEmbed`). Dense kernels stay (in, out), the layout the fused kernels
take.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

# port tensor name → (JAX collection, JAX path "a.b.c", axes or None)
Layout = Dict[str, Tuple[str, str, Optional[Tuple[int, ...]]]]


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, Mapping):
            flat.update(_flatten(val, path + "."))
        else:
            flat[path] = np.asarray(val)
    return flat


def batch_stats(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """{name: buffer} of the model's persistent buffers: the JAX
    `batch_stats` collection (BatchNorm's running mean and var)."""
    keep = set(model.state_dict(keep_vars=True))
    return {n: b for n, b in model.named_buffers() if n in keep}


def jax_layout(model: torch.nn.Module) -> Layout:
    """{port name: (collection, JAX path, axes)} of every parameter
    ("params") and persistent buffer ("batch_stats") of `model`."""
    renamed = {}
    for prefix, mod in model.named_modules():
        for leaf, (name, axes) in getattr(mod, "jax_layout", {}).items():
            dot = f"{prefix}." if prefix else ""
            renamed[dot + name] = (dot + leaf, axes)
    layout: Layout = {}
    for collection, named in (("params", dict(model.named_parameters())),
                              ("batch_stats", batch_stats(model))):
        for name in named:
            path, axes = renamed.get(name, (name, None))
            layout[name] = (collection, path, axes)
    return layout


def load_jax_variables(model: torch.nn.Module,
                       variables: Mapping[str, Any]) -> None:
    """Fill every parameter and persistent buffer of `model` from the JAX
    tree `variables` ({"params": …[, "batch_stats": …]}), in place. Strict:
    raises on a leaf the model has no place for, on a model tensor no leaf
    fills, on a collection other than these two, and on any shape
    mismatch."""
    extra = sorted(set(variables) - {"params", "batch_stats"})
    if extra:
        raise KeyError(f"JAX collections the port model has no place for: {extra}")
    tensors = {**dict(model.named_parameters()), **batch_stats(model)}
    by_path = {(col, path): (name, axes)
               for name, (col, path, axes) in jax_layout(model).items()}
    filled = set()
    for collection in ("params", "batch_stats"):
        for path, arr in _flatten(variables.get(collection) or {}).items():
            if (collection, path) not in by_path:
                raise KeyError(f"JAX leaf {collection}/{path} has no tensor "
                               "in the port model")
            name, axes = by_path[(collection, path)]
            if axes is not None:
                arr = arr.transpose(axes)
            t = tensors[name]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{collection}/{path}: JAX shape {arr.shape} "
                                 f"!= port {tuple(t.shape)}")
            with torch.no_grad():
                t.copy_(torch.from_numpy(np.ascontiguousarray(arr, np.float32)))
            filled.add(name)
    missing = sorted(set(tensors) - filled)
    if missing:
        raise KeyError(f"port tensors with no JAX leaf: {missing}")


def load_jax_params(model: torch.nn.Module, params: Mapping[str, Any]) -> None:
    """load_jax_variables with {"params": params} only, for a model without
    BatchNorm statistics (a model with them raises: use
    load_jax_variables)."""
    load_jax_variables(model, {"params": params})


def jax_tree(named: Mapping[str, torch.Tensor], layout: Layout) -> Dict[str, Any]:
    """{port name: tensor} of one collection → its JAX tree (nested dicts)
    of float32 CPU tensors, in the JAX layouts that `layout`
    (jax_layout(model)) gives. load_jax_variables takes it back."""
    tree: Dict[str, Any] = {}
    for name, p in named.items():
        _, path, axes = layout[name]
        t = p.detach().float().cpu()
        if axes is not None:
            t = t.permute(*np.argsort(axes).tolist()).contiguous()
        node = tree
        *parents, leaf = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = t
    return tree


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else v.numpy()
            for k, v in tree.items()}


def to_jax_variables(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of load_jax_variables: {"params": …} and, when the model
    has BatchNorm statistics, {"batch_stats": …}, float32 numpy arrays."""
    layout = jax_layout(model)
    out = {"params": _numpy(jax_tree(dict(model.named_parameters()), layout))}
    stats = batch_stats(model)
    if stats:
        out["batch_stats"] = _numpy(jax_tree(stats, layout))
    return out


def to_jax_params(model: torch.nn.Module) -> Dict[str, Any]:
    """The inverse of load_jax_params: the model's parameters as a JAX
    parameter tree of float32 numpy arrays."""
    return to_jax_variables(model)["params"]
