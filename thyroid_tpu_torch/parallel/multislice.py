"""Multi-slice scale-out of the k-fold x model sweep (counterpart of
thyroid_tpu/parallel/multislice.py).

A ('slice', 'data') mesh: 'data' joins the devices of one slice (the
gradient sums ride it), 'slice' the independent slices, across which no
training collective runs. Two modes, as in JAX:

1. process level: each slice runs its own k-fold experiment process
   (`kfold.num_slices`, `kfold.slice_index`) on the folds
   `partition_folds` gives it (round robin), and `merge_slice_summaries`
   combines the per-slice summary files into the canonical aggregate;
2. stacked: one program over the whole mesh, the folds in contiguous
   blocks over 'slice' (6 folds on 2 slices: 0-2 and 3-5, JAX's
   `P(slice)` blocking), each fold data-parallel over its slice's 'data'
   line (training/stacked.py; `stacked_step` lifts one step). Where JAX
   vmaps the fold axis, the port runs its block's folds one after another
   (torch.func.vmap batches neither the hand-written kernels nor
   BatchNorm's in-place statistics).
"""
from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, batch_sharding, create_mesh, init_process_group


def multislice_mesh(num_slices: int, data_per_slice: Optional[int] = None,
                    devices: Optional[Sequence[Any]] = None,
                    slice_axis: str = "slice", data_axis: str = "data",
                    backend: Optional[str] = None) -> Mesh:
    """(slice, data) mesh over the process world (or over `devices`):
    row = one slice, its ranks contiguous."""
    if devices is not None:
        n_all = len(devices)
    else:
        init_process_group(backend)
        n_all = dist.get_world_size()
    if data_per_slice is None:
        if n_all % num_slices:
            raise ValueError(
                f"{n_all} devices do not divide into {num_slices} slices")
        data_per_slice = n_all // num_slices
    shape = {slice_axis: int(num_slices), data_axis: int(data_per_slice)}
    if devices is not None:
        return create_mesh(shape, devices=devices)
    return create_mesh(shape, backend=backend)


def fold_block(num_folds: int, num_slices: int, slice_index: int) -> List[int]:
    """The 0-based folds of slice `slice_index` when folds go to slices
    in contiguous blocks of ceil(k / slices) (JAX's P(slice) blocking)."""
    size = math.ceil(num_folds / num_slices)
    return list(range(slice_index * size, min(num_folds, (slice_index + 1) * size)))


def partition_folds(num_folds: int, num_slices: int, slice_index: int) -> List[int]:
    """Round-robin partition of 1-based fold ids across slices.

    Deterministic and balanced: fold f goes to slice (f-1) % num_slices."""
    if not 0 <= slice_index < num_slices:
        raise ValueError(f"slice_index {slice_index} not in [0, {num_slices})")
    return [f for f in range(1, num_folds + 1)
            if (f - 1) % num_slices == slice_index]


def merge_slice_summaries(
    summaries: Sequence[Union[str, Path, Dict[str, Any]]],
) -> Dict[str, Any]:
    """Combine per-slice k-fold summaries into one canonical aggregate.

    Each input is a summary dict (or a path to one) as written by
    KFoldExperiment.log_results; the raw_fold_results lists are
    concatenated in fold order and the avg_/std_ metrics recomputed over
    all successful folds, as a single-process run would have produced
    them; with no successful fold, the k-fold experiment's all-failed
    status."""
    loaded: List[Dict[str, Any]] = []
    for s in summaries:
        if isinstance(s, (str, Path)):
            with open(s) as f:
                loaded.append(json.load(f))
        else:
            loaded.append(dict(s))
    if not loaded:
        raise ValueError("no summaries to merge")
    folds: List[Dict[str, Any]] = []
    for s in loaded:
        folds.extend(s.get("raw_fold_results", []))
    folds.sort(key=lambda r: r.get("fold", 0))
    valid = [r for r in folds if "error" not in r]
    merged: Dict[str, Any] = {}
    if valid:
        for key in valid[0]:
            values = [r[key] for r in valid
                      if isinstance(r.get(key), (int, float))
                      and np.isfinite(r.get(key))]
            if values:
                merged[f"avg_{key}"] = float(np.mean(values))
                merged[f"std_{key}"] = float(np.std(values))
    if not valid:
        merged["status"] = "All folds failed or no metrics"
    merged["num_successful_folds"] = len(valid)
    # each slice reports the whole sweep's total_folds: the max, not the sum
    merged["total_folds"] = max(
        [int(s.get("total_folds", 0)) for s in loaded] + [len(folds)])
    merged["raw_fold_results"] = folds
    merged["num_slices_merged"] = len(loaded)
    for key in ("experiment_name", "model_name", "family",
                "student_model_name", "teacher_model_name"):
        if key in loaded[0]:
            merged[key] = loaded[0][key]
    return merged


# ----------------------------------------------------------------------
# stacked mode


def stack_pytrees(trees: Sequence[Mapping[str, Any]]) -> Dict[str, np.ndarray]:
    """Stack per-fold {name: tensor} maps along a new leading fold axis
    (host arrays, as JAX's)."""
    names = list(trees[0])
    return {n: np.stack([np.asarray(torch.as_tensor(t[n]).detach().cpu())
                         for t in trees]) for n in names}


def unstack_pytree(tree: Mapping[str, Any], n: int) -> List[Dict[str, np.ndarray]]:
    """Split a stacked {name: array} map back into n per-fold maps."""
    leaves = {k: np.asarray(torch.as_tensor(v).detach().cpu())
              for k, v in tree.items()}
    return [{k: v[i] for k, v in leaves.items()} for i in range(n)]


def stacked_step(step_fn: Callable, mesh: Optional[Mesh] = None,
                 slice_axis: str = "slice", data_axis: str = "data",
                 donate: bool = True) -> Callable:
    """Lift a per-fold step over the folds: the returned function takes a
    fold-stacked state ({name: (k, ...)}) and batch ({name: (k, B,
    ...)}), and runs step_fn(state_f, batch_f) → (state_f, metrics_f) for
    the folds of this process's slice (all of them without a slice axis),
    in block order, on its rows of each batch along `data_axis` (a
    process mesh); the rest of the state comes back as it went in. →
    (state, {name: (k_block, ...)} metrics of the block). `donate`, JAX's
    buffer donation, has no counterpart: the state is written in place."""
    del donate

    def run(state: Dict[str, Any], batch: Dict[str, Any]):
        k = len(next(iter(state.values())))
        folds = list(range(k))
        process = mesh is not None and mesh.is_process_mesh
        if process and slice_axis in mesh.shape:
            folds = fold_block(k, mesh.shape[slice_axis], mesh.index(slice_axis))
        rows = None
        if process and data_axis in mesh.shape:
            rows = batch_sharding(mesh, data_axis)
        metrics: List[Dict[str, Any]] = []
        for f in folds:
            st = {n: v[f] for n, v in state.items()}
            b = {n: v[f] if rows is None else rows.take(torch.as_tensor(v[f]))
                 for n, v in batch.items()}
            new, m = step_fn(st, b)
            for n, v in new.items():
                state[n][f] = v
            metrics.append(m)
        stacked = {n: torch.stack([torch.as_tensor(m[n]) for m in metrics])
                   for n in metrics[0]} if metrics else {}
        return state, stacked

    return run
