"""Device meshes and batch sharding (counterpart of
thyroid_tpu/parallel/mesh.py).

JAX runs one controller over a `jax.sharding.Mesh` and lets XLA insert the
collectives. The port keeps JAX's names and axis names ("data", "model",
"slice") and has two kinds of mesh:

- a **process mesh** (`create_mesh(shape)`): one process a device, as
  PyTorch trains. The processes are torch.distributed ranks, laid out in
  the mesh's shape in rank order; every line of ranks along each axis gets
  its own process group (a gradient sums over "data" alone, FSDP gathers
  over "model" alone), and so does the whole mesh and, beside a "slice"
  axis, each slice's other axes (a fold of the stacked trainer). The group
  is initialised from torchrun's environment, else (a world of one) from
  an in-memory store; the shape's size must equal the world's. Under
  torchrun the process joins the group at its first collective question
  (`is_lead_process`, `barrier`, `lead_value`, `create_mesh`), so files
  shared by the ranks are written by rank 0 alone from the start;
- a **device mesh** (`create_mesh(shape, devices=[...])`): one process
  over an explicit device list, as JAX's single controller holds it; the
  serving engine keeps one model replica a device and splits each bucket
  over the list (serving/engine.py). A device may be listed more than
  once.

Sharding objects are `RowSharding`s: which contiguous rows of a global
batch each coordinate of an axis holds (JAX's `P(data_axis)`), or all of
them (`P()`).
"""
from __future__ import annotations

import itertools
import math
import os
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops.platform import resolve_device

# torchrun's environment, which `create_mesh` initialises the group from
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


class Mesh:
    """Named axes over processes (`ranks`, an int array in the mesh's
    shape) or over devices (`devices`, an object array of torch.device).
    `shape` maps axis name → size, in order, as JAX's `mesh.shape`."""

    def __init__(self, shape: Mapping[str, int], ranks: Optional[np.ndarray] = None,
                 devices: Optional[np.ndarray] = None):
        self.shape: Dict[str, int] = {str(k): int(v) for k, v in shape.items()}
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.ranks = ranks
        self.devices = devices
        self._groups: Dict[Tuple[str, ...], Any] = {}
        self.coords: Dict[str, int] = {}
        if ranks is not None:
            where = np.argwhere(ranks == dist.get_rank())
            if len(where) != 1:
                raise ValueError(f"rank {dist.get_rank()} is not in the mesh "
                                 f"{ranks.tolist()}")
            self.coords = dict(zip(self.axis_names, (int(i) for i in where[0])))

    @property
    def is_process_mesh(self) -> bool:
        return self.ranks is not None

    def index(self, axis: str) -> int:
        """This process's coordinate on `axis` (a process mesh)."""
        return self.coords[axis]

    def group(self, axes: Iterable[str]) -> Any:
        """The process group of this rank's line along `axes` (all of them
        for a group over the whole mesh)."""
        key = tuple(a for a in self.axis_names if a in set(axes))
        if key not in self._groups:
            raise ValueError(f"mesh {self.shape} has no group over {key}: "
                             f"only over {sorted(self._groups)}")
        return self._groups[key]

    def is_lead(self, axes: Optional[Iterable[str]] = None) -> bool:
        """Whether this process is the first of its line along `axes` (the
        whole mesh by default): the one that writes files and logs."""
        axes = self.axis_names if axes is None else tuple(axes)
        return all(self.coords[a] == 0 for a in axes)

    def submesh(self, axes: Sequence[str]) -> "Mesh":
        """The mesh along `axes` through this process, the other axes
        fixed at its coordinates; its groups are this mesh's."""
        keep = tuple(a for a in self.axis_names if a in set(axes))
        index = tuple(slice(None) if a in keep else self.coords[a]
                      for a in self.axis_names)
        sub = Mesh({a: self.shape[a] for a in keep}, ranks=self.ranks[index])
        for key in _axis_sets(keep):
            sub._groups[key] = self.group(key)
        return sub

    def __repr__(self) -> str:
        kind = "processes" if self.is_process_mesh else "devices"
        return f"Mesh({self.shape}, {kind})"


def _axis_sets(axes: Sequence[str]) -> List[Tuple[str, ...]]:
    """The axis sets that get process groups: each axis, the whole mesh,
    and the axes beside "slice" (a stacked fold's mesh)."""
    sets = [(a,) for a in axes] + [tuple(axes)]
    if "slice" in axes:
        sets.append(tuple(a for a in axes if a != "slice"))
    return [s for i, s in enumerate(sets) if s and s not in sets[:i]]


def default_backend(device: Any = None) -> str:
    """"nccl" for a CUDA device, "gloo" for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def join_from_env(device: Any = None) -> None:
    """Join torch.distributed from torchrun's environment when it is set
    and the process has not joined yet (`init_process_group`, over the
    backend of `device`)."""
    if not dist.is_initialized() and all(k in os.environ for k in TORCHRUN_ENV):
        init_process_group(default_backend(device))


def init_process_group(backend: Optional[str] = None) -> None:
    """Join torch.distributed: from torchrun's environment where it is set,
    else as a world of one (an in-memory store). Under NCCL the process's
    card (cuda:LOCAL_RANK) is made current first."""
    if dist.is_initialized():
        return
    backend = backend or default_backend()
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if all(k in os.environ for k in TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


_MESHES: Dict[Tuple, Mesh] = {}


def create_mesh(mesh_shape: Optional[Mapping[str, int]] = None,
                devices: Optional[Sequence[Any]] = None,
                backend: Optional[str] = None) -> Mesh:
    """Build a Mesh. With `devices`, a device mesh over the first
    prod(shape) of them (default: all on one `data` axis); without, a
    process mesh over the torch.distributed world (default: the world on
    one `data` axis), the group initialised first when it is not
    (`init_process_group`, with `backend`). A process mesh of one shape is
    built once per world; its groups are created collectively, so every
    rank must call create_mesh with the same shape."""
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        shape = dict(mesh_shape) if mesh_shape else {"data": len(devs)}
        n = math.prod(shape.values())
        if n > len(devs):
            raise ValueError(f"mesh {shape} needs {n} devices, have {len(devs)}")
        arr = np.empty(n, dtype=object)
        arr[:] = devs[:n]
        return Mesh(shape, devices=arr.reshape(tuple(shape.values())))
    init_process_group(backend)
    world = dist.get_world_size()
    shape = dict(mesh_shape) if mesh_shape else {"data": world}
    n = math.prod(shape.values())
    if n != world:
        raise ValueError(
            f"mesh {shape} needs {n} processes, have {world}: launch one "
            f"process per device, e.g. torchrun --nproc-per-node {n} -m "
            "thyroid_tpu_torch.experiment.manager ...")
    key = (tuple(shape.items()), world)
    if key in _MESHES:
        return _MESHES[key]
    ranks = np.arange(n).reshape(tuple(shape.values()))
    mesh = Mesh(shape, ranks=ranks)
    names = mesh.axis_names
    for axes in _axis_sets(names):
        # every line along `axes`: the other axes' coordinates fixed
        others = [a for a in names if a not in axes]
        for fixed in itertools.product(*(range(shape[a]) for a in others)):
            at = dict(zip(others, fixed))
            index = tuple(slice(None) if a in axes else at[a] for a in names)
            members = [int(r) for r in np.asarray(ranks[index]).reshape(-1)]
            group = dist.new_group(members)
            if dist.get_rank() in members:
                mesh._groups[axes] = group
    _MESHES[key] = mesh
    return mesh


def destroy_meshes() -> None:
    """Forget every process mesh and leave the process group."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_lead_process() -> bool:
    """Rank 0 of the world, or the only process: the one that writes
    shared files (under torchrun, the group joined first)."""
    join_from_env()
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    """Wait for every rank of the world (a no-op in one process)."""
    join_from_env()
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def lead_value(value: Any) -> Any:
    """Rank 0's picklable `value` on every rank (`value` itself in one
    process), so that every rank takes rank 0's branch."""
    join_from_env()
    if dist.is_initialized() and dist.get_world_size() > 1:
        box = [value]
        dist.broadcast_object_list(box, src=0)
        return box[0]
    return value


@dataclass(frozen=True)
class RowSharding:
    """Contiguous rows of a global batch along `axis` (JAX's
    `NamedSharding(mesh, P(axis))`), or every row (`axis` None,
    `P()`)."""

    mesh: Mesh
    axis: Optional[str]

    @property
    def count(self) -> int:
        return self.mesh.shape[self.axis] if self.axis else 1

    @property
    def index(self) -> int:
        """This process's block (a process mesh)."""
        return self.mesh.index(self.axis) if self.axis else 0

    def rows(self, n: int) -> int:
        if n % self.count:
            raise ValueError(f"a batch of {n} rows does not split into "
                             f"{self.count} equal shards along '{self.axis}'")
        return n // self.count

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This process's rows of the global batch x."""
        b = self.rows(x.shape[0])
        return x.narrow(0, self.index * b, b)

    def split(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every coordinate's rows of x, in order."""
        return list(torch.split(x, self.rows(x.shape[0])))


def batch_sharding(mesh: Mesh, data_axis: str = "data") -> RowSharding:
    """Shard the leading (batch) dim over the data axis."""
    if data_axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis '{data_axis}'")
    return RowSharding(mesh, data_axis)


def replicated(mesh: Mesh) -> RowSharding:
    return RowSharding(mesh, None)


def shard_batch(batch, mesh: Mesh, data_axis: str = "data"):
    """A {name: tensor} batch (or one tensor) → on a process mesh, this
    process's rows of each; on a device mesh, each tensor's rows split
    over the axis's devices, a list of shards."""
    sh = batch_sharding(mesh, data_axis)

    def one(x):
        if mesh.is_process_mesh:
            return sh.take(x)
        return [s.to(d) for s, d in zip(sh.split(x), axis_devices(mesh, data_axis))]

    if isinstance(batch, Mapping):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)


def axis_devices(mesh: Mesh, axis: str) -> List[torch.device]:
    """A device mesh's devices along `axis`, the other axes at 0."""
    line = np.moveaxis(mesh.devices, mesh.axis_names.index(axis), 0)
    return list(line.reshape(mesh.shape[axis], -1)[:, 0])


def fsdp_param_sharding(mesh: Mesh, model_axis: str,
                        params: Mapping[str, torch.Tensor],
                        layout: Optional[Mapping[str, Tuple]] = None
                        ) -> Dict[str, Optional[int]]:
    """{name: the port dim sharded over `model_axis`, or None (replicated)}
    for a {name: tensor} tree: JAX's rule on the JAX shape of each leaf,
    the largest dim divisible by the axis size, first of equals, ≥2-D
    leaves only. `layout` (models.from_jax.jax_layout) maps a leaf whose
    port layout differs (OIHW kernels) to its JAX axes, so that the port
    shards the dim JAX's spec names."""
    size = mesh.shape[model_axis]
    out: Dict[str, Optional[int]] = {}
    for name, x in params.items():
        axes = layout[name][2] if layout is not None and name in layout else None
        # port dim i holds JAX dim axes[i]
        jax_shape = list(x.shape) if axes is None else \
            [x.shape[axes.index(j)] for j in range(x.dim())]
        out[name] = None
        if x.dim() < 2:
            continue
        for d in sorted(range(x.dim()), key=lambda d: jax_shape[d], reverse=True):
            if jax_shape[d] % size == 0 and jax_shape[d] >= size:
                out[name] = d if axes is None else axes.index(d)
                break
    return out


def local_device_count() -> int:
    """The CUDA cards this process sees (1 on a machine without one: the
    CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def device_info() -> dict:
    """Device summary, JAX's keys."""
    cuda = torch.cuda.is_available()
    return {
        "platform": "gpu" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "device_count": (dist.get_world_size() if dist.is_initialized()
                         else local_device_count()),
        "local_device_count": local_device_count(),
        "process_index": dist.get_rank() if dist.is_initialized() else 0,
        "default_backend": "gpu" if cuda else "cpu",
    }
