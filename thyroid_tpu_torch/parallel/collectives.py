"""The collectives a process mesh's training step needs, and the gradient
synchronisation of data-parallel and FSDP training (what XLA inserts into
JAX's jitted step over a `jax.sharding.Mesh`).

Gathers are all-gathers where the backend gathers the tensor (NCCL, and
gloo for CPU tensors). gloo reduces CUDA tensors but does not gather
them, so there, and only there, a gather is a sum over a zero buffer that
holds each rank's block in its place, which is exact (x + 0 = x) and
moves about twice the bytes. Coalesced collectives flatten the tensors of
one dtype into one buffer.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from .mesh import Mesh, fsdp_param_sharding


class _AllReduceSum(torch.autograd.Function):
    """y = Σ over the group of x; its backward sums the output gradients
    the same way (each rank's loss reaches every rank's input through
    y)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group: Any) -> torch.Tensor:
    """The differentiable sum of x over `group` (an in-place
    dist.all_reduce would drop the other ranks' terms of the gradient)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_(tensors: List[torch.Tensor], group: Any) -> None:
    """Sum each tensor over `group`, in place, one all-reduce a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = _flatten_dense_tensors(ts)
        dist.all_reduce(flat, group=group)
        for t, r in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(r)


# all_gather_into_tensor's name from torch 2.13 on
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)


def gathers(x: torch.Tensor, group: Any) -> bool:
    """Whether `group`'s backend all-gathers x (gloo does not gather CUDA
    tensors)."""
    return x.device.type == "cpu" or dist.get_backend(group) != "gloo"


def gather_rows(x: torch.Tensor, group: Any, index: int, count: int) -> torch.Tensor:
    """The global batch whose block `index` of `count` equal blocks is
    this rank's x (not differentiable: for metrics). `index` is this
    rank's place in `group` (a mesh line's groups list their ranks in
    coordinate order)."""
    b = x.shape[0]
    if gathers(x, group):
        out = x.new_empty((b * count,) + tuple(x.shape[1:]))
        _all_gather(out, x.contiguous(), group=group)
        return out
    out = x.new_zeros((b * count,) + tuple(x.shape[1:]))
    out.narrow(0, index * b, b).copy_(x)
    dist.all_reduce(out, group=group)
    return out


def all_gather_objects(obj: Any, group: Any) -> List[Any]:
    """Every rank's picklable `obj` over `group`, in rank order."""
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class GradSync:
    """What a process mesh adds to the optimizer step (schedules.Optimizer
    `sync`): gradients summed over the data axis (each rank's gradient is
    that of its share of the global batch's mean loss), and with a model
    axis of size > 1, FSDP over it.

    FSDP: every ≥2-D leaf is split on the dim `fsdp_param_sharding` picks
    (JAX's spec) into `size` blocks along the model axis; this rank's
    optimizer state (the Adam moments, SGD's trace) holds its block only,
    the clip's global norm sums the squares over the blocks, the update
    runs on the block, and the blocks are gathered back into the whole
    parameter, which the forward reads. The batch is split over data and
    replicated over model, so a model line computes the same gradients."""

    def __init__(self, mesh: Mesh, data_axis: str = "data",
                 model_axis: Optional[str] = None,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 layout: Optional[Mapping[str, Any]] = None):
        self.mesh = mesh
        self.data_group = mesh.group((data_axis,))
        self.fsdp = bool(model_axis) and model_axis in mesh.shape \
            and mesh.shape[model_axis] > 1
        self.dims: Dict[str, Optional[int]] = {}
        if self.fsdp:
            self.model_group = mesh.group((model_axis,))
            self.size = mesh.shape[model_axis]
            self.block = mesh.index(model_axis)
            self.dims = fsdp_param_sharding(mesh, model_axis, params, layout)

    # -- blocks ------------------------------------------------------------
    def shard(self, name: str, t: torch.Tensor, block: Optional[int] = None
              ) -> torch.Tensor:
        """Block `block` (default: this rank's) of `t` (a view), or t
        itself."""
        d = self.dims.get(name)
        if d is None:
            return t
        n = t.shape[d] // self.size
        return t.narrow(d, (self.block if block is None else block) * n, n)

    def local(self, named: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {n: self.shard(n, t) for n, t in named.items()}

    def gather(self, full: Mapping[str, torch.Tensor],
               blocks: Optional[Mapping[str, torch.Tensor]] = None) -> None:
        """Fill every sharded tensor of `full` from the model line's
        blocks: this rank's from `blocks` (default: its own block of
        `full`), the others' from theirs."""
        names = [n for n in full if self.dims.get(n) is not None]
        if not names:
            return
        if gathers(full[names[0]], self.model_group):
            by_dtype: Dict[torch.dtype, List[str]] = {}
            for n in names:
                by_dtype.setdefault(full[n].dtype, []).append(n)
            with torch.no_grad():
                for ns in by_dtype.values():
                    mine = [self.shard(n, full[n]) if blocks is None else blocks[n]
                            for n in ns]
                    flat = _flatten_dense_tensors(mine)
                    every = flat.new_empty(self.size * flat.numel())
                    _all_gather(every, flat, group=self.model_group)
                    for r, row in enumerate(every.view(self.size, -1)):
                        for n, b in zip(ns, _unflatten_dense_tensors(row, mine)):
                            self.shard(n, full[n], r).copy_(b)
            return
        bufs = []
        for n in names:
            b = torch.zeros_like(full[n])
            src = self.shard(n, full[n]) if blocks is None else blocks[n]
            self.shard(n, b).copy_(src)
            bufs.append(b)
        all_reduce_(bufs, self.model_group)
        with torch.no_grad():
            for n, b in zip(names, bufs):
                full[n].copy_(b)

    # -- the optimizer's hooks ----------------------------------------------
    def reduce(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Sum the gradients over the data axis in place → the blocks the
        update reads."""
        all_reduce_(list(grads.values()), self.data_group)
        return self.local(grads)

    def norm(self, named: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradient tree from the blocks:
        the sharded leaves' squares summed over the model axis, the
        replicated leaves' once."""
        sharded = [t.float() for n, t in named.items() if self.dims.get(n) is not None]
        whole = [t.float() for n, t in named.items() if self.dims.get(n) is None]
        dev = next(iter(named.values())).device
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        if sharded:
            sq = torch.stack(torch._foreach_norm(sharded)).pow(2).sum()
        dist.all_reduce(sq, group=self.model_group)
        if whole:
            sq = sq + torch.stack(torch._foreach_norm(whole)).pow(2).sum()
        return torch.sqrt(sq)

    def full_state(self, sd: Dict[str, Any], like: Mapping[str, torch.Tensor],
                   slots=("mu", "nu", "trace")) -> Dict[str, Any]:
        """An optimizer state_dict whose slots hold blocks → the whole
        tensors (every rank of the model line must call it)."""
        out = dict(sd)
        for slot in slots:
            if slot in sd:
                whole = {n: torch.zeros_like(like[n]) if self.dims.get(n) is not None
                         else t.clone() for n, t in sd[slot].items()}
                self.gather(whole, sd[slot])
                out[slot] = whole
        return out

    def block_state(self, sd: Dict[str, Any],
                    slots=("mu", "nu", "trace")) -> Dict[str, Any]:
        """The inverse: whole slots → this rank's blocks."""
        out = dict(sd)
        for slot in slots:
            if slot in sd:
                out[slot] = {n: self.shard(n, t).clone() for n, t in sd[slot].items()}
        return out
