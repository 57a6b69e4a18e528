"""Meshes, sharding and the multi-slice sweep (counterpart of
thyroid_tpu/parallel): one process a device joined by torch.distributed
for training (launched by torchrun, or `spawn`), an explicit device list
in one process for serving."""
from .mesh import (
    Mesh,
    RowSharding,
    batch_sharding,
    create_mesh,
    device_info,
    fsdp_param_sharding,
    local_device_count,
    replicated,
    shard_batch,
)
from .multislice import (
    merge_slice_summaries,
    multislice_mesh,
    partition_folds,
    stack_pytrees,
    stacked_step,
    unstack_pytree,
)
from .spawn import spawn

__all__ = [
    "Mesh", "RowSharding",
    "create_mesh", "batch_sharding", "replicated", "shard_batch",
    "fsdp_param_sharding", "local_device_count", "device_info",
    "multislice_mesh", "partition_folds", "merge_slice_summaries",
    "stack_pytrees", "unstack_pytree", "stacked_step", "spawn",
]
