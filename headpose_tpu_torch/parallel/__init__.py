"""Parallelism on torch.distributed: device meshes, sharding helpers,
multi-process bring-up (port of headpose_tpu/parallel).

One process a device (SPMD): every rank runs the same script, joined by
`torch.distributed` (NCCL on the card, gloo on the CPU).  A mesh is a
`DeviceMesh` of shape (data, model); sharded values are DTensors.
`python -m headpose_tpu_torch.parallel.dryrun --nproc N` spawns N ranks and
runs the multi-device paths end to end."""
from .mesh import (create_mesh, replicate, shard_rows, shard_batch,
                   head_param_specs, shard_head_params,
                   DATA_AXIS, MODEL_AXIS)
from .distributed import (initialize_distributed, global_mesh,
                          host_local_batch, is_distributed)

__all__ = ["create_mesh", "replicate", "shard_rows", "shard_batch",
           "head_param_specs", "shard_head_params",
           "DATA_AXIS", "MODEL_AXIS",
           "initialize_distributed", "global_mesh", "host_local_batch",
           "is_distributed"]
