"""Multi-process runtime bring-up and the port's collectives.

Port of headpose_tpu/parallel/distributed.py.  JAX drives a mesh from one
controller; PyTorch runs one process per device (SPMD), joined by
`torch.distributed`.  The same script runs on every rank:

    from headpose_tpu_torch.parallel import (initialize_distributed,
                                             global_mesh, host_local_batch)
    initialize_distributed()          # no-op in one process; env-driven
    mesh = global_mesh(model_parallel=1)
    batch = host_local_batch(mesh, local_rows)   # this rank's rows → DTensor

The backend is NCCL on the card and gloo on the CPU.  NCCL refuses two
ranks on one device ("Duplicate GPU detected"): ranks that share a card
name `backend="gloo"` explicitly.  Nothing swaps one backend for another;
a failed init raises.

Each rank's device is `cuda:<local device id>`, from `local_device_ids`,
else the launcher's local rank (LOCAL_RANK, SLURM_LOCALID,
OMPI_COMM_WORLD_LOCAL_RANK); `utils.device.resolve_device(None)` returns it.

The port's own collectives (`all_reduce_`, `all_gather_rows`,
`broadcast_`, `barrier`) are c10d's, on the tensors' own device, under NCCL
and under gloo alike.  DTensor's are the functional collectives; on a gloo
group of CUDA ranks (ranks sharing one card) those that fault there can
be routed through host memory (`route_gloo_cuda_collectives`, which
names them in `HOST_STAGED`).
"""
from __future__ import annotations

import os
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import set_local_device
from .mesh import DATA_AXIS, create_mesh, mesh_device

__all__ = ["initialize_distributed", "global_mesh", "host_local_batch",
           "is_distributed", "all_reduce_", "all_gather_rows", "broadcast_",
           "barrier", "route_gloo_cuda_collectives", "HOST_STAGED"]

_CLUSTER_ENVS = (
    # (world size, rank, local rank) variables of a launcher
    ("WORLD_SIZE", "RANK", "LOCAL_RANK"),                      # torchrun
    ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"),         # SLURM
    ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
     "OMPI_COMM_WORLD_LOCAL_RANK"),                            # Open MPI
)


def is_distributed() -> bool:
    """True under a process group of more than one rank."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def _cluster_env() -> tuple[int, int, int] | None:
    """(world size, rank, local rank) of the first launcher whose
    environment names a world of more than one process."""
    for size_key, rank_key, local_key in _CLUSTER_ENVS:
        size = os.environ.get(size_key)
        if size and int(size) > 1:
            return (int(size), int(os.environ.get(rank_key, 0)),
                    int(os.environ.get(local_key, 0)))
    return None


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           local_device_ids: Sequence[int] | None = None,
                           *, backend: str | None = None) -> None:
    """Join this process to the process group (idempotent).

    A single process with no cluster environment is a no-op, so one
    training script runs from a laptop to a cluster.  Any explicit argument
    requests bring-up (a caller passing only process_id must not be
    quietly left at world size 1).  Missing values come from the launcher's
    environment: torchrun (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT), SLURM and Open MPI (their sizes and ranks; the address
    from MASTER_ADDR/MASTER_PORT).

    coordinator_address  "host:port" of rank 0's store;
    local_device_ids     this rank's CUDA device (its first entry);
    backend              None: "nccl" where CUDA is available, else
                         "gloo".  Ranks sharing one card pass "gloo".
    """
    if dist.is_initialized():
        return
    explicit = (coordinator_address is not None
                or num_processes not in (None, 1)
                or process_id is not None
                or local_device_ids is not None)
    env = _cluster_env()
    if not (explicit or env):
        return          # one process: nothing to bring up
    world = num_processes if num_processes is not None else (
        env[0] if env else None)
    rank = process_id if process_id is not None else (
        env[1] if env else None)
    if world is None or rank is None:
        raise ValueError(
            "initialize_distributed needs num_processes and process_id "
            "(or a launcher's environment: torchrun, SLURM, Open MPI)")
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get(
            "MASTER_PORT")
        if not (addr and port):
            raise ValueError(
                "initialize_distributed needs coordinator_address "
                "('host:port') or MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{addr}:{port}"
    local = (local_device_ids[0] if local_device_ids
             else (env[2] if env else None))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "gloo" and "GLOO_SOCKET_IFNAME" not in os.environ and (
            coordinator_address.split(":")[0] in ("localhost", "127.0.0.1")):
        # one host: gloo's pairs on the loopback device, not on whatever
        # interface the host name resolves to
        os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    if torch.cuda.is_available() and local is not None:
        set_local_device(local)
        torch.cuda.set_device(int(local))
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(world), rank=int(rank))


def global_mesh(model_parallel: int = 1,
                devices: Sequence[int] | None = None,
                device_type: str | None = None):
    """A (data, model) mesh over every rank of the group, ranks contiguous
    along 'data' (a rank's neighbours on 'model' are the next ranks, as
    JAX keeps a process's devices together), on the card unless
    device_type="cpu".  Delegates to `mesh.create_mesh`: one place owns
    the grid layout."""
    return create_mesh(model_parallel=model_parallel, devices=devices,
                       device_type=device_type)


def host_local_batch(mesh, local_rows: Any) -> Any:
    """A batch sharded on dim 0 over 'data' from this rank's rows: every
    leaf (array or tensor) becomes `DTensor.from_local(rows, mesh,
    [Shard(0), Replicate()])` on the mesh's device, the rows of the ranks
    in data order making the global batch.  Ranks along 'model' pass the
    same rows."""
    from torch.distributed.tensor import DTensor

    from .mesh import _placements, _tree_map

    placements = _placements(mesh, DATA_AXIS)
    device = mesh_device(mesh)

    def put(a):
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                            else a).to(device)
        return DTensor.from_local(t, mesh, placements, run_check=False)

    return _tree_map(put, local_rows)


# ----------------------------------------------------------- collectives
def all_reduce_(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `tensor` over the group's ranks, in place; returns it."""
    dist.all_reduce(tensor, group=group)
    return tensor


def all_gather_rows(local: torch.Tensor, group=None) -> torch.Tensor:
    """The group's ranks' `local` tensors (equal shapes) concatenated along
    dim 0 in rank order, on every rank."""
    n = dist.get_world_size(group)
    if n == 1:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=group)
    return torch.cat(parts)


def broadcast_(tensor: torch.Tensor) -> torch.Tensor:
    """`tensor` from rank 0 to every rank, in place; returns it."""
    dist.broadcast(tensor, 0)
    return tensor


# DTensor's collectives are the functional ones (_c10d_functional).  Under
# gloo on CUDA tensors, torch 2.11's all-gather among them faults (a
# segfault in wait_tensor; PERF.md §6), while c10d's own collectives
# and the functional all-reduce run.  Ranks that share a card run gloo on
# CUDA tensors (NCCL refuses them) and route these through host memory;
# HOST_STAGED names those that went that way.
_HOST_ROUTED = ("all_gather_into_tensor", "reduce_scatter_tensor",
                "all_to_all_single")
HOST_STAGED: set[str] = set()
_host_routes: list = []


def route_gloo_cuda_collectives() -> None:
    """Run the functional collectives of _HOST_ROUTED on CUDA tensors
    through host memory (the same op on a CPU copy; gloo's CPU path), for
    the whole process.  It is meant for ranks that share a card under
    gloo (the dryrun's --same-device ranks call it); call it only where
    every group is gloo's.  Under NCCL nothing needs it."""
    if _host_routes:
        return
    import warnings

    lib = torch.library.Library("_c10d_functional", "IMPL")
    for name in _HOST_ROUTED:
        op = getattr(torch.ops._c10d_functional, name).default

        def on_host(x, *args, _op=op, _name=name):
            HOST_STAGED.add(_name)
            out = torch.ops._c10d_functional.wait_tensor(_op(x.cpu(), *args))
            return out.to(x.device)

        with warnings.catch_warnings():     # "overriding a kernel"
            warnings.simplefilter("ignore")
            lib.impl(name, on_host, "CUDA")
    _host_routes.append(lib)


def barrier() -> None:
    """Every rank meets here (a no-op in one process)."""
    if is_distributed():
        dist.barrier()
