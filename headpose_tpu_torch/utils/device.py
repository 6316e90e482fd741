"""Device resolution for the port's entry points, and a rank's part of a
sharded value."""
from __future__ import annotations

import os

import torch

__all__ = ["resolve_device", "set_local_device", "local_part"]

# the CUDA device of this process under a process group, when
# parallel.initialize_distributed was given local_device_ids
_local_device_id: int | None = None


def set_local_device(device_id: int | None) -> None:
    """Name this process's CUDA device (parallel.initialize_distributed
    does, from its `local_device_ids`); None forgets it."""
    global _local_device_id
    _local_device_id = None if device_id is None else int(device_id)


def _rank_device_id() -> int | None:
    """Under an initialized process group, the CUDA device id of this rank:
    the one `set_local_device` named, else LOCAL_RANK (torchrun's), else 0.
    None outside a group."""
    if _local_device_id is not None:
        return _local_device_id
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return None
    return int(os.environ.get("LOCAL_RANK", 0))


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` means the card: "cuda" (under a process group, the rank's own
    `cuda:<local device id>`), and it raises when no CUDA device is
    present.  The port never carries on quietly on the CPU; a caller that
    wants the CPU asks for it (`device="cpu"`)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        rank_id = _rank_device_id()
        return (torch.device("cuda") if rank_id is None
                else torch.device("cuda", rank_id))
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device


def local_part(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's part of `full` under DTensor `placements` on the
    `DeviceMesh` `mesh` (torch.chunk's split, DTensor's own), with no
    communication."""
    from torch.distributed.tensor import Shard

    local = full
    coord = mesh.get_coordinate()
    for mesh_dim, p in enumerate(placements):
        if isinstance(p, Shard):
            local = torch.chunk(local, mesh.size(mesh_dim),
                                dim=p.dim)[coord[mesh_dim]]
    return local
