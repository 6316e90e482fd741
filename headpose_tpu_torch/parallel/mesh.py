"""Device meshes and sharding helpers on torch.distributed.

Port of headpose_tpu/parallel/mesh.py.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` of shape (data, model) over the
ranks of the process group, one rank a device, `mesh_dim_names=("data",
"model")`: 'data' for data parallelism (the gradient all-reduce), 'model'
for tensor parallelism over the heads' hidden dimensions.  Sharded values
are `torch.distributed.tensor.DTensor`s with `Replicate()` and `Shard(d)`
placements, one a mesh dimension.  The helpers take the whole value on
every rank (as JAX's `device_put` takes the host array) and keep each
rank's part of it, with no communication.

With no process group, a 1x1 mesh is built over a process group of one
(an in-process store), so a plain script runs unchanged on one device.
"""
from __future__ import annotations

from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from ..utils.device import local_part, resolve_device

__all__ = ["create_mesh", "replicate", "shard_rows", "shard_batch",
           "head_param_specs", "shard_head_params",
           "DATA_AXIS", "MODEL_AXIS"]

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _single_process_group(device_type: str) -> None:
    """A process group of one over an in-process store (no address, no
    port): what a mesh needs in a single process."""
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            store=dist.HashStore(), world_size=1, rank=0)


def create_mesh(n_devices: int | None = None, model_parallel: int = 1,
                devices: Sequence[int] | None = None,
                device_type: str | None = None):
    """A (data, model) DeviceMesh over the process group's ranks (or over
    `devices`, a list of ranks), `n_devices // model_parallel` by
    `model_parallel`, ranks in row-major order.  Every rank of the group
    calls it (a collective).  device_type None is the card ("cuda"), and
    it raises where none is present; a CPU mesh asks for it
    (device_type="cpu").
    """
    from torch.distributed.device_mesh import DeviceMesh

    if device_type is None:
        device_type = resolve_device(None).type
    if not dist.is_initialized():
        if n_devices not in (None, 1) or (devices is not None
                                          and len(devices) > 1):
            want = n_devices if n_devices is not None else len(devices)
            raise ValueError(f"requested a {want}-device mesh but only 1 "
                             f"devices are available")
        _single_process_group(device_type)
    ranks = list(devices if devices is not None
                 else range(dist.get_world_size()))
    if n_devices is not None:
        if len(ranks) < n_devices:
            # a narrower mesh would let a caller 'validate' multi-device
            # behaviour at a width it never ran
            raise ValueError(
                f"requested a {n_devices}-device mesh but only "
                f"{len(ranks)} devices are available")
        ranks = ranks[:n_devices]
    n = len(ranks)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by "
                         f"model_parallel={model_parallel}")
    grid = torch.tensor(ranks, dtype=torch.int64).reshape(
        n // model_parallel, model_parallel)
    return DeviceMesh(device_type, grid,
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_device(mesh) -> torch.device:
    """This rank's device on `mesh`: the CPU, or its CUDA device."""
    if mesh.device_type == "cuda":
        return resolve_device(None)
    return torch.device(mesh.device_type)


def axis_size(mesh, axis: str = DATA_AXIS) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(axis)))


def axis_index(mesh, axis: str = DATA_AXIS) -> int:
    """This rank's coordinate along `axis`."""
    return int(mesh.get_local_rank(axis))


def _placements(mesh, shard_axis: str | None = None, dim: int = 0):
    """Replicate() on every mesh dimension, Shard(dim) on `shard_axis`."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dim) if name == shard_axis else Replicate()
                 for name in mesh.mesh_dim_names)


def place(full: torch.Tensor, mesh, placements):
    """`full`, the same on every rank, as a DTensor under `placements`:
    each rank keeps its part (torch.chunk's split) on the mesh's device."""
    from torch.distributed.tensor import DTensor

    full = full.to(mesh_device(mesh))
    local = local_part(full, mesh, placements).contiguous()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=full.shape, stride=full.stride())


def _tree_map(fn: Callable, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    import numpy as np

    return torch.as_tensor(np.asarray(a))


def replicate(tree: Any, mesh) -> Any:
    """Every leaf (array or tensor) of a tree replicated over the mesh."""
    placements = _placements(mesh)
    return _tree_map(lambda a: place(_as_tensor(a), mesh, placements), tree)


def shard_rows(tree: Any, mesh, axis: str = DATA_AXIS) -> Any:
    """Every leaf's dim 0 sharded over the mesh axis (dataset rows),
    replicated over the others."""
    placements = _placements(mesh, axis)
    return _tree_map(lambda a: place(_as_tensor(a), mesh, placements), tree)


def shard_batch(tree: Any, mesh, axis: str = DATA_AXIS) -> Any:
    """Alias of shard_rows for image/feature batches."""
    return shard_rows(tree, mesh, axis)


# ---------------------------------------------------------------- tensor par
# A spec is written first on the JAX layout of a leaf (the dimension that
# 'model' shards, or None), as JAX's PartitionSpecs are, then carried onto
# the port's layout: a dense kernel is (out, in) in the port, (in, out) in
# JAX, so its sharded dimension flips.
def _dense_pair_specs(sizes: list[int], tp: int) -> list[dict]:
    """Megatron-style column→row specs for a dense chain whose layer i maps
    sizes[i] → sizes[i+1]: even layers shard the OUTPUT dim over 'model',
    odd layers the INPUT dim (the sum over it is a reduction over
    'model'), the tail of an odd-length chain stays replicated.  Dims not
    divisible by the model-axis size stay replicated (a ragged shard).
    Leaves are the sharded dimension of the JAX layout, or None."""
    n = len(sizes) - 1
    specs: list[dict] = []
    for i in range(n):
        din, dout = sizes[i], sizes[i + 1]
        if i % 2 == 0 and i < n - 1 and dout % tp == 0:
            specs.append({"w": 1, "b": 0})
        elif i % 2 == 1 and din % tp == 0 and specs[-1]["b"] == 0:
            specs.append({"w": 0, "b": None})
        else:
            specs.append({"w": None, "b": None})
    return specs


_NONE = {"w": None, "b": None}


def _jax_layout_specs(spec: Any, params: Any, tp: int) -> Any:
    """JAX's head_param_specs, leaves the sharded dim of the JAX layout."""
    from ..models import heads as H

    if isinstance(spec, H.MLPHead):
        sizes = [spec.in_features] + [c for c, _ in spec.layers]
        return {"layers": _dense_pair_specs(sizes, tp)}
    if isinstance(spec, H.ResidualMLPHead):
        blk = _dense_pair_specs([spec.width] * 3, tp)
        return {"proj": dict(_NONE),
                "blocks": [{"fc1": blk[0], "fc2": blk[1]}
                           for _ in range(spec.num_blocks)],
                "bottleneck": dict(_NONE), "out": dict(_NONE)}
    if isinstance(spec, H.SkipMLPHead):
        pair = _dense_pair_specs([spec.enc1, spec.enc2, spec.enc1], tp)
        return {"enc1": dict(_NONE), "enc2": pair[0], "dec": pair[1],
                "out": dict(_NONE)}
    if isinstance(spec, H.SEMLPHead):
        fc_pair = _dense_pair_specs(
            [spec.in_features, spec.hidden, spec.out_features], tp)
        mid = spec.in_features // spec.reduction
        se_pair = _dense_pair_specs(
            [spec.in_features, mid, spec.in_features], tp)
        return {"se": {"fc1": se_pair[0], "fc2": se_pair[1]},
                "fc": fc_pair[0], "out": fc_pair[1]}
    if isinstance(spec, H.SETransformerHead):
        mid = spec.in_features // spec.reduction
        se_pair = _dense_pair_specs(
            [spec.in_features, mid, spec.in_features], tp)
        ff_pair = _dense_pair_specs(
            [spec.in_features, spec.ff_dim, spec.in_features], tp)
        fc_pair = _dense_pair_specs(
            [spec.in_features, spec.hidden, spec.out_features], tp)
        heads_ok = spec.num_heads % tp == 0
        qkv = {"w": 1, "b": 0} if heads_ok else dict(_NONE)
        attn_out = {"w": 0, "b": None} if heads_ok else dict(_NONE)
        return {"se": {"fc1": se_pair[0], "fc2": se_pair[1]},
                "query": qkv, "key": dict(qkv), "value": dict(qkv),
                "attn_out": attn_out,
                "ln1": {"g": None, "b": None},
                "ff1": ff_pair[0], "ff2": ff_pair[1],
                "ln2": {"g": None, "b": None},
                "fc": fc_pair[0], "out": fc_pair[1]}
    if isinstance(spec, H.EnsembleHead):
        # each member shards on its own family's rule; the average is
        # elementwise on replicated outputs
        return {"members": [_jax_layout_specs(m, p, tp)
                            for m, p in zip(spec.members, params["members"])]}
    # another family: replicated (right, just not model-parallel)
    return _tree_map(lambda _: None, params)


def head_param_specs(spec: Any, params: Any, tp: int) -> Any:
    """Tensor-parallel placements for any pose-head family, JAX's rules
    (column→row pairs over 'model' so every module's output is
    replicated; residual and skip blocks shard their inner pair; the
    SE-Transformer shards attention across heads and its FFN/fc pairs; the
    ensemble recurses into its members).

    Returns `params`' tree (JAX layout, as `spec.init` gives it) whose
    leaves are the placements, on a (data, model) mesh, of the PORT's
    tensor of that leaf (`models.params.params_from_jax`'s layout: a dense
    kernel (out, in)): `(Replicate(), Shard(d))` or `(Replicate(),
    Replicate())`."""
    from torch.distributed.tensor import Replicate, Shard

    from ..models.params import DENSE, leaf_layouts

    jax_specs = _jax_layout_specs(spec, params, tp)
    layouts = {path: layout for _, path, layout in leaf_layouts(spec)}

    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        if node is None:
            return (Replicate(), Replicate())
        dim = 1 - node if layouts.get(path) == DENSE else node
        return (Replicate(), Shard(dim))

    return walk(jax_specs, ())


def shard_head_params(spec: Any, params: Any, mesh):
    """The head's module (`models.heads.head_net`) on this rank's device,
    its parameters loaded from `params` (JAX layout) and each made a
    DTensor parameter under `head_param_specs` (tp = the 'model' axis
    size).  Train it as the plain module (`net(x, generator)` on a DTensor
    batch): DTensor carries the products' sums over 'model'."""
    from torch import nn

    from ..models.heads import head_net
    from ..models.params import leaf_layouts, params_from_jax

    specs = head_param_specs(spec, params, axis_size(mesh, MODEL_AXIS))
    net = head_net(spec, device=mesh_device(mesh))
    net.load_state_dict(params_from_jax(spec, params))
    for key, path, _ in leaf_layouts(spec):
        leaf = specs
        for p in path:
            leaf = leaf[p]
        owner, _, name = key.rpartition(".")
        module = net.get_submodule(owner)
        full = getattr(module, name).detach()
        setattr(module, name, nn.Parameter(place(full, mesh, leaf)))
        if (isinstance(module, nn.Linear) and name == "weight"
                and any(p.is_shard(1) for p in leaf)):
            module.register_forward_hook(_summed)
    return net


def _summed(module, inputs, out):
    """A row-parallel layer's output (partial sums over 'model') summed
    over the ranks right away (an all-reduce), as Megatron's row-parallel
    layer does: left partial, DTensor may take it apart (a reduce-scatter)
    and later gather it again."""
    from torch.distributed.tensor import Partial, Replicate

    return out.redistribute(out.device_mesh, [
        Replicate() if isinstance(p, Partial) else p for p in out.placements])
