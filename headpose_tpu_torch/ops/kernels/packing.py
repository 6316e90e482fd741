"""Weights of a module packed into one contiguous float32 buffer for a kernel.

A kernel takes one device pointer and the start of each weight in it
(`Packed.offsets`, in floats).  `packed(module, leaves)` packs the tensors
that `leaves(module)` yields, in the kernel's layout, once per module: the
pack is cached beside the module and rebuilt only when a parameter changes
(another storage, or an in-place write such as `load_state_dict`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import weakref
from typing import Callable, Iterable

import torch
from torch import nn

__all__ = ["Packed", "packed", "c_ints"]


@dataclasses.dataclass(frozen=True)
class Packed:
    weights: torch.Tensor                  # (total,) float32, contiguous
    offsets: tuple[int, ...]               # start of each leaf, in floats;
                                           # each leaf is row-major


_CACHE: "weakref.WeakKeyDictionary[nn.Module, tuple]" = \
    weakref.WeakKeyDictionary()


def _stamp(module: nn.Module) -> tuple:
    # inference tensors keep no version counter (and cannot be written to
    # outside inference mode)
    return tuple((p.data_ptr(), 0 if p.is_inference() else p._version)
                 for p in module.parameters())


def packed(module: nn.Module,
           leaves: Callable[[nn.Module], Iterable[torch.Tensor]]) -> Packed:
    """The module's weights as `leaves` lays them out, in one buffer on the
    module's device (cached per module)."""
    stamp = _stamp(module)
    hit = _CACHE.get(module)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    with torch.no_grad():
        parts = [t.detach().to(torch.float32).contiguous()
                 for t in leaves(module)]
        offsets, start = [], 0
        for t in parts:
            offsets.append(start)
            start += t.numel()
        pack = Packed(torch.cat([t.reshape(-1) for t in parts]),
                      tuple(offsets))
    _CACHE[module] = (stamp, pack)
    return pack


def c_ints(values: Iterable[int]) -> ctypes.Array:
    """A host int array for a kernel's C entry point."""
    values = [int(v) for v in values]
    return (ctypes.c_int * len(values))(*values)
