"""Weights of a module packed into one contiguous buffer for a kernel.

A kernel takes one device pointer and the start of each weight in it
(`Packed.offsets`, in elements).  `packed(module, leaves)` packs the tensors
that `leaves(module)` yields, in the kernel's layout, once per module and
layout: the pack is cached beside the module, keyed by `leaves` and the
element type, and rebuilt only when a parameter changes (another storage,
or an in-place write such as `load_state_dict`).  A kernel whose launch
takes a table built from the module and the offsets gets it built once,
with the pack (`table`).  A pack is checked against `utils.weights.stamp`
(the span `pack.stamp`); a pack built (a cache miss) is the section
`pack.build` (utils.profiling).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Iterable

import torch
from torch import nn

from ...utils.profiling import section
from ...utils.weights import stamp

__all__ = ["Packed", "packed"]


@dataclasses.dataclass(frozen=True)
class Packed:
    weights: torch.Tensor                  # (total,) contiguous
    offsets: tuple[int, ...]               # start of each leaf, in
                                           # elements; each leaf row-major
    table: Any = None                      # table(module, offsets), if given


_CACHE: "weakref.WeakKeyDictionary[nn.Module, dict]" = \
    weakref.WeakKeyDictionary()


def packed(module: nn.Module,
           leaves: Callable[[nn.Module], Iterable[torch.Tensor]],
           dtype: torch.dtype = torch.float32,
           current: tuple | None = None,
           table: Callable[[nn.Module, tuple[int, ...]], Any] | None = None
           ) -> Packed:
    """The module's weights as `leaves` lays them out, in one `dtype` buffer
    on the module's device (cached per module, `leaves` and `dtype`).
    `current` is `stamp(module)` when the caller has just taken it;
    `table(module, offsets)`, when given, is built with the pack and kept
    in it."""
    current = stamp(module) if current is None else current
    packs = _CACHE.setdefault(module, {})
    hit = packs.get((leaves, dtype))
    if hit is not None and hit[0] == current:
        return hit[1]
    with section("pack.build"), torch.no_grad():
        parts = [t.detach().to(dtype).contiguous() for t in leaves(module)]
        offsets, start = [], 0
        for t in parts:
            offsets.append(start)
            start += t.numel()
        offsets = tuple(offsets)
        pack = Packed(torch.cat([t.reshape(-1) for t in parts]), offsets,
                      None if table is None else table(module, offsets))
    packs[(leaves, dtype)] = (current, pack)
    return pack

