"""What a module's weights are now: the key that a cache of values derived
from them (a kernel's weight pack, ops/kernels/packing.py; an ensemble's
stacked members, models/heads.py) is checked against."""
from __future__ import annotations

from torch import nn

from .profiling import span

__all__ = ["stamp"]


def stamp(module: nn.Module) -> tuple:
    """Each parameter's storage and version: a cache whose stamp differs was
    built from other weights (another storage, or an in-place write such as
    `load_state_dict`).  Walking a backbone's parameters is the costliest
    host step of a launch, so a caller that packs one module in several
    layouts takes the stamp once and passes it to each `packing.packed`
    call.  Timed as the span `pack.stamp`."""
    # inference tensors keep no version counter (and cannot be written to
    # outside inference mode)
    with span("pack.stamp"):
        return tuple((p.data_ptr(), 0 if p.is_inference() else p._version)
                     for p in module.parameters())
