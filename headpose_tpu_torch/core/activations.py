"""Keras activation table, PyTorch edition.

One table for the Keras activation names used by the pose-head zoo, with
Keras semantics.  Two entries differ from PyTorch's defaults:

  * 'leaky_relu' is the tf-keras ACTIVATION string, alpha = 0.2
    (torch.nn.functional.leaky_relu defaults to 0.01);
  * 'gelu' is the exact erf form (approximate='none').

`ACTIVATION_IDS` numbers the table for the fused head kernel: the enum in
csrc/head_mlp.cu uses the same numbers (a CPU test reads both).
"""
from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["ACTIVATIONS", "ACTIVATION_IDS", "get_activation", "activation_id"]

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,            # x / (1 + |x|)
    "elu": F.elu,
    "selu": torch.selu,
    "softplus": F.softplus,
    "swish": F.silu,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.2),
    "gelu": lambda x: F.gelu(x, approximate="none"),
}

ACTIVATION_IDS: dict[str, int] = {name: i for i, name in enumerate(ACTIVATIONS)}


def get_activation(name: str | None) -> Callable[[torch.Tensor], torch.Tensor]:
    if not name:
        return ACTIVATIONS["linear"]
    try:
        return ACTIVATIONS[name]
    except KeyError:
        raise NotImplementedError(f"activation {name!r}")


def activation_id(name: str | None) -> int:
    """The kernel's number for a Keras activation name; an unknown name
    raises as `get_activation` does."""
    get_activation(name)
    return ACTIVATION_IDS[name or "linear"]
