"""Pose-regression heads, PyTorch edition.

Port of the MLP family of headpose_tpu/models/heads.py, inference only.  The
reference defines its heads as stacks of 1x1 convolutions; a 1x1 conv over an
HxW map is a matmul over the channel axis, so one `MLPHeadNet` serves both
per-face vectors (N, C) and whole NHWC feature maps (B, H, W, C).

The other head families (residual, skip, SE, SE-Transformer, ensembles) are
not ported yet.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..core.activations import get_activation
from ..utils.device import resolve_device

__all__ = ["MLPHead", "MLPHeadNet"]


@dataclasses.dataclass(frozen=True)
class MLPHead:
    """A chain of (features, activation) dense layers over the channel axis.

    E.g. the production reg2 head hrchr82r is
    ``MLPHead(96, ((32, 'tanh'), (16, 'tanh'), (3, 'linear')))`` and reg1
    stoqa9pt is ``MLPHead(88, ((64, 'softsign'), (3, 'linear')))``.
    """

    in_features: int
    layers: tuple[tuple[int, str], ...]
    dropout_rate: float = 0.0  # training only; the port serves inference


class MLPHeadNet(nn.Module):
    """The dense chain of one `MLPHead` spec over the last axis."""

    def __init__(self, spec: MLPHead, *,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        layers, cin = [], spec.in_features
        for cout, _ in spec.layers:
            layers.append(nn.Linear(cin, cout, device=device))
            cin = cout
        self.layers = nn.ModuleList(layers)
        self._acts = [get_activation(act) for _, act in spec.layers]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer, act in zip(self.layers, self._acts):
            x = act(layer(x))
        return x
