"""The MLP pose head: Dense layers, each with its activation, run on every
cell of the map alone (`spec[head]["layers"]`: [(width, activation), ...];
weights `<head>/layers/<j>/{w, b}`, `w` as (in, out))."""
from __future__ import annotations

import numpy as np
import torch

COUPLES_CELLS = False

ACTIVATIONS = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1.0 + x.abs()),
}


def build(head_spec: dict, params, prefix: str, device):
    """The head over (B, H, W, C) maps → (B, H, W, out)."""
    def t(key):
        return torch.from_numpy(np.asarray(params[prefix + key],
                                           np.float32)).to(device)

    layers = [(t(f"layers/{j}/w"), t(f"layers/{j}/b"), act)
              for j, (_, act) in enumerate(head_spec["layers"])]

    def head(x):
        for w, b, act in layers:
            x = ACTIVATIONS[act](x @ w + b)
        return x
    return head


def flops(head_spec: dict, cells: int) -> int:
    """Each layer's products over `cells` cells; a multiply-add counts 2."""
    total, width = 0, head_spec["in_features"]
    for cout, _ in head_spec["layers"]:
        total += 2 * cells * width * cout
        width = cout
    return total
