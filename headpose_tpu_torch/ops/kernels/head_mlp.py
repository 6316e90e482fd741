"""The fused MLP pose head on the card: wrapper of csrc/head_mlp.cu.

`mlp_head_forward(net, x)` is the counterpart of the TPU kernel
headpose_tpu/ops/pallas/head_mlp.py::mlp_head_forward: every dense layer
and Keras activation of `net` (an `MLPHeadNet`) over feature rows x (N, C)
float32, returning (N, out).  A tensor on the CPU goes through
`mlp_head_forward_plain`; a tensor on a CUDA device goes through the
hand-written kernel, or the call raises.  Nothing else selects between the
two.  The JAX function's `tile` and `interpret` are TPU-grid knobs and have
no counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.activations import activation_id, get_activation
from ...models.heads import MLPHeadNet
from . import library as lib
from .packing import Packed, packed

__all__ = ["mlp_head_forward", "mlp_head_forward_plain",
           "mlp_head_forward_cuda", "head_pack", "domain_error", "LIBRARY"]

LIBRARY = lib.LIBRARIES["head_mlp"]
SOURCE = LIBRARY.sources[0]
MAX_LAYERS = 8
MAX_WIDTH = 896      # 2 buffers x 16 rows x 896 floats, the smallest tile


def _kernel_leaves(net: MLPHeadNet):
    """Per layer: the weights (in, out) with zero columns up to a multiple
    of 4 (the kernel stages them by 16-byte rows), then the bias with zeros
    likewise; every leaf then starts 16-byte aligned."""
    for layer in net.layers:
        pad = -layer.weight.shape[0] % 4
        yield F.pad(layer.weight.t(), (0, pad))
        yield F.pad(layer.bias, (0, pad))


def _table(net: MLPHeadNet, offsets: tuple[int, ...]) -> tuple[int, ...]:
    """The launch's layer table (csrc/head_mlp.cu): the number of layers,
    C, then per layer its width, activation id and the starts of its
    weights and bias in the pack."""
    ints = [len(net.spec.layers), net.spec.in_features]
    for (width, act), w, b in zip(net.spec.layers, offsets[0::2],
                                  offsets[1::2]):
        ints += [width, activation_id(act), w, b]
    return tuple(ints)


def head_pack(net: MLPHeadNet) -> Packed:
    """`net`'s weights in one buffer on its device in the kernel's layout
    (`_kernel_leaves`), with the launch's layer table (`Packed.table`);
    both built once per module."""
    return packed(net, _kernel_leaves, table=_table)


def domain_error(net: MLPHeadNet) -> str | None:
    """Why the kernel does not take this head, or None when it does (at
    most MAX_LAYERS layers of at most MAX_WIDTH features).  The wrapper and
    `runtime.fused.head_route` both decide with it."""
    spec = net.spec
    widths = [w for w, _ in spec.layers]
    if len(widths) > MAX_LAYERS or max(widths + [spec.in_features]) > MAX_WIDTH:
        return (f"mlp_head_forward takes at most {MAX_LAYERS} layers of at "
                f"most {MAX_WIDTH} features, got {len(widths)} layers of up "
                f"to {max(widths + [spec.in_features])}")
    return None


def _check_input(net: MLPHeadNet, x: torch.Tensor) -> None:
    c = net.spec.in_features
    if x.ndim != 2 or x.shape[1] != c:
        raise ValueError(f"x must be (N, {c}), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")


@torch.no_grad()
def mlp_head_forward_plain(net: MLPHeadNet, x: torch.Tensor) -> torch.Tensor:
    """The chain in plain torch, layer by layer: product, bias, activation."""
    _check_input(net, x)
    h = x
    for layer, (_, act) in zip(net.layers, net.spec.layers):
        h = get_activation(act)(h @ layer.weight.t() + layer.bias)
    return h


@torch.no_grad()
def mlp_head_forward_cuda(net: MLPHeadNet, x: torch.Tensor) -> torch.Tensor:
    """The kernel: what `mlp_head_forward_plain` computes, on a CUDA device,
    one call of the op `headpose_tpu_torch::mlp_head` (ops/kernels/
    library.py).

    Launches on the current stream without synchronising.  Raises on
    anything the kernel does not take, and when the launch fails."""
    _check_input(net, x)
    if x.device.type != "cuda":
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if net.layers[0].weight.device != x.device:
        raise ValueError(f"net is on {net.layers[0].weight.device}, x on "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    problem = domain_error(net)
    if problem is not None:
        raise ValueError(problem)
    pack = head_pack(net)
    return lib.mlp_head(x, pack.weights, list(pack.table),
                        net.spec.layers[-1][0])


def mlp_head_forward(net: MLPHeadNet, x: torch.Tensor) -> torch.Tensor:
    """`net` over rows x (N, C): the CUDA kernel for a tensor on a CUDA
    device, the plain version for a tensor on the CPU."""
    if x.device.type == "cpu":
        return mlp_head_forward_plain(net, x)
    return mlp_head_forward_cuda(net, x)
