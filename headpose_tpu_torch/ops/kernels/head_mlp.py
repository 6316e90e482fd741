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

import ctypes
import os

import torch

from ...core.activations import activation_id, get_activation
from ...models.heads import MLPHeadNet
from ...utils.build import NVCC_FLAGS_FMA, CudaLibrary
from .packing import Packed, c_ints, packed

__all__ = ["mlp_head_forward", "mlp_head_forward_plain",
           "mlp_head_forward_cuda", "head_pack", "domain_error", "LIBRARY"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "head_mlp.cu")
MAX_LAYERS = 8
MAX_WIDTH = 896      # 2 buffers x 32 rows x 896 floats fill 227 KB


def _configure(lib: ctypes.CDLL) -> None:
    fn = lib.headpose_mlp_head
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 5)
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("head_mlp", [SOURCE], _configure, NVCC_FLAGS_FMA)


def _leaves(net: MLPHeadNet):
    """Per layer: the weights (in, out), then the bias (out,)."""
    for layer in net.layers:
        yield layer.weight.t()
        yield layer.bias


def head_pack(net: MLPHeadNet) -> Packed:
    """`net`'s weights in one buffer on its device (packed once per module)."""
    return packed(net, _leaves)


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
    """The kernel: what `mlp_head_forward_plain` computes, on a CUDA device.

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
    spec = net.spec
    widths = [w for w, _ in spec.layers]
    acts = [activation_id(a) for _, a in spec.layers]
    n = x.shape[0]
    out = x.new_empty((n, widths[-1]))
    if n == 0:
        return out
    pack = head_pack(net)
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        err = lib.headpose_mlp_head(
            x.data_ptr(), pack.weights.data_ptr(), out.data_ptr(), n,
            spec.in_features, len(widths), c_ints(widths), c_ints(acts),
            c_ints(pack.offsets[0::2]), c_ints(pack.offsets[1::2]),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mlp_head kernel launch failed: "
                           f"{'unsupported head' if err < 0 else 'CUDA error'}"
                           f" ({err})")
    mlp_head_forward.launches += 1
    return out


def mlp_head_forward(net: MLPHeadNet, x: torch.Tensor) -> torch.Tensor:
    """`net` over rows x (N, C): the CUDA kernel for a tensor on a CUDA
    device, the plain version for a tensor on the CPU.

    `mlp_head_forward.launches` counts the kernel's launches."""
    if x.device.type == "cpu":
        return mlp_head_forward_plain(net, x)
    return mlp_head_forward_cuda(net, x)


mlp_head_forward.launches = 0
