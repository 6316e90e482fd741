"""The SE-Transformer pose head on the card: wrapper of csrc/se_attention.cu.

`se_transformer_forward(net, x)` is the counterpart of the TPU kernel
headpose_tpu/ops/pallas/se_attention.py::se_transformer_forward: the whole
`SETransformerHead` (SE gate, multi-head attention over each image's H·W
tokens, residual + LayerNorm, FFN, residual + LayerNorm, ReLU 1x1, output
1x1) of `net` (an `SETransformerHeadNet`) over maps x (B, H, W, C) float32,
returning (B, H, W, out).  Rows (N, C) go in as (N, 1, 1, C) maps.  A tensor
on the CPU goes through `se_transformer_forward_plain`; a tensor on a CUDA
device goes through the hand-written kernel, or the call raises.  Nothing
else selects between the two.  The JAX function's `interpret` is a TPU knob
and has no counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...models.heads import SETransformerHeadNet
from . import library as lib
from .packing import Packed, packed
from .tf32 import matmul_3xtf32, split_tf32

__all__ = ["se_transformer_forward", "se_transformer_forward_plain",
           "se_transformer_forward_cuda", "se_pack", "split_tf32",
           "matmul_3xtf32", "domain_error", "LIBRARY"]

LIBRARY = lib.LIBRARIES["se_attention"]
SOURCE = LIBRARY.sources[0]
# the kernel's domain (csrc/se_attention.cu)
NUM_HEADS = (1, 2, 4, 8)
KEY_DIMS = (8, 16, 32)
MAX_HEAD_WIDTH = 64          # num_heads * key_dim
MAX_CHANNELS = 128
MAX_FF = MAX_HIDDEN = 256
MAX_OUT = 8


def _leaves(net: SETransformerHeadNet):
    """The weights as the JAX wrapper flattens them, in the order of
    csrc/se_attention.cu's `enum Leaf`: dense kernels (in, out), q/k/v
    (C, H·D), attn_out (H·D, C), then each bias or LayerNorm vector."""
    C = net.spec.in_features
    hd = net.spec.num_heads * net.spec.key_dim
    yield net.se.fc1.weight.t()
    yield net.se.fc1.bias
    yield net.se.fc2.weight.t()
    yield net.se.fc2.bias
    for proj in (net.query, net.key, net.value):
        yield proj.w.reshape(C, hd)
        yield proj.b.reshape(hd)
    yield net.attn_out.w.reshape(hd, C)
    yield net.attn_out.b
    yield net.ln1.g
    yield net.ln1.b
    for layer in (net.ff1, net.ff2):
        yield layer.weight.t()
        yield layer.bias
    yield net.ln2.g
    yield net.ln2.b
    for layer in (net.fc, net.out):
        yield layer.weight.t()
        yield layer.bias


# the leaves the kernel multiplies on the tensor cores, staged in tiles of
# TILE_N columns: q/k/v, attn_out, ff1, ff2, fc, out (csrc/se_attention.cu)
_TILED = (4, 6, 8, 10, 14, 16, 20, 22)
TILE_N = 32


def _kernel_leaves(net: SETransformerHeadNet):
    """`_leaves` in the kernel's layout: each tiled matrix (K, N) zero-padded
    to (K rounded up to 8, N rounded up to TILE_N), so that a tile is whole
    16-byte rows; every leaf then zero-padded to a multiple of 4 floats, so
    that each starts 16-byte aligned."""
    for i, leaf in enumerate(_leaves(net)):
        if i in _TILED:
            k, n = leaf.shape
            leaf = F.pad(leaf, (0, -n % TILE_N, 0, -k % 8))
        flat = leaf.reshape(-1)
        yield F.pad(flat, (0, -flat.numel() % 4))


def se_pack(net: SETransformerHeadNet) -> Packed:
    """`net`'s weights in one buffer on its device in the kernel's layout
    (`_kernel_leaves`; packed once per module)."""
    return packed(net, _kernel_leaves)


def domain_error(net: SETransformerHeadNet) -> str | None:
    """Why the kernel does not take this head, or None when it does.  The
    wrapper and `runtime.fused.head_route` both decide with it."""
    s = net.spec
    problems = []
    if s.num_heads not in NUM_HEADS:
        problems.append(f"num_heads {s.num_heads} not in {NUM_HEADS}")
    if s.key_dim not in KEY_DIMS:
        problems.append(f"key_dim {s.key_dim} not in {KEY_DIMS}")
    if s.num_heads * s.key_dim > MAX_HEAD_WIDTH:
        problems.append(f"num_heads * key_dim > {MAX_HEAD_WIDTH}")
    if s.in_features > MAX_CHANNELS or s.in_features // s.reduction < 1:
        problems.append(f"in_features {s.in_features} (at most "
                        f"{MAX_CHANNELS}, and at least the reduction)")
    if s.ff_dim > MAX_FF or s.hidden > MAX_HIDDEN or s.out_features > MAX_OUT:
        problems.append(f"ff_dim <= {MAX_FF}, hidden <= {MAX_HIDDEN} and "
                        f"out_features <= {MAX_OUT} are required")
    if problems:
        return ("se_transformer_forward does not take this head: "
                + "; ".join(problems))
    return None


def _check_domain(net: SETransformerHeadNet) -> None:
    """ValueError when the head lies outside the kernel's domain."""
    problem = domain_error(net)
    if problem is not None:
        raise ValueError(problem)


def _check_input(net: SETransformerHeadNet, x: torch.Tensor) -> None:
    c = net.spec.in_features
    if x.ndim != 4 or x.shape[-1] != c:
        raise ValueError(f"x must be (B, H, W, {c}), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32, got {x.dtype}")


def _layernorm(x, g, b, eps=1e-3):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _forward(net: SETransformerHeadNet, x: torch.Tensor, mm) -> torch.Tensor:
    """The TPU kernel's arithmetic with every product a @ b as mm(a, b):
    torch.matmul in the plain version; `matmul_3xtf32` emulates the
    kernel's tensor-core products (the SE gate's stay fp32, as in the
    kernel)."""
    _check_domain(net)
    _check_input(net, x)
    spec = net.spec
    B, Hs, Ws, C = x.shape
    H, D = spec.num_heads, spec.key_dim
    (se1w, se1b, se2w, se2b, qw, qb, kw, kb, vw, vb, ow, ob, ln1g, ln1b,
     f1w, f1b, f2w, f2b, ln2g, ln2b, fcw, fcb, outw, outb) = _leaves(net)
    tokens = x.reshape(B, Hs * Ws, C)
    pooled = tokens.mean(dim=1, keepdim=True)                   # (B, 1, C)
    s = torch.relu(pooled @ se1w + se1b)
    s = torch.sigmoid(s @ se2w + se2b)
    t = tokens * s
    q, k, v = mm(t, qw) + qb, mm(t, kw) + kb, mm(t, vw) + vb    # (B, T, H*D)
    inv_scale = 1.0 / torch.sqrt(torch.tensor(D, dtype=torch.float32))
    heads = []
    for h in range(H):
        sl = slice(h * D, (h + 1) * D)
        scores = mm(q[..., sl], k[..., sl].transpose(1, 2)) * inv_scale
        heads.append(mm(torch.softmax(scores, dim=-1), v[..., sl]))
    o = mm(torch.cat(heads, dim=-1), ow) + ob
    t1 = _layernorm(t + o, ln1g, ln1b)
    f = mm(torch.relu(mm(t1, f1w) + f1b), f2w) + f2b
    t2 = _layernorm(t1 + f, ln2g, ln2b)
    y = mm(torch.relu(mm(t2, fcw) + fcb), outw) + outb
    return y.reshape(B, Hs, Ws, spec.out_features)


@torch.no_grad()
def se_transformer_forward_plain(net: SETransformerHeadNet,
                                 x: torch.Tensor) -> torch.Tensor:
    """The TPU kernel's arithmetic in plain torch, step by step, every image
    of the batch at once: token mean and gate, the flattened q/k/v
    products, each head's softmax attention, the output projection, the
    tail.  It does not call `SETransformerHeadNet.forward`."""
    return _forward(net, x, torch.matmul)


@torch.no_grad()
def se_transformer_forward_cuda(net: SETransformerHeadNet,
                                x: torch.Tensor) -> torch.Tensor:
    """The kernel: what `se_transformer_forward_plain` computes, on a CUDA
    device, one call of the op `headpose_tpu_torch::se_transformer`
    (ops/kernels/library.py): three launches (the gates; K/V; attention
    and the tail) on the current stream, or one for 1x1 maps (T = 1: no
    attention to compute), without synchronising.  Raises on anything the kernel does not take,
    and when a launch fails."""
    _check_domain(net)
    _check_input(net, x)
    if x.device.type != "cuda":
        raise ValueError(f"x must be on a CUDA device, got {x.device}")
    if net.query.w.device != x.device:
        raise ValueError(f"net is on {net.query.w.device}, x on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    spec = net.spec
    pack = se_pack(net)
    C = spec.in_features
    dims = [C, C // spec.reduction, spec.num_heads, spec.key_dim,
            spec.ff_dim, spec.hidden, spec.out_features]
    return lib.se_transformer(x, pack.weights, dims, list(pack.offsets))


def se_transformer_forward(net: SETransformerHeadNet,
                           x: torch.Tensor) -> torch.Tensor:
    """`net` over maps x (B, H, W, C): the CUDA kernel for a tensor on a
    CUDA device, the plain version for a tensor on the CPU.

    `se_transformer_forward.launches` counts the calls that launched the
    kernel (one per call: its three launches, or the one for T = 1)."""
    if x.device.type == "cpu":
        return se_transformer_forward_plain(net, x)
    return se_transformer_forward_cuda(net, x)


se_transformer_forward = lib.Counted(se_transformer_forward,
                                     "se_transformer")
