"""Pose-regression heads, PyTorch edition.

Port of headpose_tpu/models/heads.py.  The reference defines its heads as
stacks of 1x1 convolutions; a 1x1 conv over an HxW map is a matmul over the
channel axis, so every head module serves both per-face vectors (N, C) and
whole NHWC feature maps (B, H, W, C).

Training support, as the JAX package has it: `spec.init(generator)` draws
fresh parameters in JAX layout (Glorot-uniform kernels, zero biases, from an
explicit `torch.Generator`); `module(x, generator)` is train mode, where
the heads with a `dropout_rate` drop whole channels after the layers JAX
drops them after (the generator draws the masks); `module.l2_penalty(rate)`
is the Keras regularization term each family adds to the loss.

Families (spec → module):
  MLPHead            MLPHeadNet            dense chain
  ResidualMLPHead    ResidualMLPHeadNet    projection, residual blocks,
                                           bottleneck, linear out
  SkipMLPHead        SkipMLPHeadNet        encoder/decoder with one skip add
  SEMLPHead          SEMLPHeadNet          SE channel gate + 1x1 head
  SETransformerHead  SETransformerHeadNet  SE gate + one Transformer encoder
                                           block over the map's tokens +
                                           1x1 head
  EnsembleHead       EnsembleHeadNet       average or stack of members

`spatial_context` says whether a head couples the cells of a map (the SE
gate pools over them; the Transformer attends across them): such a head
computes another function on a map than on each cell's vector, and
`FaceDetector(head_eval="auto")` serves it on the survivors' vectors.

Dense layers are `nn.Linear` (weights (out, in)); the SE-Transformer's
attention weights keep the JAX layout ((C, H, D), (H, D), (H, D, C)), which
the weight bridge (models/params.py) carries over as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
from torch import nn

from ..core.activations import get_activation
from ..core.single_pass import einsum, linear
from ..utils.device import local_part, resolve_device
from ..utils.weights import stamp

__all__ = ["MLPHead", "ResidualMLPHead", "SkipMLPHead", "SEMLPHead",
           "SETransformerHead", "EnsembleHead", "HEAD_REGISTRY", "MLPHeadNet",
           "ResidualMLPHeadNet", "SkipMLPHeadNet", "SEMLPHeadNet",
           "SETransformerHeadNet", "EnsembleHeadNet", "head_net",
           "head_from_h5", "head_from_keras_json", "se_transformer_from_h5",
           "mlp_head_from_modeldef"]


Params = dict[str, Any]


# -------------------------------------------------------------------- init
def _uniform(generator: torch.Generator, shape: tuple[int, ...],
             limit: float) -> np.ndarray:
    return torch.empty(shape, dtype=torch.float32).uniform_(
        -limit, limit, generator=generator).numpy()


def _glorot(generator: torch.Generator, cin: int, cout: int) -> np.ndarray:
    return _uniform(generator, (cin, cout), math.sqrt(6.0 / (cin + cout)))


def _dense_init(generator: torch.Generator, cin: int, cout: int) -> Params:
    return {"w": _glorot(generator, cin, cout),
            "b": np.zeros((cout,), np.float32)}


def _se_init(generator: torch.Generator, channels: int,
             reduction: int) -> Params:
    mid = channels // reduction
    return {"fc1": _dense_init(generator, channels, mid),
            "fc2": _dense_init(generator, mid, channels)}


def _spatial_dropout(x: torch.Tensor, rate: float,
                     generator: torch.Generator | None) -> torch.Tensor:
    """SpatialDropout2D over (..., C), as JAX's `_spatial_dropout`: each
    leading row keeps or drops whole channels (keep probability 1 - rate),
    the kept ones scaled by 1/keep.  No generator (inference): identity."""
    if generator is None or rate <= 0.0:
        return x
    keep = 1.0 - rate
    if isinstance(generator, RowWindow):
        # x holds rows [start, stop) of the batch the masks are drawn for
        shape = (generator.rows,) + (1,) * (x.ndim - 2) + (x.shape[-1],)
        mask = torch.rand(shape, generator=generator.generator,
                          device=x.device)[generator.start:generator.stop]
        return torch.where(mask < keep, x / keep, 0.0)
    shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
    if _is_dtensor(x):
        return _sharded_dropout(x, shape, keep, generator)
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


@dataclasses.dataclass(frozen=True)
class RowWindow:
    """Train-mode randomness for rows [start, stop) of a batch of `rows`:
    the dropout masks are drawn from `generator` for the whole batch and
    cut to the window, so a data-parallel rank draws its rows of the masks
    that one process draws for the batch (train/loop.py's fit(mesh=))."""
    generator: torch.Generator
    start: int
    stop: int
    rows: int


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _sharded_dropout(x, shape, keep: float, generator: torch.Generator):
    """Dropout of a DTensor activation (tensor parallelism): the masks of
    the unsharded batch are drawn on every rank from the same generator,
    and each rank keeps its part under x's placements, so the sharded step
    drops what the unsharded one drops.  DTensor's own random ops do not
    draw from a given generator."""
    from torch.distributed.tensor import DTensor

    full =(torch.rand(shape, generator=generator,
                       device=x.to_local().device) < keep).expand(x.shape)
    mask = DTensor.from_local(
        local_part(full, x.device_mesh, x.placements).contiguous(),
        x.device_mesh, x.placements, run_check=False)
    return torch.where(mask, x / keep, 0.0)


def _squares(tensors) -> torch.Tensor:
    return sum(t.square().sum() for t in tensors)


# ------------------------------------------------------------------- specs
@dataclasses.dataclass(frozen=True)
class MLPHead:
    """A chain of (features, activation) dense layers over the channel axis.

    E.g. the production reg2 head hrchr82r is
    ``MLPHead(96, ((32, 'tanh'), (16, 'tanh'), (3, 'linear')))`` and reg1
    stoqa9pt is ``MLPHead(88, ((64, 'softsign'), (3, 'linear')))``.
    """

    in_features: int
    layers: tuple[tuple[int, str], ...]
    dropout_rate: float = 0.0  # after every layer, train mode only

    spatial_context = False    # per cell

    def init(self, generator: torch.Generator) -> Params:
        layers, cin = [], self.in_features
        for cout, _ in self.layers:
            layers.append(_dense_init(generator, cin, cout))
            cin = cout
        return {"layers": layers}


@dataclasses.dataclass(frozen=True)
class ResidualMLPHead:
    """Projection → N residual (2-layer) blocks with relu after the add →
    bottleneck → linear output."""

    in_features: int = 88
    width: int = 16
    num_blocks: int = 3
    bottleneck: int = 8
    out_features: int = 3
    activation: str = "softsign"
    dropout_rate: float = 0.0

    spatial_context = False

    def init(self, generator: torch.Generator) -> Params:
        params: Params = {"proj": _dense_init(generator, self.in_features,
                                              self.width)}
        params["blocks"] = [
            {"fc1": _dense_init(generator, self.width, self.width),
             "fc2": _dense_init(generator, self.width, self.width)}
            for _ in range(self.num_blocks)]
        params["bottleneck"] = _dense_init(generator, self.width,
                                           self.bottleneck)
        params["out"] = _dense_init(generator, self.bottleneck,
                                    self.out_features)
        return params


@dataclasses.dataclass(frozen=True)
class SkipMLPHead:
    """enc1 → enc2 → dec, plus enc1's output (the skip) → linear output."""

    in_features: int = 88
    enc1: int = 32
    enc2: int = 64
    out_features: int = 3
    activation: str = "softsign"
    dropout_rate: float = 0.0

    spatial_context = False

    def init(self, generator: torch.Generator) -> Params:
        return {"enc1": _dense_init(generator, self.in_features, self.enc1),
                "enc2": _dense_init(generator, self.enc1, self.enc2),
                "dec": _dense_init(generator, self.enc2, self.enc1),
                "out": _dense_init(generator, self.enc1, self.out_features)}


@dataclasses.dataclass(frozen=True)
class SEMLPHead:
    """SE gate + 1x1-conv head.  On a map the gate pools over all cells."""

    in_features: int = 88
    reduction: int = 8
    hidden: int = 42
    out_features: int = 3

    spatial_context = True

    def init(self, generator: torch.Generator) -> Params:
        return {"se": _se_init(generator, self.in_features, self.reduction),
                "fc": _dense_init(generator, self.in_features, self.hidden),
                "out": _dense_init(generator, self.hidden,
                                   self.out_features)}


@dataclasses.dataclass(frozen=True)
class SETransformerHead:
    """SE gating + one Transformer encoder block over spatial tokens + a
    ReLU 1x1 and the output 1x1.  Kernel: ops.kernels.se_attention."""

    in_features: int = 88
    reduction: int = 16
    num_heads: int = 4
    key_dim: int = 16
    ff_dim: int = 64
    hidden: int = 128
    out_features: int = 3

    spatial_context = True

    def init(self, generator: torch.Generator) -> Params:
        C, H, D = self.in_features, self.num_heads, self.key_dim
        lim_qkv = math.sqrt(6.0 / (C + H * D))
        lim_out = math.sqrt(6.0 / (H * D + C))
        params: Params = {"se": _se_init(generator, C, self.reduction)}
        for name in ("query", "key", "value"):
            params[name] = {"w": _uniform(generator, (C, H, D), lim_qkv),
                            "b": np.zeros((H, D), np.float32)}
        params["attn_out"] = {"w": _uniform(generator, (H, D, C), lim_out),
                              "b": np.zeros((C,), np.float32)}

        def layer_norm():
            return {"g": np.ones((C,), np.float32),
                    "b": np.zeros((C,), np.float32)}

        params["ln1"] = layer_norm()
        params["ff1"] = _dense_init(generator, C, self.ff_dim)
        params["ff2"] = _dense_init(generator, self.ff_dim, C)
        params["ln2"] = layer_norm()
        params["fc"] = _dense_init(generator, C, self.hidden)
        params["out"] = _dense_init(generator, self.hidden, self.out_features)
        return params


@dataclasses.dataclass(frozen=True)
class EnsembleHead:
    """K member heads combined: a uniform average, or with `weights` (K rows
    of (yaw, pitch, roll)) and `bias` the stack
    ``sum_k weights[k] * member_k(x) + bias``."""

    members: tuple[Any, ...]
    weights: tuple[tuple[float, float, float], ...] | None = None
    bias: tuple[float, float, float] | None = None

    def __post_init__(self):
        if not self.members:
            raise ValueError("EnsembleHead needs at least one member")
        feats = {m.in_features for m in self.members}
        if len(feats) != 1:
            raise ValueError(f"members disagree on in_features: "
                             f"{sorted(feats)}")
        if self.weights is not None:
            if len(self.weights) != len(self.members):
                raise ValueError(
                    f"{len(self.weights)} weight rows for "
                    f"{len(self.members)} members")
            if any(len(w) != 3 for w in self.weights):
                raise ValueError("each weight row must be (yaw, pitch, roll)")
        if self.bias is not None:
            if self.weights is None:
                raise ValueError("bias requires weights (a stacked ensemble)")
            if len(self.bias) != 3:
                raise ValueError("bias must be (yaw, pitch, roll)")

    @property
    def in_features(self) -> int:
        return self.members[0].in_features

    @property
    def spatial_context(self) -> bool:
        """True when any member couples the cells of a map; a member
        without the attribute counts as spatial, as in the JAX package."""
        return any(getattr(m, "spatial_context", True) for m in self.members)

    def init(self, generator: torch.Generator) -> Params:
        return {"members": [m.init(generator) for m in self.members]}


HEAD_REGISTRY = {"mlp": MLPHead, "residual_mlp": ResidualMLPHead,
                 "skip_mlp": SkipMLPHead, "se_mlp": SEMLPHead,
                 "se_transformer": SETransformerHead,
                 "ensemble": EnsembleHead}


# ----------------------------------------------------------------- modules
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

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, *,
                single_pass: bool = False) -> torch.Tensor:
        """`generator` turns train-mode dropout on: after every layer, the
        linear output layer included, as JAX's `MLPHead.apply`.
        `single_pass` runs every product at single-pass bf16 (every head
        family takes it; core/single_pass.py)."""
        for layer, act in zip(self.layers, self._acts):
            x = _spatial_dropout(act(linear(layer, x, single_pass)),
                                 self.spec.dropout_rate, generator)
        return x

    def l2_penalty(self, rate: float):
        """Keras l2 on every kernel and bias, a loss term."""
        if rate == 0.0:
            return 0.0
        return rate * _squares(t for layer in self.layers
                               for t in (layer.weight, layer.bias))


class ResidualMLPHeadNet(nn.Module):
    def __init__(self, spec: ResidualMLPHead, *,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        w = spec.width
        self.proj = nn.Linear(spec.in_features, w, device=device)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"fc1": nn.Linear(w, w, device=device),
                           "fc2": nn.Linear(w, w, device=device)})
            for _ in range(spec.num_blocks))
        self.bottleneck = nn.Linear(w, spec.bottleneck, device=device)
        self.out = nn.Linear(spec.bottleneck, spec.out_features, device=device)
        self._act = get_activation(spec.activation)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, *,
                single_pass: bool = False) -> torch.Tensor:
        """Train-mode dropout (a generator) after the projection, each
        block's two layers and the bottleneck, as JAX's."""
        act, rate = self._act, self.spec.dropout_rate

        def drop(v):
            return _spatial_dropout(v, rate, generator)

        def dense(layer, v):
            return linear(layer, v, single_pass)

        x = drop(act(dense(self.proj, x)))
        for blk in self.blocks:
            y = drop(act(dense(blk["fc1"], x)))
            y = drop(act(dense(blk["fc2"], y)))
            x = torch.relu(x + y)
        return dense(self.out, drop(act(dense(self.bottleneck, x))))

    def l2_penalty(self, rate: float):
        """Kernels only, as the reference regularizes this family."""
        if rate == 0.0:
            return 0.0
        layers = [self.proj, self.bottleneck, self.out]
        layers += [blk[k] for blk in self.blocks for k in ("fc1", "fc2")]
        return rate * _squares(layer.weight for layer in layers)


class SkipMLPHeadNet(nn.Module):
    def __init__(self, spec: SkipMLPHead, *,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.enc1 = nn.Linear(spec.in_features, spec.enc1, device=device)
        self.enc2 = nn.Linear(spec.enc1, spec.enc2, device=device)
        self.dec = nn.Linear(spec.enc2, spec.enc1, device=device)
        self.out = nn.Linear(spec.enc1, spec.out_features, device=device)
        self._act = get_activation(spec.activation)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, *,
                single_pass: bool = False) -> torch.Tensor:
        """Train-mode dropout (a generator) after enc1, enc2 and the skip
        add, as JAX's."""
        act, rate = self._act, self.spec.dropout_rate

        def drop(v):
            return _spatial_dropout(v, rate, generator)

        def dense(layer, v):
            return linear(layer, v, single_pass)

        x1 = drop(act(dense(self.enc1, x)))
        x2 = drop(act(dense(self.enc2, x1)))
        return dense(self.out, drop(act(dense(self.dec, x2)) + x1))

    def l2_penalty(self, rate: float):
        """Kernels only, as the reference regularizes this family."""
        if rate == 0.0:
            return 0.0
        return rate * _squares(getattr(self, k).weight
                               for k in ("enc1", "enc2", "dec", "out"))


class _SqueezeExcite(nn.Module):
    """Squeeze-and-excitation over the channel axis.  x is (B, H, W, C) or
    (N, C); the squeeze averages every axis but the first and the last (a
    row is its own squeeze)."""

    def __init__(self, channels: int, reduction: int, device: torch.device):
        super().__init__()
        mid = channels // reduction
        self.fc1 = nn.Linear(channels, mid, device=device)
        self.fc2 = nn.Linear(mid, channels, device=device)

    def forward(self, x: torch.Tensor,
                single_pass: bool = False) -> torch.Tensor:
        axes = tuple(range(1, x.ndim - 1))
        s = x.mean(dim=axes) if axes else x
        s = torch.relu(linear(self.fc1, s, single_pass))
        s = torch.sigmoid(linear(self.fc2, s, single_pass))
        return x * s.reshape(s.shape[:1] + (1,) * len(axes) + s.shape[-1:])


class SEMLPHeadNet(nn.Module):
    def __init__(self, spec: SEMLPHead, *,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.se = _SqueezeExcite(spec.in_features, spec.reduction, device)
        self.fc = nn.Linear(spec.in_features, spec.hidden, device=device)
        self.out = nn.Linear(spec.hidden, spec.out_features, device=device)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, *,
                single_pass: bool = False) -> torch.Tensor:
        """No dropout in this family: train mode is inference."""
        y = torch.relu(linear(self.fc, self.se(x, single_pass), single_pass))
        return linear(self.out, y, single_pass)

    def l2_penalty(self, rate: float):
        return 0.0


class _Weights(nn.Module):
    """A weight `w` and bias `b` kept in the JAX layout."""

    def __init__(self, w_shape: tuple[int, ...], b_shape: tuple[int, ...],
                 device: torch.device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(w_shape, device=device))
        self.b = nn.Parameter(torch.zeros(b_shape, device=device))


class _LayerNorm(nn.Module):
    """Keras LayerNormalization over the last axis: gain `g`, offset `b`."""

    EPS = 1e-3   # Keras's default epsilon

    def __init__(self, channels: int, device: torch.device):
        super().__init__()
        self.g = nn.Parameter(torch.ones(channels, device=device))
        self.b = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + self.EPS) * self.g + self.b


class SETransformerHeadNet(nn.Module):
    """`SETransformerHead.apply` in explicit torch ops.  Takes (B, H, W, C)
    maps (H·W tokens per image) and (N, C) rows (each a 1x1 map)."""

    def __init__(self, spec: SETransformerHead, *,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        C, H, D = spec.in_features, spec.num_heads, spec.key_dim
        self.se = _SqueezeExcite(C, spec.reduction, device)
        self.query = _Weights((C, H, D), (H, D), device)
        self.key = _Weights((C, H, D), (H, D), device)
        self.value = _Weights((C, H, D), (H, D), device)
        self.attn_out = _Weights((H, D, C), (C,), device)
        self.ln1 = _LayerNorm(C, device)
        self.ff1 = nn.Linear(C, spec.ff_dim, device=device)
        self.ff2 = nn.Linear(spec.ff_dim, C, device=device)
        self.ln2 = _LayerNorm(C, device)
        self.fc = nn.Linear(C, spec.hidden, device=device)
        self.out = nn.Linear(spec.hidden, spec.out_features, device=device)

    def l2_penalty(self, rate: float):
        return 0.0

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, *,
                single_pass: bool = False) -> torch.Tensor:
        """No dropout in this family: train mode is inference.
        `single_pass` rounds the operands of every product, attention's
        Q·Kᵀ and P·V included; the softmax and the layer norms stay fp32."""
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, None, :]
        B, H, W, C = x.shape
        t = self.se(x, single_pass).reshape(B, H * W, C)
        if _is_dtensor(self.query.w):
            o = self._sharded_attention(t, single_pass)
        else:
            o = self._attention(t, self.query.w, self.query.b, self.key.w,
                                self.key.b, self.value.w, self.value.b,
                                self.attn_out.w, single_pass)
        t = self.ln1(t + (o + self.attn_out.b))

        def dense(layer, v):
            return linear(layer, v, single_pass)

        t = self.ln2(t + dense(self.ff2, torch.relu(dense(self.ff1, t))))
        y = dense(self.out, torch.relu(dense(self.fc,
                                             t.reshape(B, H, W, C))))
        return y[:, 0, 0, :] if squeeze else y

    def _attention(self, t, wq, bq, wk, bk, wv, bv, wo,
                   single_pass: bool = False):
        """Multi-head attention of tokens t (B, T, C) up to the output
        projection's bias, over the heads of the weights given."""
        def product(equation, a, b):
            return einsum(equation, a, b, single_pass)

        q = product("btc,chd->bthd", t, wq) + bq
        k = product("bsc,chd->bshd", t, wk) + bk
        v = product("bsc,chd->bshd", t, wv) + bv
        scores = product("bthd,bshd->bhts", q, k) / math.sqrt(
            self.spec.key_dim)
        o = product("bhts,bshd->bthd", torch.softmax(scores, dim=-1), v)
        return product("bthd,hdc->btc", o, wo)

    def _sharded_attention(self, t, single_pass: bool = False):
        """`_attention` under tensor parallelism (parallel.shard_head_params):
        heads are independent, so each rank attends over its own heads on
        its local tensors, and its output projection is that rank's part
        of the sum over heads (Partial on the mesh's 'model' dimension),
        summed over the ranks (an all-reduce).  The weights' placements say
        where the heads are sharded; replicated weights make every rank
        compute the whole sum."""
        from torch.distributed.tensor import DTensor, Partial, Shard

        mesh = self.query.w.device_mesh
        heads = [isinstance(p, Shard) for p in self.query.w.placements]
        rows = [isinstance(p, Shard) for p in t.placements]
        # t's gradient from each rank's heads is a partial sum, and so is
        # a weight's from each rank's rows
        grad = [Partial() if h else p for h, p in zip(heads, t.placements)]

        def local(w):
            return w.to_local(grad_placements=[
                Partial() if r else p for r, p in zip(rows, w.placements)])

        o = self._attention(
            t.to_local(grad_placements=grad),
            *(local(w) for w in (
                self.query.w, self.query.b, self.key.w, self.key.b,
                self.value.w, self.value.b, self.attn_out.w)),
            single_pass)
        o = DTensor.from_local(o, mesh, grad, run_check=False)
        return o.redistribute(mesh, t.placements)    # the sum over heads


class EnsembleHeadNet(nn.Module):
    """The members of an `EnsembleHead`, combined as the JAX package
    combines them.  Inference (`EnsembleHead._apply_grouped`): members with
    equal specs are evaluated together, as one `torch.func.vmap` over their
    stacked weights (batched products), and the groups are summed in the
    order they first appear.  Train mode (a generator): the members one
    after another, each drawing its own dropout masks, as JAX's training
    path.  Then the sum is divided by K, or weighted per member and angle
    and offset by the bias.  Both paths carry gradients to every member."""

    def __init__(self, spec: EnsembleHead, *,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.spec = spec
        self.members = nn.ModuleList(head_net(m, device=device)
                                     for m in spec.members)
        reps: list[Any] = []
        self.groups: list[list[int]] = []
        for i, m in enumerate(spec.members):
            for j, r in enumerate(reps):
                if m == r:
                    self.groups[j].append(i)
                    break
            else:
                reps.append(m)
                self.groups.append([i])
        weights = (torch.tensor(spec.weights, dtype=torch.float32,
                                device=device)
                   if spec.weights is not None else None)
        bias = (torch.tensor(spec.bias, dtype=torch.float32, device=device)
                if spec.bias is not None else None)
        self.register_buffer("_weights", weights, persistent=False)
        self.register_buffer("_bias", bias, persistent=False)
        self._stacks: tuple[tuple, list] | None = None

    def _stack(self, idx: list[int]):
        """(params, buffers) of the group's members stacked along a new
        first axis; differentiable, so gradients reach each member."""
        mods = [self.members[i] for i in idx]
        return tuple({name: torch.stack([dict(getter(m))[name]
                                         for m in mods])
                      for name, _ in getter(mods[0])}
                     for getter in (nn.Module.named_parameters,
                                    nn.Module.named_buffers))

    def _stacked(self) -> list:
        """Per group: its members' weights stacked (None for a group of
        one); kept without gradients until a parameter changes."""
        current = stamp(self)
        if self._stacks is None or self._stacks[0] != current:
            with torch.no_grad():
                stacks = [self._stack(idx) if len(idx) > 1 else None
                          for idx in self.groups]
            self._stacks = (current, stacks)
        return self._stacks[1]

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, *,
                single_pass: bool = False) -> torch.Tensor:
        """`single_pass` goes to every member; the combination (the
        weights' products with the members' poses, the sums) is
        elementwise and stays fp32."""
        if generator is not None:
            acc = None
            for i, member in enumerate(self.members):
                y = member(x, generator, single_pass=single_pass)
                if self._weights is not None:
                    y = y * self._weights[i]
                acc = y if acc is None else acc + y
        else:
            acc = self._grouped(x, single_pass)
        if self._weights is None:
            return acc / len(self.members)
        if self._bias is not None:
            acc = acc + self._bias
        return acc

    def _grouped(self, x: torch.Tensor, single_pass: bool) -> torch.Tensor:
        grad = torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters())
        stacks = ([self._stack(idx) if len(idx) > 1 else None
                   for idx in self.groups] if grad else self._stacked())
        acc = None
        for idx, stack in zip(self.groups, stacks):
            first = self.members[idx[0]]
            w = self._weights[idx] if self._weights is not None else None
            if stack is None:
                y = first(x, single_pass=single_pass)
                if w is not None:
                    y = y * w[0]
            else:
                def member(params, buffers, rows, module=first):
                    return torch.func.functional_call(
                        module, (params, buffers), (rows,),
                        {"single_pass": single_pass})

                ys = torch.func.vmap(member, in_dims=(0, 0, None))(
                    *stack, x)                                # (k, ..., 3)
                if w is not None:
                    ys = ys * w.reshape((len(idx),) + (1,) * (ys.ndim - 2)
                                        + (3,))
                y = ys.sum(dim=0)
            acc = y if acc is None else acc + y
        return acc

    def l2_penalty(self, rate: float):
        if rate == 0.0:
            return 0.0
        return sum(m.l2_penalty(rate) for m in self.members)


_HEAD_NETS = {MLPHead: MLPHeadNet, ResidualMLPHead: ResidualMLPHeadNet,
              SkipMLPHead: SkipMLPHeadNet, SEMLPHead: SEMLPHeadNet,
              SETransformerHead: SETransformerHeadNet,
              EnsembleHead: EnsembleHeadNet}


def head_net(spec: Any, *, device: str | torch.device | None = None
             ) -> nn.Module:
    """The module of a head spec (any family above, or a spec that builds
    its own module, as `core.graph.TrainableGraphHead` does)."""
    if hasattr(spec, "make_net"):
        return spec.make_net(device=device)
    try:
        cls = _HEAD_NETS[type(spec)]
    except KeyError:
        raise NotImplementedError(f"head type {type(spec).__name__} is not "
                                  "ported") from None
    return cls(spec, device=device)


# ----------------------------------------------------------------------
# Import the reference's shipped heads (Keras H5, Keras JSON)
# ----------------------------------------------------------------------
def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _in_features(config: dict) -> int:
    return int((config.get("batch_input_shape")
                or config["batch_shape"])[-1])


def head_from_h5(path) -> tuple[MLPHead, Params]:
    """A reference 1x1-conv-chain head H5 (a path, or a ModelDef parsed
    already) as an MLPHead: Conv2D(1x1) or Dense chains with optional
    dropout, Flatten and Reshape, in any input-shape variant.  Any other
    architecture raises ValueError (load it through core.load_graph_model
    instead)."""
    from ..core.h5io import _as_modeldef

    return mlp_head_from_modeldef(_as_modeldef(path))


def head_from_keras_json(path: str, generator: torch.Generator | None = None
                         ) -> tuple[MLPHead, Params]:
    """Architecture-only import of a Keras model.json (the reference's
    load_model_from_json): the equivalent MLPHead spec with fresh
    Glorot-uniform params drawn from `generator` (default: seed 0)."""
    import json

    with open(path) as f:
        cfg = json.load(f)
    in_features = None
    layers: list[tuple[int, str]] = []
    dropout = 0.0
    for l in cfg["config"]["layers"]:
        cls, c = l["class_name"], l.get("config", {})
        if cls == "InputLayer":
            in_features = _in_features(c)
        elif cls == "Conv2D":
            layers.append((int(c["filters"]), c.get("activation") or "linear"))
        elif cls == "Dense":
            layers.append((int(c["units"]), c.get("activation") or "linear"))
        elif cls == "SpatialDropout2D":
            dropout = max(dropout, float(c.get("rate", 0.0)))
        elif cls in ("Dropout", "Flatten", "Reshape"):
            continue
        else:
            raise ValueError(f"{path}: layer {cls} is not part of an MLP chain")
    if in_features is None:
        raise ValueError(f"{path}: no InputLayer found")
    spec = MLPHead(in_features=in_features, layers=tuple(layers),
                   dropout_rate=dropout)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return spec, spec.init(generator)


def se_transformer_from_h5(path) -> tuple[SETransformerHead, Params]:
    """A reference SE-Transformer head H5 (a path, or a ModelDef parsed
    already) as an SETransformerHead: the weights are read directly, and
    the head's reshapes replace the flatten/unflatten Lambdas.  The SE
    reduction is inferred from the squeeze width (in_features // width), so
    a width that does not divide the channels gives the spec another
    `reduction` with the same function, as in the JAX import."""
    from ..core.h5io import _as_modeldef

    md = _as_modeldef(path)
    dense, convs, lns, mha = [], [], [], None
    in_features = None
    for name in md.order:
        layer = md.layers[name]
        cls = layer.class_name
        if cls == "InputLayer":
            in_features = _in_features(layer.config)
        elif cls == "Dense":
            dense.append((layer.weights["kernel"], layer.weights["bias"],
                          layer.config.get("activation")))
        elif cls == "Conv2D":
            convs.append((np.asarray(layer.weights["kernel"])[0, 0],
                          layer.weights["bias"]))
        elif cls == "LayerNormalization":
            lns.append((layer.weights["gamma"], layer.weights["beta"]))
        elif cls == "MultiHeadAttention":
            mha = layer.weights
    if mha is None or len(dense) != 4 or len(convs) != 2 or len(lns) != 2:
        raise ValueError(f"{path}: not an SE-Transformer head "
                         f"(dense={len(dense)}, convs={len(convs)}, "
                         f"lns={len(lns)})")
    if in_features is None:
        raise ValueError(f"{path}: no InputLayer — cannot infer in_features")
    _, heads, key_dim = np.asarray(mha["query/kernel"]).shape  # (C, H, D)
    se1, se2, ff1, ff2 = dense
    spec = SETransformerHead(
        in_features=in_features, reduction=in_features // se1[0].shape[1],
        num_heads=heads, key_dim=key_dim, ff_dim=ff1[0].shape[1],
        hidden=convs[0][0].shape[1], out_features=convs[1][0].shape[1])

    def dn(w, b):
        return {"w": _f32(w), "b": _f32(b)}

    params: Params = {
        "se": {"fc1": dn(se1[0], se1[1]), "fc2": dn(se2[0], se2[1])},
        "query": dn(mha["query/kernel"], mha["query/bias"]),
        "key": dn(mha["key/kernel"], mha["key/bias"]),
        "value": dn(mha["value/kernel"], mha["value/bias"]),
        "attn_out": dn(mha["attention_output/kernel"],
                       mha["attention_output/bias"]),
        "ln1": {"g": _f32(lns[0][0]), "b": _f32(lns[0][1])},
        "ff1": dn(ff1[0], ff1[1]),
        "ff2": dn(ff2[0], ff2[1]),
        "ln2": {"g": _f32(lns[1][0]), "b": _f32(lns[1][1])},
        "fc": dn(*convs[0]),
        "out": dn(*convs[1]),
    }
    return spec, params


def mlp_head_from_modeldef(md) -> tuple[MLPHead, Params]:
    """A parsed 1x1-conv-chain ModelDef (a nested submodel of a unified
    model too) → (MLPHead spec, params in JAX layout)."""
    path = md.name
    layers: list[tuple[int, str]] = []
    params: list[Params] = []
    in_features = None
    for name in md.order:
        layer = md.layers[name]
        cls = layer.class_name
        if cls == "InputLayer":
            shape = (layer.config.get("batch_input_shape")
                     or layer.config.get("batch_shape"))
            in_features = int(shape[-1])
        elif cls == "Conv2D":
            k = np.asarray(layer.weights["kernel"])
            if k.shape[0] != 1 or k.shape[1] != 1:
                raise ValueError(f"{path}: non-1x1 conv in head ({k.shape})")
            params.append({"w": _f32(k[0, 0]),
                           "b": _f32(layer.weights["bias"])})
            layers.append((k.shape[-1],
                           layer.config.get("activation") or "linear"))
        elif cls == "Dense":
            params.append({"w": _f32(layer.weights["kernel"]),
                           "b": _f32(layer.weights["bias"])})
            layers.append((params[-1]["w"].shape[-1],
                           layer.config.get("activation") or "linear"))
        elif cls in ("SpatialDropout2D", "Dropout", "Flatten", "Reshape"):
            continue  # identity at inference / shape bookkeeping only
        else:
            raise ValueError(f"{path}: layer {cls} is not part of an MLP "
                             "chain")
    if in_features is None:
        raise ValueError(f"{path}: no InputLayer found")
    if params and int(params[0]["w"].shape[0]) != in_features:
        # e.g. Flatten of a >1x1 spatial input feeding a Dense: the kernel's
        # input width disagrees with the channel count
        raise ValueError(
            f"{path}: first layer expects {int(params[0]['w'].shape[0])} "
            f"input features but the InputLayer provides {in_features} "
            "channels — not a per-cell MLP chain")
    spec = MLPHead(in_features=in_features, layers=tuple(layers))
    return spec, {"layers": params}
