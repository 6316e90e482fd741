"""Pose-regression heads, PyTorch edition.

Port of headpose_tpu/models/heads.py, inference only.  The reference defines
its heads as stacks of 1x1 convolutions; a 1x1 conv over an HxW map is a
matmul over the channel axis, so every head module serves both per-face
vectors (N, C) and whole NHWC feature maps (B, H, W, C).

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
`tools.convert` carries over as they are.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from ..core.activations import get_activation
from ..utils.device import resolve_device

__all__ = ["MLPHead", "ResidualMLPHead", "SkipMLPHead", "SEMLPHead",
           "SETransformerHead", "EnsembleHead", "MLPHeadNet",
           "ResidualMLPHeadNet", "SkipMLPHeadNet", "SEMLPHeadNet",
           "SETransformerHeadNet", "EnsembleHeadNet", "head_net"]


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
    dropout_rate: float = 0.0  # training only; the port serves inference

    spatial_context = False    # per cell


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


@dataclasses.dataclass(frozen=True)
class SEMLPHead:
    """SE gate + 1x1-conv head.  On a map the gate pools over all cells."""

    in_features: int = 88
    reduction: int = 8
    hidden: int = 42
    out_features: int = 3

    spatial_context = True


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer, act in zip(self.layers, self._acts):
            x = act(layer(x))
        return x


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self._act
        x = act(self.proj(x))
        for blk in self.blocks:
            y = act(blk["fc2"](act(blk["fc1"](x))))
            x = torch.relu(x + y)
        return self.out(act(self.bottleneck(x)))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = self._act
        x1 = act(self.enc1(x))
        x2 = act(self.enc2(x1))
        return self.out(act(self.dec(x2)) + x1)


class _SqueezeExcite(nn.Module):
    """Squeeze-and-excitation over the channel axis.  x is (B, H, W, C) or
    (N, C); the squeeze averages every axis but the first and the last (a
    row is its own squeeze)."""

    def __init__(self, channels: int, reduction: int, device: torch.device):
        super().__init__()
        mid = channels // reduction
        self.fc1 = nn.Linear(channels, mid, device=device)
        self.fc2 = nn.Linear(mid, channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = tuple(range(1, x.ndim - 1))
        s = x.mean(dim=axes) if axes else x
        s = torch.sigmoid(self.fc2(torch.relu(self.fc1(s))))
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(torch.relu(self.fc(self.se(x))))


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, None, :]
        B, H, W, C = x.shape
        t = self.se(x).reshape(B, H * W, C)
        q = torch.einsum("btc,chd->bthd", t, self.query.w) + self.query.b
        k = torch.einsum("bsc,chd->bshd", t, self.key.w) + self.key.b
        v = torch.einsum("bsc,chd->bshd", t, self.value.w) + self.value.b
        scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(
            self.spec.key_dim)
        o = torch.einsum("bhts,bshd->bthd", torch.softmax(scores, dim=-1), v)
        o = (torch.einsum("bthd,hdc->btc", o, self.attn_out.w)
             + self.attn_out.b)
        t = self.ln1(t + o)
        t = self.ln2(t + self.ff2(torch.relu(self.ff1(t))))
        y = self.out(torch.relu(self.fc(t.reshape(B, H, W, C))))
        return y[:, 0, 0, :] if squeeze else y


class EnsembleHeadNet(nn.Module):
    """The members of an `EnsembleHead`, combined as the JAX package's
    inference path combines them (`EnsembleHead._apply_grouped`): members
    with equal specs are evaluated together, as one `torch.func.vmap` over
    their stacked weights (batched products), and the groups are summed in
    the order they first appear; then the sum is divided by K, or weighted
    per member and angle and offset by the bias."""

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

    def _stacked(self) -> list:
        """Per group: its members' weights stacked along a new first axis
        (None for a group of one) and its rows of the stack weights (None
        for an average); kept until a parameter changes."""
        from ..ops.kernels.packing import stamp   # ops imports this module

        current = stamp(self)
        if self._stacks is None or self._stacks[0] != current:
            with torch.no_grad():
                stacks = [(torch.func.stack_module_state(
                    [self.members[i] for i in idx]) if len(idx) > 1 else None,
                    self._weights[idx] if self._weights is not None
                    else None) for idx in self.groups]
            self._stacks = (current, stacks)
        return self._stacks[1]

    @torch.no_grad()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc = None
        for idx, (stack, w) in zip(self.groups, self._stacked()):
            first = self.members[idx[0]]
            if stack is None:
                y = first(x)
                if w is not None:
                    y = y * w[0]
            else:
                def member(params, buffers, rows, module=first):
                    return torch.func.functional_call(
                        module, (params, buffers), (rows,))

                ys = torch.func.vmap(member, in_dims=(0, 0, None))(
                    *stack, x)                                # (k, ..., 3)
                if w is not None:
                    ys = ys * w.reshape((len(idx),) + (1,) * (ys.ndim - 2)
                                        + (3,))
                y = ys.sum(dim=0)
            acc = y if acc is None else acc + y
        if self._weights is None:
            return acc / len(self.members)
        if self._bias is not None:
            acc = acc + self._bias
        return acc


_HEAD_NETS = {MLPHead: MLPHeadNet, ResidualMLPHead: ResidualMLPHeadNet,
              SkipMLPHead: SkipMLPHeadNet, SEMLPHead: SEMLPHeadNet,
              SETransformerHead: SETransformerHeadNet,
              EnsembleHead: EnsembleHeadNet}


def head_net(spec: Any, *, device: str | torch.device | None = None
             ) -> nn.Module:
    """The module of a head spec (any family above)."""
    try:
        cls = _HEAD_NETS[type(spec)]
    except KeyError:
        raise NotImplementedError(f"head type {type(spec).__name__} is not "
                                  "ported") from None
    return cls(spec, device=device)
