"""Compile a parsed Keras graph (core.h5io.ModelDef) into a PyTorch module.

Port of headpose_tpu/core/graph.py.  Every reference-format ``.h5``
artifact (pose heads, unified detector models) loads through
`load_graph_model` and runs as one `nn.Module`, batched; the native models
of `headpose_tpu_torch.models` are the served path, and this module is the
oracle and the fallback for artifacts that have no native equivalent.

Semantics kept from the JAX compiler:

  * every tensor between layers is NHWC, as Keras has it, so `Flatten`,
    `Reshape`, `Concatenate(axis=-1)` and the Lambda reshapes see Keras's
    element order; a convolution permutes to NCHW inside itself only;
  * TF "SAME" padding is computed per call and applied with an explicit
    `F.pad`: at stride 2 the extra row and column go at the bottom and
    right; `MaxPooling2D` pads with -inf;
  * the graph runs at call-node granularity: a layer called at several
    positions (weight sharing) runs once per call, nested submodels may
    have several outputs, and tf-keras numbers a nested submodel's outer
    calls from 1 where Keras 3 numbers them from 0 (`ModelDef.keras3`);
  * dropout layers are the identity (inference semantics);
  * every convolution and product runs in fp32 with TF32 off at
    `matmul_precision` "highest" and "high" (on the TPU, "high" is three
    bf16 passes, an emulation of fp32); at "default" (one bf16 pass on the
    TPU) each one's two operands are rounded to bf16 first, the products
    exact and the sums fp32, the bias unrounded (core/single_pass.py);
    a Dense layer and a 1x1 convolution at stride 1 are one GEMM each,
    nn.Linear's, so a 1x1-conv head graph computes what the native head
    module computes.

Weights keep their Keras layout as the module's parameters (HWIO
convolutions, (in, out) dense kernels), so `GraphModel.params` is the JAX
package's params dict leaf for leaf.
"""
from __future__ import annotations

import copy
import functools
import operator
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .single_pass import bf16_round, fp32_exact, single_pass_of
from ..utils.device import resolve_device
from .activations import get_activation as _activation
from .h5io import LayerDef, ModelDef, _as_modeldef

__all__ = ["GraphModel", "TrainableGraphHead", "load_graph_model",
           "compile_model"]

Params = dict[str, Any]


def _padding(cfg: dict) -> str:
    return cfg.get("padding", "valid").upper()


def _pair(v) -> tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def _dilation(cfg: dict) -> tuple[int, int]:
    return _pair(cfg.get("dilation_rate", (1, 1)))


def _same_pads(size: int, k: int, s: int, d: int = 1) -> tuple[int, int]:
    """TF SAME padding of one spatial axis: (before, after), the larger
    half after."""
    eff = (k - 1) * d + 1
    total = max((-(-size // s) - 1) * s + eff - size, 0)
    return total // 2, total - total // 2


def _pad_nchw(x: torch.Tensor, kernel, strides, padding: str,
              dilation=(1, 1), value: float = 0.0) -> torch.Tensor:
    """x (N, C, H, W) padded for a window `kernel` at `strides`: TF SAME
    (explicit, asymmetric) or VALID (none)."""
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise NotImplementedError(f"padding {padding!r}")
    ph = _same_pads(x.shape[2], kernel[0], strides[0], dilation[0])
    pw = _same_pads(x.shape[3], kernel[1], strides[1], dilation[1])
    if not any(ph + pw):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _dense(x, kernel, bias, rnd=_identity):
    """x (..., C) @ kernel (C, K) + bias over the last axis, as nn.Linear
    computes it (one GEMM with the bias in its epilogue), so that a graph's
    dense or 1x1 layer and the native head's Linear are the same op.
    `rnd` rounds both operands (`GraphModel`'s matmul precision)."""
    return F.linear(rnd(x), rnd(kernel).t().contiguous(), bias)


def _conv2d(x, kernel, bias, strides, padding, groups=1, dilation=(1, 1),
            rnd=_identity):
    """NHWC x, HWIO kernel (with I = C / groups) → NHWC conv + bias, of
    rnd(x) and rnd(kernel).  A 1x1 kernel at stride 1 is a product over the
    channel axis (`_dense`)."""
    strides = _pair(strides)
    if kernel.shape[:2] == (1, 1) and strides == (1, 1) and groups == 1:
        return _dense(x, kernel[0, 0], bias, rnd)
    w = rnd(kernel).permute(3, 2, 0, 1)
    y = F.conv2d(_pad_nchw(rnd(x).permute(0, 3, 1, 2), w.shape[2:],
                           strides, padding, dilation),
                 w, stride=strides, dilation=dilation, groups=groups)
    y = y.permute(0, 2, 3, 1)
    return y if bias is None else y + bias


# ---------------------------------------------------------------------------
# per-layer apply functions: (layer, params_for_layer, inputs) -> output
# ---------------------------------------------------------------------------

def _apply_conv2d(layer: LayerDef, p, xs, rnd):
    cfg = layer.config
    y = _conv2d(xs[0], p["kernel"], p.get("bias"), cfg["strides"],
                _padding(cfg), dilation=_dilation(cfg), rnd=rnd)
    return _activation(cfg.get("activation"))(y)


def _dw_kernel(p):
    # tf-keras stores the depthwise filter as 'depthwise_kernel'; Keras 3's
    # legacy-H5 writer names it plain 'kernel'
    return p["depthwise_kernel"] if "depthwise_kernel" in p else p["kernel"]


def _depthwise(x, dk, bias, cfg, rnd):
    """Depthwise HWC·mult kernel as a grouped conv: output channel
    c·mult + m reads input channel c."""
    kh, kw, cin, mult = dk.shape
    return _conv2d(x, dk.reshape(kh, kw, 1, cin * mult), bias,
                   cfg["strides"], _padding(cfg), groups=cin,
                   dilation=_dilation(cfg), rnd=rnd)


def _apply_depthwise_conv2d(layer: LayerDef, p, xs, rnd):
    cfg = layer.config
    y = _depthwise(xs[0], _dw_kernel(p), p.get("bias"), cfg, rnd)
    return _activation(cfg.get("activation"))(y)


def _apply_separable_conv2d(layer: LayerDef, p, xs, rnd):
    cfg = layer.config
    y = _depthwise(xs[0], _dw_kernel(p), None, cfg, rnd)
    y = _conv2d(y, p["pointwise_kernel"], p.get("bias"), (1, 1), "VALID",
                rnd=rnd)
    return _activation(cfg.get("activation"))(y)


def _transpose_trim(k: int, s: int, padding: str) -> tuple[int, int]:
    """(start, end) trim of the full transposed-conv output, (n-1)·s + k
    long, to what jax.lax.conv_transpose gives for `padding` (its
    _conv_transpose_padding rule); a negative trim extends the output with
    zeros on that side."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return k - 1 - pad_a, k - 1 - (pad_len - pad_a)


def _apply_conv2d_transpose(layer: LayerDef, p, xs, rnd):
    cfg = layer.config
    out_pad = cfg.get("output_padding")
    if out_pad is not None and any(int(v) != 0
                                   for v in np.atleast_1d(out_pad)):
        raise NotImplementedError(
            f"Conv2DTranspose output_padding={out_pad} is not supported")
    if any(d != 1 for d in _dilation(cfg)):
        raise NotImplementedError(
            f"Conv2DTranspose dilation_rate={cfg['dilation_rate']} "
            "is not supported")
    padding = _padding(cfg)
    if padding not in ("SAME", "VALID"):
        raise NotImplementedError(f"padding {padding!r}")
    strides = _pair(cfg["strides"])
    kernel = p["kernel"]                      # (kh, kw, filters, in)
    y = F.conv_transpose2d(rnd(xs[0]).permute(0, 3, 1, 2),
                           rnd(kernel).permute(3, 2, 0, 1), stride=strides)
    pads = []
    for axis, (k, s) in enumerate(zip(kernel.shape[:2], strides)):
        start, end = _transpose_trim(int(k), s, padding)
        n = y.shape[2 + axis]
        y = y.narrow(2 + axis, max(start, 0),
                     n - max(start, 0) - max(end, 0))
        pads.append((max(-start, 0), max(-end, 0)))
    if any(pads[0] + pads[1]):
        y = F.pad(y, (*pads[1], *pads[0]))
    y = y.permute(0, 2, 3, 1)
    if "bias" in p:
        y = y + p["bias"]
    return _activation(cfg.get("activation"))(y)


def _apply_dense(layer: LayerDef, p, xs, rnd):
    y = _dense(xs[0], p["kernel"], p.get("bias"), rnd)
    return _activation(layer.config.get("activation"))(y)


def _require_last_axis(cfg: dict, x, what: str) -> None:
    """This compiler normalizes over the last axis; any other saved axis
    would broadcast wrong, so it raises."""
    axis = cfg.get("axis", -1)
    axes = [axis] if isinstance(axis, int) else list(axis)
    if any(a not in (-1, x.ndim - 1) for a in axes):
        raise NotImplementedError(
            f"{what} with axis={axis} on rank-{x.ndim} input — only the "
            "last axis is supported")


def _apply_batchnorm(layer: LayerDef, p, xs):
    cfg = layer.config
    eps = cfg.get("epsilon", 1e-3)
    x = xs[0]
    _require_last_axis(cfg, x, "BatchNormalization")
    y = (x - p["moving_mean"]) * torch.rsqrt(p["moving_variance"] + eps)
    if cfg.get("scale", True):
        y = y * p["gamma"]
    if cfg.get("center", True):
        y = y + p["beta"]
    return y


def _apply_layernorm(layer: LayerDef, p, xs):
    cfg = layer.config
    eps = cfg.get("epsilon", 1e-3)  # Keras LayerNormalization default
    x = xs[0]
    _require_last_axis(cfg, x, "LayerNormalization")
    mean = x.mean(dim=-1, keepdim=True)
    var = (x - mean).square().mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if "gamma" in p:
        y = y * p["gamma"]
    if "beta" in p:
        y = y + p["beta"]
    return y


def _apply_mha(layer: LayerDef, p, xs, rnd):
    """Keras MultiHeadAttention: self (q), cross (q, v; key defaults to
    value) or full (q, v, k); the parser puts the call refs in (query,
    value[, key]) order.  Weights: query/kernel (C, H, D), key/kernel,
    value/kernel, attention_output/kernel (H, D, C) and their biases."""
    def product(equation, a, b):
        return torch.einsum(equation, rnd(a), rnd(b))

    q_in = xs[0]
    v_in = xs[1] if len(xs) > 1 else xs[0]
    k_in = xs[2] if len(xs) > 2 else v_in
    q = product("btc,chd->bthd", q_in, p["query/kernel"]) + p["query/bias"]
    k = product("bsc,chd->bshd", k_in, p["key/kernel"]) + p["key/bias"]
    v = product("bsc,chd->bshd", v_in, p["value/kernel"]) + p["value/bias"]
    d = q.shape[-1]
    scores = product("bthd,bshd->bhts", q, k) / torch.sqrt(
        torch.tensor(float(d), dtype=q.dtype, device=q.device))
    attn = torch.softmax(scores, dim=-1)
    out = product("bhts,bshd->bthd", attn, v)
    return (product("bthd,hdc->btc", out, p["attention_output/kernel"])
            + p["attention_output/bias"])


def _apply_reshape(layer: LayerDef, p, xs):
    return xs[0].reshape(xs[0].shape[0], *layer.config["target_shape"])


def _mean(x, axis, keepdims: bool):
    if axis is None:
        axes = tuple(range(x.ndim))
    else:
        axes = tuple(int(a) for a in np.atleast_1d(axis))
    return x.mean(dim=axes, keepdim=keepdims)


def _constant(c, like: torch.Tensor) -> torch.Tensor:
    t = torch.as_tensor(c, device=like.device)
    return t.to(like.dtype) if t.is_floating_point() else t


def _apply_tf_op(layer: LayerDef, p, xs):
    """TensorFlowOpLayer: a raw TF graph node captured into the Keras graph.

    `constants` maps the op's input positions that are not graph tensors to
    literal values; graph tensors fill the remaining positions in order.
    Ops beyond this table raise: approximating a TF op would load a model
    that runs but computes wrong values."""
    node_op = layer.config.get("node_def", {}).get("op")
    constants = layer.config.get("constants", {})

    def operands(n):
        """The op's n inputs: graph tensors + constants at their places."""
        out, it = [], iter(xs)
        for i in range(n):
            c = constants.get(str(i))
            out.append(_constant(c, xs[0]) if c is not None else next(it))
        return out

    if node_op == "Pad":
        pads = [(int(a), int(b)) for a, b in constants["1"]]
        flat = [v for pair in reversed(pads) for v in pair]
        return F.pad(xs[0], flat)
    if node_op == "Reshape":
        shape = constants["1"]
        # batch-polymorphic: the saved constant hardwires batch 1
        return xs[0].reshape(xs[0].shape[0], *[int(s) for s in shape[1:]])
    if node_op in ("AddV2", "Add"):
        a, b = operands(2)
        return a + b
    if node_op == "Sub":
        a, b = operands(2)
        return a - b
    if node_op == "Mul":
        a, b = operands(2)
        return a * b
    if node_op in ("RealDiv", "Div"):
        a, b = operands(2)
        return a / b
    if node_op == "ConcatV2":
        # inputs = graph tensors + every captured constant (a constant
        # concat operand counts too, not just the trailing axis)
        *ts, axis = operands(len(xs) + len(constants))
        return torch.cat(ts, dim=int(axis))
    if node_op == "ExpandDims":
        x, axis = operands(2)
        return x.unsqueeze(int(axis))
    if node_op == "Squeeze":
        dims = layer.config["node_def"].get("attr", {}).get(
            "squeeze_dims", {}).get("list", {}).get("i")
        if not dims:
            return xs[0].squeeze()
        return xs[0].squeeze(tuple(int(d) for d in dims))
    if node_op == "Mean":
        x, axes = operands(2)
        keep = layer.config["node_def"].get("attr", {}).get(
            "keep_dims", {}).get("b", False)
        return _mean(x, axes.tolist(), bool(keep))
    raise NotImplementedError(f"TensorFlowOpLayer op {node_op!r}")


def _operand(xs, kw):
    return xs[1] if len(xs) > 1 else kw["y"]


_TF_OP_LAMBDAS: dict[str, Callable] = {
    # TFOpLambda (the TF2 successor of TensorFlowOpLayer): the wrapped
    # function name is in config['function']; non-tensor call args arrive in
    # the inbound node's kwargs
    "math.add": lambda xs, kw: xs[0] + _operand(xs, kw),
    "math.subtract": lambda xs, kw: xs[0] - _operand(xs, kw),
    "math.multiply": lambda xs, kw: xs[0] * _operand(xs, kw),
    "math.truediv": lambda xs, kw: xs[0] / _operand(xs, kw),
    "__operators__.add": lambda xs, kw: xs[0] + _operand(xs, kw),
    "concat": lambda xs, kw: torch.cat(xs, dim=int(kw.get("axis", 0))),
    "expand_dims": lambda xs, kw: xs[0].unsqueeze(int(kw["axis"])),
    "math.reduce_mean": lambda xs, kw: _mean(
        xs[0], kw.get("axis"), bool(kw.get("keepdims", False))),
    "nn.relu": lambda xs, kw: torch.relu(xs[0]),
    "math.tanh": lambda xs, kw: torch.tanh(xs[0]),
    "math.sigmoid": lambda xs, kw: torch.sigmoid(xs[0]),
}


def _apply_tf_op_lambda(layer: LayerDef, p, xs, node_kwargs=None):
    fn_name = layer.config.get("function")
    fn = _TF_OP_LAMBDAS.get(fn_name)
    if fn is None:
        raise NotImplementedError(f"TFOpLambda function {fn_name!r}")
    return fn(xs, node_kwargs or {})


def _apply_lambda(layer: LayerDef, p, xs):
    """The only Lambdas of the reference's artifacts are the spatial
    flatten/unflatten pair of the SE-Transformer head, told apart by
    arity."""
    if len(xs) == 1:  # reshape_flat: (B, H, W, C) → (B, H·W, C)
        x = xs[0]
        return x.reshape(x.shape[0], x.shape[1] * x.shape[2], x.shape[3])
    t, orig = xs      # reshape_back: tokens + the original spatial tensor
    return t.reshape(orig.shape[0], orig.shape[1], orig.shape[2], t.shape[2])


def _max_pool(layer: LayerDef, p, xs):
    cfg = layer.config
    pool, strides = _pair(cfg["pool_size"]), _pair(cfg["strides"])
    x = _pad_nchw(xs[0].permute(0, 3, 1, 2), pool, strides, _padding(cfg),
                  value=-torch.inf)
    return F.max_pool2d(x, pool, strides).permute(0, 2, 3, 1)


_LAYER_FNS: dict[str, Callable] = {
    "Conv2D": _apply_conv2d,
    "DepthwiseConv2D": _apply_depthwise_conv2d,
    "SeparableConv2D": _apply_separable_conv2d,
    "Conv2DTranspose": _apply_conv2d_transpose,
    "Dense": _apply_dense,
    "BatchNormalization": _apply_batchnorm,
    "LayerNormalization": _apply_layernorm,
    "MultiHeadAttention": _apply_mha,
    "Reshape": _apply_reshape,
    "TensorFlowOpLayer": _apply_tf_op,
    "Lambda": _apply_lambda,
    "Add": lambda l, p, xs: sum(xs[1:], xs[0]),
    "Multiply": lambda l, p, xs: functools.reduce(operator.mul, xs),
    "Average": lambda l, p, xs: sum(xs[1:], xs[0]) / len(xs),
    "Concatenate": lambda l, p, xs: torch.cat(
        xs, dim=int(l.config.get("axis", -1))),
    "ReLU": lambda l, p, xs: torch.relu(xs[0]),
    "Activation": lambda l, p, xs: _activation(
        l.config.get("activation"))(xs[0]),
    "Flatten": lambda l, p, xs: xs[0].reshape(xs[0].shape[0], -1),
    "GlobalAveragePooling2D": lambda l, p, xs: xs[0].mean(
        dim=(1, 2), keepdim=bool(l.config.get("keepdims", False))),
    "MaxPooling2D": _max_pool,
    "SpatialDropout2D": lambda l, p, xs: xs[0],  # inference semantics
    "Dropout": lambda l, p, xs: xs[0],
    "InputLayer": None,  # handled by the schedule
}
# the layers of convs and products, which take `rnd`: the rounding of
# their operands under the graph's matmul precision
_PRODUCTS = frozenset({"Conv2D", "DepthwiseConv2D", "SeparableConv2D",
                       "Conv2DTranspose", "Dense", "MultiHeadAttention"})


def _module_key(name: str) -> str:
    # a module or parameter name may not hold "."; TFOpLambda layers are
    # named like "tf.math.add" (they carry no weights, but keep the map 1:1)
    return name.replace(".", ":")


def _schedule(model: ModelDef):
    """The call-node schedule of one graph: (layer, call index) pairs in
    dependency order, and the node-key functions (computed once)."""
    input_names = [ref[0] for ref in model.inputs]
    pending = [(name, j) for name in model.order
               for j in range(len(model.layers[name].inbound))
               if model.layers[name].class_name != "InputLayer"]

    def node_key(name: str, j: int) -> tuple[str, int]:
        base = (1 if model.layers[name].submodel is not None
                and not model.keras3 else 0)
        return (name, j + base)

    def resolve_key(ref) -> tuple[str, int]:
        name, idx, _ = ref
        producer = model.layers.get(name)
        if producer is not None and producer.class_name == "InputLayer":
            return (name, 0)
        return (name, idx)

    schedule: list[tuple[str, int]] = []
    done = {(n, 0) for n in input_names}
    while pending:
        still = []
        for name, j in pending:
            if all(resolve_key(r) in done
                   for r in model.layers[name].inbound[j]):
                schedule.append((name, j))
                done.add(node_key(name, j))
            else:
                still.append((name, j))
        if len(still) == len(pending):
            raise ValueError(
                f"graph {model.name!r}: unresolvable node dependencies "
                f"{[n for n, _ in still]}")
        pending = still
    return input_names, schedule, node_key, resolve_key


class GraphModel(nn.Module):
    """A Keras artifact compiled to a PyTorch module.

    `forward(*inputs)` (NHWC tensors on the module's device) runs the
    graph; one output comes back as a tensor, several as a tuple.  Numpy
    inputs are taken too.  Each weighted layer's arrays are registered as
    parameters (`layers[<name>]`, a ParameterDict keyed by the Keras weight
    key), each nested submodel as a child GraphModel (`subgraphs[<name>]`);
    `params` gives them back as the JAX package's params dict (numpy, Keras
    layout).

    `device=None` means the card, and raises when there is none.
    `matmul_precision` is one of `core.single_pass.MATMUL_PRECISIONS`,
    the strings the JAX package passes to `jax.default_matmul_precision`:
    "highest" and "high" compute exact fp32 (TF32 off; the TPU's "high" is
    three bf16 passes, an emulation of fp32), "default" rounds the operands
    of every conv and product to bf16 (one pass on the TPU;
    core/single_pass.py).  Any other string raises NotImplementedError."""

    def __init__(self, model_def: ModelDef, matmul_precision: str = "highest",
                 *, device: str | torch.device | None = None):
        super().__init__()
        single_pass_of(matmul_precision)            # raises if not served
        device = resolve_device(device)
        self.definition = model_def
        self.matmul_precision = matmul_precision
        self.layers = nn.ModuleDict()
        self.subgraphs = nn.ModuleDict()
        for name, layer in model_def.layers.items():
            if layer.submodel is not None:
                self.subgraphs[_module_key(name)] = GraphModel(
                    layer.submodel, device=device)
            elif layer.weights:
                self.layers[_module_key(name)] = nn.ParameterDict({
                    k: nn.Parameter(torch.tensor(np.asarray(v, np.float32),
                                                 device=device))
                    for k, v in layer.weights.items()})
        (self._input_names, self._schedule, self._node_key,
         self._resolve_key) = _schedule(model_def)

    @property
    def device(self) -> torch.device:
        for p in self.parameters():
            return p.device
        return torch.device("cpu")

    def _layer_params(self, name: str) -> dict[str, torch.Tensor]:
        key = _module_key(name)
        return dict(self.layers[key]) if key in self.layers else {}

    def _run(self, inputs: list, rnd) -> list:
        values: dict[tuple[str, int], Any] = {}
        for name, x in zip(self._input_names, inputs):
            values[(name, 0)] = x

        def lookup(ref):
            v = values[self._resolve_key(ref)]
            # a multi-output producer (a nested submodel) stores a list
            return v[ref[2]] if isinstance(v, (list, tuple)) else v

        model = self.definition
        for name, j in self._schedule:
            layer = model.layers[name]
            xs = [lookup(r) for r in layer.inbound[j]]
            if layer.submodel is not None:
                outs = self.subgraphs[_module_key(name)]._run(xs, rnd)
                out = outs[0] if len(outs) == 1 else outs
            elif layer.class_name == "TFOpLambda":
                kw = (layer.call_kwargs[j]
                      if j < len(layer.call_kwargs) else {})
                out = _apply_tf_op_lambda(layer, self._layer_params(name),
                                          xs, kw)
            else:
                fn = _LAYER_FNS.get(layer.class_name)
                if fn is None:
                    raise NotImplementedError(f"layer {layer.class_name}")
                rounding = (rnd,) if layer.class_name in _PRODUCTS else ()
                out = fn(layer, self._layer_params(name), xs, *rounding)
            values[self._node_key(name, j)] = out
        return [lookup(ref) for ref in model.outputs]

    def forward(self, *inputs, single_pass: bool | None = None):
        """The graph's outputs at the model's matmul precision, or with
        `single_pass` given, at single-pass bf16 (True) or fp32 (False):
        a FaceDetector's precision string sets it for its network."""
        if single_pass is None:
            single_pass = single_pass_of(self.matmul_precision)
        device = self.device
        xs = [torch.as_tensor(np.asarray(x, np.float32), device=device)
              if not isinstance(x, torch.Tensor) else x for x in inputs]
        with fp32_exact():
            outs = self._run(xs, bf16_round if single_pass else _identity)
        return outs[0] if len(outs) == 1 else tuple(outs)

    @property
    def params(self) -> Params:
        """The parameters as the JAX package's params dict: {layer: {weight
        key: array}}, a submodel's nested under its name (numpy, Keras
        layout)."""
        out: Params = {}
        for name, layer in self.definition.layers.items():
            key = _module_key(name)
            if layer.submodel is not None:
                sub = self.subgraphs[key].params
                if sub:
                    out[name] = sub
            elif key in self.layers:
                out[name] = {k: v.detach().cpu().numpy()
                             for k, v in self.layers[key].items()}
        return out

    def param_paths(self):
        """(state_dict key, params path) of every parameter: the weight
        bridge between `params` and the module's state_dict."""
        for name, layer in self.definition.layers.items():
            key = _module_key(name)
            if layer.submodel is not None:
                for sk, path in self.subgraphs[key].param_paths():
                    yield f"subgraphs.{key}.{sk}", (name, *path)
            elif key in self.layers:
                for wk in self.layers[key]:
                    yield f"layers.{key}.{wk}", (name, wk)

    def load_params(self, params: Params) -> None:
        """Copy a params dict (`params`' layout) into the module."""
        sd = {}
        for sk, path in self.param_paths():
            leaf = params
            for p in path:
                leaf = leaf[p]
            sd[sk] = torch.as_tensor(np.asarray(leaf, np.float32))
        self.load_state_dict(sd)

    @property
    def param_count(self) -> int:
        return sum(int(p.numel()) for p in self.parameters())


class TrainableGraphHead:
    """A compiled graph head as a spec of the port's trainer, so that any
    reference H5 pose head (architectures with no native equivalent too)
    can be fine-tuned with `train.fit`:

        gm = load_graph_model("some_head.h5", device="cpu")
        spec = TrainableGraphHead(gm, in_features=96)
        result = fit(cfg, dataset, spec=spec, params=gm.params)

    `head_net(spec)` builds its module (`TrainableGraphHeadNet`), and the
    weight bridge (`models.params.params_from_jax`) maps `params` onto it.
    Inference semantics (dropout = identity) hold in training and
    evaluation alike; the L2 term covers every leaf whose path holds
    'kernel'."""

    def __init__(self, graph_model: GraphModel, in_features: int):
        self._gm = graph_model
        self.in_features = in_features

    def make_net(self, *, device=None) -> "TrainableGraphHeadNet":
        return TrainableGraphHeadNet(self._gm.definition,
                                     self._gm.matmul_precision,
                                     device=resolve_device(device))

    def param_pairs(self):
        """(state_dict key of the module, params path) pairs."""
        for sk, path in self._gm.param_paths():
            yield f"graph.{sk}", path


class TrainableGraphHeadNet(nn.Module):
    """The module of a `TrainableGraphHead`: (N, C) rows run as (N, 1, 1, C)
    maps and come back as (N, outputs); a map runs as it is, at the graph
    model's own matmul precision.  A caller's `single_pass` does not reach
    it: JAX's head runs under the GraphModel's own
    `jax.default_matmul_precision`, which overrides the caller's."""

    def __init__(self, model_def: ModelDef, matmul_precision: str = "highest",
                 *, device: torch.device):
        super().__init__()
        self.graph = GraphModel(copy.deepcopy(model_def), matmul_precision,
                                device=device)

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None, *,
                single_pass: bool = False) -> torch.Tensor:
        del generator, single_pass    # dropout is the identity here
        squeeze = x.ndim == 2
        if squeeze:
            x = x[:, None, None, :]
        y = self.graph(x)
        if isinstance(y, tuple):
            raise ValueError("head graphs must have a single output")
        return y.reshape(y.shape[0], -1) if squeeze else y

    def l2_penalty(self, rate: float):
        if rate == 0.0:
            return 0.0
        total = 0.0
        for sk, path in self.graph.param_paths():
            if any("kernel" in str(part) for part in path):
                total = total + self.graph.get_parameter(sk).square().sum()
        return rate * total


def compile_model(model_def: ModelDef, **kwargs) -> GraphModel:
    return GraphModel(model_def, **kwargs)


def load_graph_model(path, **kwargs) -> GraphModel:
    """Load any reference-format Keras H5 (or a ModelDef parsed already)
    into a GraphModel.  `device=None` means the card."""
    return GraphModel(_as_modeldef(path), **kwargs)
