"""Native → Keras-2 H5 exporter (the reverse of core/h5io.py).

Port of headpose_tpu/tools/h5export.py.  The reference ecosystem's artifact
contract is the Keras-2 HDF5 file: heads are consumed by JoinModels.py:29-31
via tf.keras.models.load_model, shape conversion validates through
InputShapeConvertor.py:129-218, and the demo loads the unified 6-output
model (blazeFaceDetectorH5.py:96-102).  This module writes that format
directly with h5py — no Keras dependency — from the port's specs and
JAX-layout params, so a head trained here can be consumed by the reference
toolchain unmodified:

  * save_head_h5:    a pose head → fully-convolutional 1x1-conv Keras model
    with dynamic (None, None, C) input (the reference's "NoFlatten"
    convention).
  * save_unified_h5: UnifiedPoseModel → the full BlazeFace graph (stem,
    depthwise/pointwise blocks, maxpool + channel-Pad skips, SSD heads,
    anchor-major output reshapes, grafted pose heads) with the reference's
    6-output signature (JoinModels.py:152-158) — batch-polymorphic, unlike
    the reference's own hardwired batch-1 export.

Format notes (verified against the shipped artifacts): root attrs
model_config/keras_version/backend; model_weights/<layer> groups carrying a
weight_names attr with 'layer/kernel:0'-style paths.  Keras rebuilds layers
from the config JSON and then overwrites parameters from model_weights, so
initializer configs can stay generic.  h5py is imported when a file is
written, so the module imports without it.
"""
from __future__ import annotations

import codecs
import json
import marshal

import numpy as np

__all__ = ["save_head_h5", "save_unified_h5", "keras3_custom_objects"]

_KERAS_VERSION = "2.15.0"


# --------------------------------------------------------------------------
# Lambda payloads for the SE-Transformer export.  Keras-2 serializes Lambda
# layers as marshalled CPython bytecode (function_type 'lambda'); these two
# functions reproduce the reference head's flatten/unflatten lambdas
# (Model-88/attention_model.py:40-47,66-74).  `tf` resolves at CALL time from
# the loader's globals (tf_keras binds its own module globals in func_load),
# so this module never imports TensorFlow.  Caveat (inherent to the format,
# shared by the reference's own shipped MHA artifacts): marshalled bytecode
# only loads under the same CPython version that wrote it.
# --------------------------------------------------------------------------

def _lambda_reshape_flat(t):
    return tf.reshape(  # noqa: F821 — resolved by the Keras loader's globals
        t, (tf.shape(t)[0], tf.shape(t)[1] * tf.shape(t)[2], tf.shape(t)[3]))  # noqa: F821


def _lambda_reshape_back(ts):
    t, orig = ts
    return tf.reshape(  # noqa: F821
        t, (tf.shape(orig)[0], tf.shape(orig)[1], tf.shape(orig)[2],  # noqa: F821
            tf.shape(t)[2]))  # noqa: F821


def _marshal_fn(fn) -> str:
    return codecs.encode(marshal.dumps(fn.__code__), "base64").decode("ascii")


def _init(cls: str = "GlorotUniform") -> dict:
    return {"module": "keras.initializers", "class_name": cls,
            "config": {}, "registered_name": None}


class _Graph:
    """Accumulates Keras-2 functional-graph layers and their weights."""

    def __init__(self, name: str):
        self.name = name
        self.layers: list[dict] = []
        self.weights: dict[str, dict[str, np.ndarray]] = {}
        # layer-name prefix, so one emitter can run several times in a graph
        # (ensemble members) without its fixed Keras layer names colliding
        self.prefix = ""

    def add(self, class_name: str, name: str, config: dict,
            inbound: list[str] | None,
            weights: dict[str, np.ndarray] | None = None,
            raw_inbound: list | None = None) -> str:
        name = self.prefix + name
        config = {"name": name, "trainable": True, "dtype": "float32",
                  **config}
        if raw_inbound is not None:
            node = raw_inbound      # pre-built node list (kwargs-form calls)
        else:
            node = [] if inbound is None else [[[n, 0, 0, {}] for n in inbound]]
        self.layers.append({"class_name": class_name, "config": config,
                            "name": name, "inbound_nodes": node})
        if weights:
            self.weights[name] = {f"{name}/{k}:0": np.asarray(v, np.float32)
                                  for k, v in weights.items()}
        return name

    def input(self, name: str, shape: tuple) -> str:
        # InputLayer rejects the trainable/dtype boilerplate other layers get
        self.layers.append({"class_name": "InputLayer",
                            "config": {"batch_input_shape": list(shape),
                                       "dtype": "float32", "sparse": False,
                                       "ragged": False, "name": name},
                            "name": name, "inbound_nodes": []})
        return name

    def conv2d(self, name: str, prev: str, kernel: np.ndarray,
               bias: np.ndarray, *, strides=(1, 1), activation="linear",
               padding="same") -> str:
        kernel = np.asarray(kernel, np.float32)
        return self.add("Conv2D", name, {
            "filters": int(kernel.shape[3]),
            "kernel_size": list(kernel.shape[:2]),
            "strides": list(strides), "padding": padding,
            "data_format": "channels_last", "dilation_rate": [1, 1],
            "groups": 1, "activation": activation, "use_bias": True,
            "kernel_initializer": _init(), "bias_initializer": _init("Zeros"),
            "kernel_regularizer": None, "bias_regularizer": None,
            "activity_regularizer": None, "kernel_constraint": None,
            "bias_constraint": None,
        }, [prev], {"kernel": kernel, "bias": bias})

    def depthwise2d(self, name: str, prev: str, kernel: np.ndarray,
                    bias: np.ndarray, *, strides=(1, 1)) -> str:
        kernel = np.asarray(kernel, np.float32)
        return self.add("DepthwiseConv2D", name, {
            "kernel_size": list(kernel.shape[:2]),
            "strides": list(strides), "padding": "same",
            "data_format": "channels_last", "dilation_rate": [1, 1],
            # no "groups": tf-keras defaults it; Keras 3's DepthwiseConv2D
            # rejects it as an unrecognized kwarg
            "activation": "linear", "use_bias": True,
            "depth_multiplier": 1,
            "depthwise_initializer": _init(), "bias_initializer": _init("Zeros"),
            "depthwise_regularizer": None, "bias_regularizer": None,
            "activity_regularizer": None, "depthwise_constraint": None,
            "bias_constraint": None,
        }, [prev], {"depthwise_kernel": kernel, "bias": bias})

    def relu(self, name: str, prev: str) -> str:
        return self.add("ReLU", name, {"max_value": None,
                                       "negative_slope": 0.0,
                                       "threshold": 0.0}, [prev])

    def maxpool(self, name: str, prev: str) -> str:
        return self.add("MaxPooling2D", name, {
            "pool_size": [2, 2], "padding": "same", "strides": [2, 2],
            "data_format": "channels_last"}, [prev])

    def add_layer(self, name: str, a: str, b: str) -> str:
        return self.add("Add", name, {}, [a, b])

    def channel_pad(self, name: str, prev: str, pad: int) -> str:
        """Zero-pad the channel axis via a TensorFlowOpLayer Pad node (the
        construct the reference backbone uses for its growing skips)."""
        return self.add("TensorFlowOpLayer", f"tf_op_layer_{name}", {
            "name": name,
            "node_def": {"name": name, "op": "Pad",
                         "input": [f"{prev}/output", f"{name}/paddings"],
                         "attr": {"T": {"type": "DT_FLOAT"},
                                  "Tpaddings": {"type": "DT_INT32"}}},
            "constants": {"1": [[0, 0], [0, 0], [0, 0], [0, int(pad)]]},
        }, [prev])

    def reshape(self, name: str, prev: str, target_shape: tuple) -> str:
        return self.add("Reshape", name,
                        {"target_shape": list(target_shape)}, [prev])

    def _keras_layer_order(self, outputs: list[str]) -> list[str]:
        """Replicate tf-keras Functional._map_graph_network's model.layers
        order (depth-sorted, ties by DFS-from-outputs traversal index).  The
        legacy H5 weight loader pairs `layer_names` with `model.layers`
        POSITIONALLY, so the stored order must match what Keras rebuilds —
        config order is not it."""
        inbound = {l["name"]: [ref[0] for call in l["inbound_nodes"]
                               for ref in call] for l in self.layers}
        post_order: list[str] = []
        indices: dict[str, int] = {}
        finished: set[str] = set()

        def visit(name: str) -> None:
            if name in finished:
                return
            if name not in indices:
                indices[name] = len(indices)
            for parent in inbound[name]:
                visit(parent)
            finished.add(name)
            post_order.append(name)

        for out in outputs:
            visit(out)
        depths: dict[str, int] = {}
        for name in reversed(post_order):
            d = depths.setdefault(name, 0)
            for parent in inbound[name]:
                depths[parent] = max(d + 1, depths.get(parent, 0))
        return sorted(post_order, key=lambda n: (-depths[n], indices[n]))

    def save(self, path: str, outputs: list[str], inputs: list[str]) -> None:
        import h5py

        cfg = {"class_name": "Functional",
               "config": {"name": self.name, "layers": self.layers,
                          "input_layers": [[n, 0, 0] for n in inputs],
                          "output_layers": [[n, 0, 0] for n in outputs]}}
        with h5py.File(path, "w") as f:
            f.attrs["model_config"] = json.dumps(cfg)
            f.attrs["keras_version"] = _KERAS_VERSION
            f.attrs["backend"] = "tensorflow"
            mw = f.create_group("model_weights")
            mw.attrs["backend"] = "tensorflow"
            mw.attrs["keras_version"] = _KERAS_VERSION
            order = self._keras_layer_order(outputs)
            mw.attrs["layer_names"] = np.array(
                [n.encode() for n in order], dtype="S64")
            for lname in order:
                g = mw.create_group(lname)
                wts = self.weights.get(lname, {})
                g.attrs["weight_names"] = np.array(
                    [k.encode() for k in wts], dtype="S96")
                for wpath, arr in wts.items():
                    grp, ds = wpath.rsplit("/", 1)
                    g.require_group(grp).create_dataset(ds, data=arr)


_ACT = {"tanh": "tanh", "softsign": "softsign", "linear": "linear",
        "relu": "relu", "sigmoid": "sigmoid"}


def _emit_mlp_head(g: _Graph, spec, params, prev: str, prefix: str = "conv2d"
                   ) -> str:
    """Chain of 1x1 Conv2D layers from an MLPHead's dense params."""
    for i, (p, (cout, act)) in enumerate(zip(params["layers"], spec.layers)):
        name = prefix if i == 0 else f"{prefix}_{i}"
        w = np.asarray(p["w"], np.float32)           # (Cin, Cout)
        prev = g.conv2d(name, prev, w.reshape(1, 1, *w.shape),
                        np.asarray(p["b"], np.float32),
                        activation=_ACT[act])
    return prev


def _emit_residual_head(g: _Graph, spec, params, prev: str) -> str:
    """ResidualMLPHead as the reference's create_model_complex graph shape
    (Model-88/attention_model.py:97-169): 1x1 conv blocks + Add + ReLU."""
    def conv(name, p, act):
        w = np.asarray(p["w"], np.float32)
        return g.conv2d(name, prev_ref[0], w.reshape(1, 1, *w.shape),
                        np.asarray(p["b"], np.float32), activation=_ACT[act])

    prev_ref = [prev]
    prev_ref[0] = conv("conv2d", params["proj"], spec.activation)
    trunk = prev_ref[0]
    for b, blk in enumerate(params["blocks"]):
        prev_ref[0] = trunk
        prev_ref[0] = conv(f"conv2d_{2 * b + 1}", blk["fc1"], spec.activation)
        prev_ref[0] = conv(f"conv2d_{2 * b + 2}", blk["fc2"], spec.activation)
        added = g.add_layer(f"add_{b}" if b else "add", prev_ref[0], trunk)
        trunk = g.relu(f"re_lu_{b}" if b else "re_lu", added)
    prev_ref[0] = trunk
    prev_ref[0] = conv("conv2d_bottleneck", params["bottleneck"],
                       spec.activation)
    return conv("conv2d_out", params["out"], "linear")


def _emit_skip_head(g: _Graph, spec, params, prev: str) -> str:
    """SkipMLPHead (train_88.py create_model_skip_fc): enc1 -> enc2 -> dec
    with an Add skip from enc1, then the linear output conv."""
    def conv(name, p, src, act):
        w = np.asarray(p["w"], np.float32)
        return g.conv2d(name, src, w.reshape(1, 1, *w.shape),
                        np.asarray(p["b"], np.float32), activation=_ACT[act])

    e1 = conv("conv2d", params["enc1"], prev, spec.activation)
    e2 = conv("conv2d_1", params["enc2"], e1, spec.activation)
    dec = conv("conv2d_2", params["dec"], e2, spec.activation)
    added = g.add_layer("add", dec, e1)
    return conv("conv2d_3", params["out"], added, "linear")


def _emit_se_head(g: _Graph, spec, params, prev: str) -> str:
    """SEMLPHead (attention_model.py create_modelC): GAP -> Dense relu ->
    Dense sigmoid -> Reshape(1,1,C) -> Multiply gate, then 1x1 convs."""
    gap = g.add("GlobalAveragePooling2D", "global_average_pooling2d",
                {"data_format": "channels_last", "keepdims": False}, [prev])
    fc1 = g.add("Dense", "dense", {
        "units": int(np.asarray(params["se"]["fc1"]["w"]).shape[1]),
        "activation": "relu", "use_bias": True,
        "kernel_initializer": _init(), "bias_initializer": _init("Zeros"),
        "kernel_regularizer": None, "bias_regularizer": None,
        "activity_regularizer": None, "kernel_constraint": None,
        "bias_constraint": None,
    }, [gap], {"kernel": np.asarray(params["se"]["fc1"]["w"], np.float32),
               "bias": np.asarray(params["se"]["fc1"]["b"], np.float32)})
    fc2 = g.add("Dense", "dense_1", {
        "units": spec.in_features, "activation": "sigmoid", "use_bias": True,
        "kernel_initializer": _init(), "bias_initializer": _init("Zeros"),
        "kernel_regularizer": None, "bias_regularizer": None,
        "activity_regularizer": None, "kernel_constraint": None,
        "bias_constraint": None,
    }, [fc1], {"kernel": np.asarray(params["se"]["fc2"]["w"], np.float32),
               "bias": np.asarray(params["se"]["fc2"]["b"], np.float32)})
    gate = g.reshape("reshape", fc2, (1, 1, spec.in_features))
    gated = g.add("Multiply", "multiply", {}, [prev, gate])

    def conv(name, p, src, act):
        w = np.asarray(p["w"], np.float32)
        return g.conv2d(name, src, w.reshape(1, 1, *w.shape),
                        np.asarray(p["b"], np.float32), activation=_ACT[act])

    fc = conv("conv2d", params["fc"], gated, "relu")
    return conv("conv2d_1", params["out"], fc, "linear")


def _dense_cfg(units: int, activation: str) -> dict:
    return {"units": int(units), "activation": activation, "use_bias": True,
            "kernel_initializer": _init(), "bias_initializer": _init("Zeros"),
            "kernel_regularizer": None, "bias_regularizer": None,
            "activity_regularizer": None, "kernel_constraint": None,
            "bias_constraint": None}


def _emit_se_transformer_head(g: _Graph, spec, params, prev: str) -> str:
    """SETransformerHead as the reference's se_transformer_regr_head graph
    (Model-88/attention_model.py:16-80): SE gate -> Lambda flatten ->
    MultiHeadAttention + residual/LayerNorm -> FFN + residual/LayerNorm ->
    Lambda unflatten -> 1x1-conv regression.  Layer-for-layer the same
    serialized structure tf-keras writes for that builder (verified against a
    probe save in this container), including the marshalled-bytecode Lambda
    payloads.  Weight layouts map 1:1: our query/key/value (C, H, D) einsum
    params ARE Keras MultiHeadAttention's EinsumDense kernels."""
    x_in = prev
    C = spec.in_features
    se = params["se"]
    gap = g.add("GlobalAveragePooling2D", "global_average_pooling2d",
                {"data_format": "channels_last", "keepdims": False}, [x_in])
    fc1 = g.add("Dense", "dense",
                _dense_cfg(np.asarray(se["fc1"]["w"]).shape[1], "relu"),
                [gap], {"kernel": np.asarray(se["fc1"]["w"], np.float32),
                        "bias": np.asarray(se["fc1"]["b"], np.float32)})
    fc2 = g.add("Dense", "dense_1", _dense_cfg(C, "sigmoid"), [fc1],
                {"kernel": np.asarray(se["fc2"]["w"], np.float32),
                 "bias": np.asarray(se["fc2"]["b"], np.float32)})
    gate = g.reshape("reshape", fc2, (1, 1, C))
    gated = g.add("Multiply", "multiply", {}, [x_in, gate])

    def lam(name, fn, inbound):
        return g.add("Lambda", name, {
            "function": [_marshal_fn(fn), None, None],
            "function_type": "lambda", "module": __name__,
            "output_shape": None, "output_shape_type": "raw",
            "output_shape_module": None, "arguments": {},
        }, inbound)

    flat = lam("lambda", _lambda_reshape_flat, [gated])
    mha = g.add("MultiHeadAttention", "multi_head_attention", {
        "num_heads": spec.num_heads, "key_dim": spec.key_dim,
        "value_dim": spec.key_dim, "dropout": 0.0, "use_bias": True,
        "output_shape": None, "attention_axes": [1],
        "kernel_initializer": _init(), "bias_initializer": _init("Zeros"),
        "kernel_regularizer": None, "bias_regularizer": None,
        "activity_regularizer": None, "kernel_constraint": None,
        "bias_constraint": None,
        "query_shape": [None, None, C], "key_shape": [None, None, C],
        "value_shape": [None, None, C],
    }, None, {
        "query/kernel": np.asarray(params["query"]["w"], np.float32),
        "query/bias": np.asarray(params["query"]["b"], np.float32),
        "key/kernel": np.asarray(params["key"]["w"], np.float32),
        "key/bias": np.asarray(params["key"]["b"], np.float32),
        "value/kernel": np.asarray(params["value"]["w"], np.float32),
        "value/bias": np.asarray(params["value"]["b"], np.float32),
        "attention_output/kernel": np.asarray(params["attn_out"]["w"], np.float32),
        "attention_output/bias": np.asarray(params["attn_out"]["b"], np.float32),
    }, raw_inbound=[[[flat, 0, 0, {"value": [flat, 0, 0]}]]])

    def layernorm(name, p, inbound):
        return g.add("LayerNormalization", name, {
            "axis": [2], "epsilon": 0.001, "center": True, "scale": True,
            "beta_initializer": _init("Zeros"), "gamma_initializer": _init("Ones"),
            "beta_regularizer": None, "gamma_regularizer": None,
            "beta_constraint": None, "gamma_constraint": None,
        }, inbound, {"gamma": np.asarray(p["g"], np.float32),
                     "beta": np.asarray(p["b"], np.float32)})

    a1 = g.add("Add", "add", {}, [flat, mha])
    ln1 = layernorm("layer_normalization", params["ln1"], [a1])
    ff1 = g.add("Dense", "dense_2", _dense_cfg(spec.ff_dim, "relu"), [ln1],
                {"kernel": np.asarray(params["ff1"]["w"], np.float32),
                 "bias": np.asarray(params["ff1"]["b"], np.float32)})
    ff2 = g.add("Dense", "dense_3", _dense_cfg(C, "linear"), [ff1],
                {"kernel": np.asarray(params["ff2"]["w"], np.float32),
                 "bias": np.asarray(params["ff2"]["b"], np.float32)})
    a2 = g.add("Add", "add_1", {}, [ln1, ff2])
    ln2 = layernorm("layer_normalization_1", params["ln2"], [a2])
    back = lam("lambda_1", _lambda_reshape_back, [ln2, x_in])

    w_fc = np.asarray(params["fc"]["w"], np.float32)
    hid = g.conv2d("conv2d", back, w_fc.reshape(1, 1, *w_fc.shape),
                   np.asarray(params["fc"]["b"], np.float32), activation="relu")
    w_out = np.asarray(params["out"]["w"], np.float32)
    return g.conv2d("conv2d_1", hid, w_out.reshape(1, 1, *w_out.shape),
                    np.asarray(params["out"]["b"], np.float32),
                    activation="linear")


def _emit_head(g: _Graph, spec, params, prev: str) -> str:
    """Emit any head family into the graph, returning its output layer."""
    from ..models.heads import (EnsembleHead, MLPHead, ResidualMLPHead,
                                SEMLPHead, SETransformerHead, SkipMLPHead)

    if isinstance(spec, MLPHead):
        return _emit_mlp_head(g, spec, params, prev)
    if isinstance(spec, ResidualMLPHead):
        return _emit_residual_head(g, spec, params, prev)
    if isinstance(spec, SkipMLPHead):
        return _emit_skip_head(g, spec, params, prev)
    if isinstance(spec, SEMLPHead):
        return _emit_se_head(g, spec, params, prev)
    if isinstance(spec, SETransformerHead):
        return _emit_se_transformer_head(g, spec, params, prev)
    if isinstance(spec, EnsembleHead):
        # members side by side off the shared input, joined by an Average
        # layer (the Keras spelling of models.heads.EnsembleHead.apply) —
        # or, for a stacked ensemble, Concatenate + a fixed 1x1 Conv2D whose
        # block-diagonal kernel carries the per-member per-angle weights and
        # whose bias carries the stack intercept
        outer = g.prefix
        outs = []
        for k, (m, mp) in enumerate(zip(spec.members, params["members"])):
            g.prefix = f"{outer}m{k}_"
            outs.append(_emit_head(g, m, mp, prev))
        g.prefix = outer
        if spec.weights is None:
            return g.add("Average", "average", {}, outs)
        cat = g.add("Concatenate", "stack_concat", {"axis": -1}, outs)
        n = len(spec.members)
        kernel = np.zeros((1, 1, 3 * n, 3), np.float32)
        for k, row in enumerate(spec.weights):
            for a, w in enumerate(row):
                kernel[0, 0, 3 * k + a, a] = w
        bias = np.asarray(spec.bias or (0.0, 0.0, 0.0), np.float32)
        return g.conv2d("stack_combine", cat, kernel, bias)
    raise NotImplementedError(
        f"H5 export not implemented for {type(spec).__name__}")


def save_head_h5(spec, params, path: str, *, name: str = "model") -> None:
    """Export a pose head as a Keras-2 H5 with dynamic (None, None, C) input —
    the reference's converted "NoFlatten" head format, directly consumable by
    JoinModels.py and InputShapeConvertor.py.  Supports all five families —
    MLP, residual, skip, SE, and SE-Transformer (the latter with
    marshalled-bytecode Lambda layers, exactly the serialization the
    reference's own builder produces; such files load only under the CPython
    version that wrote them — a limitation inherited from the format, shared
    by the reference's shipped MHA artifacts) — plus EnsembleHead averages of
    any of them (members emitted side by side under `m{k}_` name prefixes,
    joined by a Keras `Average` layer)."""
    g = _Graph(name)
    inp = g.input("input_1", (None, None, None, spec.in_features))
    out = _emit_head(g, spec, params, inp)
    g.save(path, [out], [inp])


def save_unified_h5(model, params, path: str) -> None:
    """Export a UnifiedPoseModel (BlazeFace + grafted pose heads) as the
    reference's 6-output unified H5 (JoinModels.py:152-158 contract):
    cls_front (B,512,1), cls_back (B,384,1), loc_front (B,512,16),
    loc_back (B,384,16), pose_front (B,16,16,3), pose_back (B,8,8,3)."""
    spec = model.backbone
    bp = params["backbone"]
    g = _Graph("unified")
    inp = g.input("input", (None, spec.input_size, spec.input_size, 3))

    y = g.conv2d("conv2d", inp, bp["stem"]["kernel"], bp["stem"]["bias"],
                 strides=(2, 2), activation="relu")
    feat88 = None
    npad = 0
    for i, cout in enumerate(spec.block_channels):
        blk = bp["blocks"][i]
        cin = int(np.asarray(blk["dw_kernel"]).shape[-1])
        s2 = i in spec.downsample_blocks
        dwk = np.asarray(blk["dw_kernel"]).reshape(3, 3, cin, 1)
        dw = g.depthwise2d(f"depthwise_conv2d_{i}" if i else "depthwise_conv2d",
                           y, dwk, blk["dw_bias"],
                           strides=(2, 2) if s2 else (1, 1))
        pw = g.conv2d(f"conv2d_{i + 1}", dw, blk["pw_kernel"], blk["pw_bias"])
        skip = g.maxpool(f"max_pooling2d_{npad}" if npad else "max_pooling2d",
                         y) if s2 else y
        if cout > cin:
            skip = g.channel_pad(f"Pad_{i}", skip, cout - cin)
        if s2:
            npad += 1
        added = g.add_layer(f"add_{i}" if i else "add", pw, skip)
        y = g.relu(f"re_lu_{i}" if i else "re_lu", added)
        if i == spec.tap88_block:
            feat88 = y
    feat96 = y

    # SSD-head conv names continue the backbone numbering (the block loop
    # emits conv2d_1..conv2d_N): conv2d_17..20 for the 16-block front spec,
    # shifted for larger specs (e.g. the 17-block back spec) — hardcoding 17
    # would collide with the last block's pointwise conv and silently
    # overwrite its weights in the H5
    n = len(spec.block_channels)
    cls_f = g.conv2d(f"conv2d_{n + 1}", feat88, bp["cls_front"]["kernel"],
                     bp["cls_front"]["bias"])
    cls_b = g.conv2d(f"conv2d_{n + 2}", feat96, bp["cls_back"]["kernel"],
                     bp["cls_back"]["bias"])
    loc_f = g.conv2d(f"conv2d_{n + 3}", feat88, bp["loc_front"]["kernel"],
                     bp["loc_front"]["bias"])
    loc_b = g.conv2d(f"conv2d_{n + 4}", feat96, bp["loc_back"]["kernel"],
                     bp["loc_back"]["bias"])
    o_cls_f = g.reshape("classificators_1", cls_f, (512, 1))
    o_cls_b = g.reshape("classificators_2", cls_b, (384, 1))
    o_loc_f = g.reshape("regressors_1", loc_f, (512, 16))
    o_loc_b = g.reshape("regressors_2", loc_b, (384, 16))
    # pose heads under pose1_/pose2_ name prefixes (any family, incl.
    # ensembles); for MLP chains this yields the same pose1_conv2d_i names
    # as always
    g.prefix = "pose1_"
    pose_f = _emit_head(g, model.head88, params["head88"], feat88)
    g.prefix = "pose2_"
    pose_b = _emit_head(g, model.head96, params["head96"], feat96)
    g.prefix = ""
    g.save(path, [o_cls_f, o_cls_b, o_loc_f, o_loc_b, pose_f, pose_b], [inp])


def keras3_custom_objects() -> dict:
    """custom_objects dict that lets STOCK Keras 3 load this module's
    SE-Transformer exports (``keras.models.load_model(path, compile=False,
    safe_mode=False, custom_objects=keras3_custom_objects())``).

    The conv/dense head families (mlp / residual / skip / se / ensemble)
    load in Keras 3 with no help — its legacy-H5 reader handles them.  The
    unified detector graph needs only the TensorFlowOpLayer shim below (its
    channel-pad skip nodes); the attention family trips three further gaps
    in that reader, each patched here by a thin subclass:

      * MultiHeadAttention.from_config: tf-keras REQUIRES the serialized
        query/key/value_shape keys (multi_head_attention.py:314-316 pops
        them unconditionally) while Keras 3's constructor REJECTS them —
        one static config cannot satisfy both, so the subclass pops them.
      * Legacy marshalled Lambda bytecode is loaded with keras-internal
        module globals that do not bind ``tf``, so the flatten/unflatten
        payloads (which call tf.reshape, matching the reference builder
        Model-88/attention_model.py:40-47) raise NameError; the subclass
        unmarshals with ``tf``/``keras``/``np`` bound and infers the output
        shape by tracing the function with tf.function when Keras 3's
        generic inference gives up.
      * Keras 3's legacy node processor leaves KWARG tensor references
        (``{'value': [layer, 0, 0]}``) unresolved.  Every MHA node this
        format family produces is self-attention (ours and the reference's:
        attention_model.py:52 calls mha(x, x)), so an unresolved ref
        resolves to the query tensor.

    Like any consumer of this Lambda dialect (tf-keras included), loading
    EXECUTES marshalled bytecode — only load trusted files — and works only
    under the CPython version that wrote them (the reference's shipped MHA
    artifacts were marshalled elsewhere, so no Keras in this container can
    load them; ``core.load_graph_model`` can, because it re-derives the
    lambdas structurally instead of unmarshalling)."""
    import types

    import keras
    import tensorflow as tf  # noqa: F401 — bound into the lambda globals

    def _func_load(code: str, defaults, closure):
        raw = codecs.decode(code.encode("ascii"), "base64")
        if closure is not None:
            def _cell(v):
                return (lambda: v).__closure__[0]
            closure = tuple(_cell(v) for v in closure)
        globs = {"tf": tf, "keras": keras, "np": np}
        return types.FunctionType(marshal.loads(raw), globs,
                                  argdefs=defaults, closure=closure)

    def _is_legacy_ref(x):
        # an unresolved legacy inbound-node entry: [layer_name, node, tensor]
        return (isinstance(x, (list, tuple)) and len(x) in (3, 4)
                and isinstance(x[0], str))

    class _MHA(keras.layers.MultiHeadAttention):
        @classmethod
        def from_config(cls, config):
            for k in ("query_shape", "key_shape", "value_shape"):
                config.pop(k, None)
            return cls(**config)

        def build(self, query_shape, value_shape=None, key_shape=None):
            if value_shape is None:  # self-attention: value rode a kwarg ref
                value_shape = query_shape
            super().build(query_shape, value_shape, key_shape)

        def __call__(self, query, value=None, key=None, **kwargs):
            if value is None or _is_legacy_ref(value):
                value = query
            if _is_legacy_ref(key):
                key = None
            return super().__call__(query, value, key=key, **kwargs)

    class _Lambda(keras.layers.Lambda):
        @classmethod
        def from_config(cls, config, custom_objects=None, safe_mode=None):
            fn_cfg = config.get("function")
            if (isinstance(fn_cfg, dict)
                    and fn_cfg.get("class_name") == "__lambda__"):
                inner = fn_cfg["config"]
                config = dict(config)
                config["function"] = _func_load(
                    inner["code"], inner["defaults"], inner["closure"])
                return cls(**config)
            return super().from_config(config, custom_objects=custom_objects,
                                       safe_mode=safe_mode)

        def compute_output_shape(self, input_shape):
            try:
                return super().compute_output_shape(input_shape)
            except NotImplementedError:
                # trace the tf-coded payload for real: Keras 3's generic
                # inference feeds KerasTensors, which tf.shape rejects
                def to_spec(s):
                    return tf.TensorSpec(tuple(s), tf.float32)
                if (isinstance(input_shape, (list, tuple)) and input_shape
                        and isinstance(input_shape[0], (list, tuple))):
                    arg = [to_spec(s) for s in input_shape]
                else:
                    arg = to_spec(input_shape)
                cf = tf.function(self.function).get_concrete_function(arg)
                return tuple(cf.structured_outputs.shape)

    class _TFOpLayer(keras.layers.Layer):
        """Keras 3 stand-in for tf-keras's TensorFlowOpLayer, covering the
        one node this exporter (and the reference backbone it mirrors)
        embeds: a Pad op with constant paddings — the channel-growing skip
        connections (blazeFaceDetectorH5.py's saved graph)."""

        def __init__(self, *, node_def, constants=None, name=None, **kwargs):
            super().__init__(name=name, **kwargs)
            if node_def.get("op") != "Pad":
                raise NotImplementedError(
                    f"TensorFlowOpLayer op {node_def.get('op')!r} — only the "
                    "constant-paddings Pad node is supported")
            self._node_def = node_def
            self._constants = constants or {}
            pad = (constants or {}).get("1")
            if pad is None:
                raise ValueError("Pad TensorFlowOpLayer without constant "
                                 "paddings (constants['1']) is unsupported")
            self._paddings = [tuple(int(v) for v in row) for row in pad]

        def call(self, x):
            return keras.ops.pad(x, self._paddings)

        def compute_output_shape(self, input_shape):
            return tuple(
                None if d is None else d + lo + hi
                for d, (lo, hi) in zip(input_shape, self._paddings))

        def get_config(self):
            cfg = super().get_config()
            cfg.update({"node_def": self._node_def,
                        "constants": self._constants})
            return cfg

    return {"MultiHeadAttention": _MHA, "Lambda": _Lambda,
            "TensorFlowOpLayer": _TFOpLayer}


def main(argv: list[str] | None = None) -> None:
    """CLI: export the flagship (or a native model dir) to a Keras-2 H5.

    python -m headpose_tpu_torch.tools.h5export out.h5 [native_model_dir]
    """
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("output", help="destination .h5 path")
    ap.add_argument("model_dir", nargs="?", default=None,
                    help="native model dir (tools.export format); "
                         "default: the shipped flagship")
    args = ap.parse_args(argv)
    if args.model_dir:
        from .export import load_model
        model, params = load_model(args.model_dir)
    else:
        from ..pretrained import load_flagship
        model, params = load_flagship()
    save_unified_h5(model, params, args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
