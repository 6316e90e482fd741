"""Keras H5 reader, the port's own copy (numpy; h5py to open a file).

Port of headpose_tpu/core/h5io.py.  A Keras-2 ``.h5`` artifact holds its
graph as the ``model_config`` JSON attribute and its arrays in the
``model_weights`` group; a Keras 3 ``.keras`` archive holds a
``config.json`` and a positional weight store.  Both parse into a
`ModelDef` without Keras.

Reading is split in two:

  * the h5py part (`_read_parts`): the ``model_config`` JSON and a
    ``{weight path: array}`` dict of ``model_weights``, each array keyed by
    its path under the group, e.g. ``conv2d/conv2d/kernel:0``;
  * `_model_from_parts(config, weights)`: the graph parse and the routing of
    each array to its layer, nested submodels included.  It needs no h5py,
    so a model whose config and weights were saved apart (a JSON file and an
    ``.npz``) loads where h5py is absent.

h5py is imported only inside the functions that open a file, so this module
and the graph compiler import without it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np

__all__ = ["LayerDef", "ModelDef", "read_model"]


@dataclasses.dataclass
class LayerDef:
    """One node of a Keras functional graph."""

    name: str
    class_name: str
    config: dict[str, Any]
    # Per call-node list of (layer_name, node_index, tensor_index) inputs.
    inbound: list[list[tuple[str, int, int]]]
    weights: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    # Present when class_name is Functional/Model: the nested sub-model.
    submodel: "ModelDef | None" = None
    # Per call-node non-tensor kwargs (TFOpLambda scalars like y=2.0).
    call_kwargs: list[dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ModelDef:
    """A parsed functional model: layers plus input/output tensor refs."""

    name: str
    layers: dict[str, LayerDef]
    order: list[str]  # topological order as saved
    inputs: list[tuple[str, int, int]]
    outputs: list[tuple[str, int, int]]
    # True when the graph was written by Keras 3 (kwargs-style dict inbound
    # nodes).  The dialects number nested-submodel call nodes differently:
    # tf-keras counts the inner graph's construction as node 0, so the first
    # outer call is node 1; Keras 3 numbers outer calls from 0.  The
    # compiler keys produced values accordingly.
    keras3: bool = False

    def param_count(self) -> int:
        n = 0
        for layer in self.layers.values():
            n += sum(int(np.prod(w.shape)) for w in layer.weights.values())
            if layer.submodel is not None:
                n += layer.submodel.param_count()
        return n


def _parse_inbound(raw) -> tuple[list[list[tuple[str, int, int]]],
                                 list[dict]]:
    """Normalize Keras inbound_nodes into per-call ref lists + kwargs.

    Three on-disk shapes exist: classic nested `[[["prev", 0, 0, {}], ...]]`,
    TFOpLambda's flat call `[["prev", 0, 0, {"y": 2.0}]]` (the whole call is
    one ref whose 4th element carries non-tensor kwargs), and the newer
    kwargs-style dict nodes."""
    def arg_refs(a, refs):
        """Keras-tensor refs of one saved positional arg (a Keras-tensor
        dict, or a list of them, e.g. tf.concat's tensor list)."""
        if isinstance(a, dict) and "config" in a:
            kh = a["config"].get("keras_history")
            if kh:
                refs.append((kh[0], int(kh[1]), int(kh[2])))
        elif isinstance(a, list):
            for e in a:
                arg_refs(e, refs)

    def consume_kwargs(d: dict, kwarg_refs, kw, seen):
        """Fold one saved call-kwargs dict into (kwarg_refs, kw).

        Non-tensor kwargs (axis=..., keepdims=...) are kept: dropping one
        changes the op (tf.concat's axis would fall back to 0).  A tensor
        kwarg (tf.math.add's y=) arrives as a nested Keras-tensor dict or,
        in the flat and classic formats, as a bare [layer, node, idx]
        triple; both become inbound refs, after every positional ref, kept
        as (name, ref) so that order-sensitive pairs can be put in call
        order.  `seen` drops the copies the classic format writes on every
        positional item of a call."""
        for k, v in d.items():
            if k == "name" or v is None or k in seen:
                continue
            seen.add(k)
            if isinstance(v, dict) and "config" in v:
                kh = v["config"].get("keras_history")
                if kh:
                    kwarg_refs.append((k, (kh[0], int(kh[1]), int(kh[2]))))
                    continue
            if (isinstance(v, list) and len(v) == 3 and isinstance(v[0], str)
                    and not isinstance(v[1], (list, dict, str))):
                kwarg_refs.append((k, (v[0], int(v[1]), int(v[2]))))
                continue
            kw[k] = v

    nodes, kwargs = [], []
    for call in raw or []:
        refs, kwarg_refs, kw, seen = [], [], {}, set()
        if isinstance(call, list) and call and isinstance(call[0], str):
            # flat TFOpLambda-style call: one ref + kwargs
            refs.append((call[0], int(call[1]), int(call[2])))
            if len(call) > 3 and isinstance(call[3], dict):
                consume_kwargs(call[3], kwarg_refs, kw, seen)
        else:
            # a call node is a list of items (tf-keras) or, in Keras 3's
            # writer, one bare kwargs-style dict
            for item in ([call] if isinstance(call, dict) else call):
                if isinstance(item, list):
                    refs.append((item[0], int(item[1]), int(item[2])))
                    if len(item) > 3 and isinstance(item[3], dict):
                        consume_kwargs(item[3], kwarg_refs, kw, seen)
                elif isinstance(item, dict):  # kwargs-style node
                    for a in item.get("args", []):
                        arg_refs(a, refs)
                    consume_kwargs(item.get("kwargs") or {}, kwarg_refs, kw,
                                   seen)
        # MultiHeadAttention's call(query, value, key): 'value' precedes
        # 'key' whichever order the user passed them (a stable sort, so
        # every other kwarg keeps its place)
        kwarg_refs.sort(key=lambda kv: 1 if kv[0] == "key" else 0)
        nodes.append(refs + [ref for _, ref in kwarg_refs])
        kwargs.append(kw)
    return nodes, kwargs


def _parse_ref_list(raw) -> list[tuple[str, int, int]]:
    if (isinstance(raw, list) and len(raw) == 3 and isinstance(raw[0], str)
            and not isinstance(raw[1], (list, str))):
        # Keras 3's legacy-H5 writer flattens a single-entry ref list to one
        # bare [name, node, idx] triple
        raw = [raw]
    return [(r[0], int(r[1]), int(r[2])) for r in raw]


def _is_keras3_nodes(raw) -> bool:
    """True when a raw inbound_nodes value uses Keras 3's kwargs-style dict
    call format (tf-keras and Keras 2 write list nodes)."""
    for call in raw or []:
        if isinstance(call, dict):
            return True
        if isinstance(call, list) and any(
                isinstance(item, dict) and ("args" in item or "kwargs" in item)
                for item in call):
            return True
    return False


def _parse_graph(name: str, cfg: dict) -> ModelDef:
    layers: dict[str, LayerDef] = {}
    order: list[str] = []
    keras3 = False
    for lraw in cfg["layers"]:
        lname = lraw["name"]
        cls = lraw["class_name"]
        lconf = lraw.get("config", {})
        sub = None
        if cls in ("Functional", "Model"):
            sub = _parse_graph(lname, lconf if "layers" in lconf
                               else lconf["config"])
        keras3 = keras3 or _is_keras3_nodes(lraw.get("inbound_nodes"))
        inbound, call_kwargs = _parse_inbound(lraw.get("inbound_nodes"))
        layers[lname] = LayerDef(name=lname, class_name=cls, config=lconf,
                                 inbound=inbound, submodel=sub,
                                 call_kwargs=call_kwargs)
        order.append(lname)
    return ModelDef(name=name, layers=layers, order=order,
                    inputs=_parse_ref_list(cfg["input_layers"]),
                    outputs=_parse_ref_list(cfg["output_layers"]),
                    keras3=keras3)


def _weight_key(path_parts: list[str]) -> str:
    """Short weight key from an H5 weight path: 'conv2d/kernel:0' →
    'kernel'; MultiHeadAttention paths keep one level of qualification,
    '.../query/kernel:0' → 'query/kernel'."""
    short = path_parts[-1]
    short = short[:-2] if short.endswith(":0") else short
    if len(path_parts) >= 3:
        short = path_parts[-2] + "/" + short
    return short


def _route_weight(model: ModelDef, parts: list[str], arr: np.ndarray) -> None:
    """Attach one weight array, descending through nested submodels by
    path.  An unroutable weight raises: dropping one (a bias) would load a
    model that runs but computes wrong values."""
    layer = model.layers.get(parts[0])
    if layer is None:
        raise ValueError(
            f"weight path {'/'.join(parts)!r} does not match any layer of "
            f"model {model.name!r}")
    if layer.submodel is not None and len(parts) > 2:
        _route_weight(layer.submodel, parts[1:], arr)
    else:
        layer.weights[_weight_key(parts)] = arr


def _model_from_parts(config: dict, weights: dict[str, np.ndarray]
                      ) -> ModelDef:
    """A ModelDef from a ``model_config`` dict and the ``{path: array}`` of
    ``model_weights`` (paths as `_read_parts` keys them, the layer's group
    first).  Arrays of a group that is no layer of the graph are ignored, as
    the reader skips such groups."""
    model = _parse_graph(config["config"].get("name", "model"),
                         config["config"])
    for path, arr in weights.items():
        lname, wname = path.split("/", 1)
        layer = model.layers.get(lname)
        if layer is None:
            continue
        parts = wname.split("/")
        if layer.submodel is not None:
            _route_weight(layer.submodel, parts, np.asarray(arr))
        else:
            layer.weights[_weight_key(parts)] = np.asarray(arr)
    return model


def _read_parts(path: str) -> tuple[dict, dict[str, np.ndarray]]:
    """(model_config dict, {weight path: array}) of a Keras H5 file: each
    layer's ``weight_names``, in the graph's layer order, keyed
    ``<layer group>/<weight name>``."""
    import h5py

    with h5py.File(path, "r") as f:
        config = json.loads(f.attrs["model_config"])
        group = f["model_weights"]
        weights = {}
        for lraw in config["config"]["layers"]:
            lname = lraw["name"]
            if lname not in group:
                continue
            lgroup = group[lname]
            names = lgroup.attrs.get("weight_names")
            if names is None:
                continue
            for wname in names:
                wname = wname.decode() if isinstance(wname, bytes) else wname
                weights[f"{lname}/{wname}"] = np.asarray(lgroup[wname])
    return config, weights


def _keras3_var_names(layer: LayerDef) -> list[str]:
    """Positional variable names for one layer class in Keras 3's native
    ``.keras`` weight store (``layers/<name>/vars/0..N``, in the order
    build() creates them).  Flag-dependent variables (bias, gamma, beta)
    are included only when the saved config enables them."""
    cls, cfg = layer.class_name, layer.config
    bias = ["bias"] if cfg.get("use_bias", True) else []
    if cls in ("Conv2D", "Conv2DTranspose", "Dense", "DepthwiseConv2D"):
        return ["kernel"] + bias
    if cls == "SeparableConv2D":
        return ["depthwise_kernel", "pointwise_kernel"] + bias
    if cls in ("BatchNormalization", "LayerNormalization"):
        names = []
        if cfg.get("scale", True):
            names.append("gamma")
        if cfg.get("center", True):
            names.append("beta")
        if cls == "BatchNormalization":
            names += ["moving_mean", "moving_variance"]
        return names
    if cls == "Embedding":
        return ["embeddings"]
    raise NotImplementedError(
        f"no Keras-3 variable-name mapping for layer class {cls!r} "
        f"({layer.name!r}) — cannot attach its saved weights")


def _snake_case(name: str) -> str:
    import re

    name = re.sub(r"\W+", "", name)
    name = re.sub(r"(.)([A-Z][a-z]+)", r"\1_\2", name)
    return re.sub(r"([a-z])([A-Z])", r"\1_\2", name).lower()


def _attach_keras3_weights(model: ModelDef, layers_group) -> None:
    """Attach arrays from a ``.keras`` archive's positional weight store.

    The store does not key groups by layer.name: each group is named
    snake_case(class name) with a per-container counter, in model.layers
    order, which the parsed graph order regenerates."""
    import h5py

    used: dict[str, int] = {}
    for lname in model.order:
        layer = model.layers[lname]
        base = _snake_case(layer.class_name)
        if base in used:
            used[base] += 1
            store = f"{base}_{used[base]}"
        else:
            used[base] = 0
            store = base
        if store not in layers_group:
            continue
        lgroup = layers_group[store]
        if layer.submodel is not None and "layers" in lgroup:
            _attach_keras3_weights(layer.submodel, lgroup["layers"])
            continue
        vgroup = lgroup["vars"] if "vars" in lgroup else None
        n = len(vgroup) if vgroup is not None else 0
        if n == 0:
            # a weightless layer stores nothing; a layer whose variables
            # live in sublayer groups must not load empty: map the known
            # layouts, refuse the rest
            sub = {k: v for k, v in lgroup.items()
                   if isinstance(v, h5py.Group) and len(v.get("vars", ()))}
            if not sub:
                continue
            if layer.class_name == "MultiHeadAttention":
                for store_name, key in (("query_dense", "query"),
                                        ("key_dense", "key"),
                                        ("value_dense", "value"),
                                        ("output_dense", "attention_output")):
                    sv = lgroup[store_name]["vars"]
                    layer.weights[f"{key}/kernel"] = np.asarray(sv["0"])
                    if "1" in sv:  # absent when use_bias=False
                        layer.weights[f"{key}/bias"] = np.asarray(sv["1"])
                continue
            raise NotImplementedError(
                f"layer {lname!r} ({layer.class_name}) stores its variables "
                f"in sublayer groups {sorted(sub)} — no mapping to this "
                "module's weight keys; refusing to load it empty")
        names = _keras3_var_names(layer)
        if n != len(names):
            raise ValueError(
                f"layer {lname!r} ({layer.class_name}) stores {n} variables "
                f"but the config implies {len(names)} ({names}) — refusing "
                "to guess the positional mapping")
        for i, wname in enumerate(names):
            layer.weights[wname] = np.asarray(vgroup[str(i)])


def _read_keras3_archive(path: str) -> ModelDef:
    """Parse a Keras 3 native ``.keras`` zip (config.json +
    model.weights.h5): the graph is the legacy-H5 dialect, the weight store
    positional."""
    import io
    import zipfile

    import h5py

    with zipfile.ZipFile(path) as z:
        cfg = json.loads(z.read("config.json"))
        model = _parse_graph(cfg["config"].get("name", "model"), cfg["config"])
        with h5py.File(io.BytesIO(z.read("model.weights.h5")), "r") as f:
            root = (f["layers"] if "layers" in f
                    else f["_layer_checkpoint_dependencies"])
            _attach_keras3_weights(model, root)
    return model


def read_model(path: str) -> ModelDef:
    """Parse a Keras H5 file (or a Keras 3 ``.keras`` archive) into a
    ModelDef without any Keras dependency.  Needs h5py."""
    import zipfile

    if zipfile.is_zipfile(path):
        return _read_keras3_archive(path)
    return _model_from_parts(*_read_parts(path))


def _as_modeldef(source) -> ModelDef:
    """A ModelDef as it is, or a path read by `read_model`: the loaders
    take either, so a model parsed once (or parsed without h5py through
    `_model_from_parts`) needs no file."""
    return source if isinstance(source, ModelDef) else read_model(source)
