"""The port's Keras H5 reader (headpose_tpu_torch.core.h5io) against the
JAX package's on the committed fixtures (tests/golden_torch, written by
make_h5_fixtures.py), on a flat export and Keras 3 files written here, and
on JAX's inbound-parser cases; the h5py-free twin of each fixture parses to
the same ModelDef."""
import json
import os

import numpy as np
import pytest

from headpose_tpu.core import h5io as J
from headpose_tpu_torch.core import h5io as T

FIXTURES = os.path.join(os.path.dirname(__file__), "golden_torch")
NAMES = ("flagship_joined", "se_transformer_head", "head96")


def assert_same_model(got, want, where="model"):
    """Same order, class names, configs, inbound, call kwargs, dialect,
    inputs/outputs, and every weight bit for bit, nested submodels too."""
    assert got.name == want.name, where
    assert got.order == want.order, where
    assert got.keras3 == want.keras3, where
    assert got.inputs == want.inputs and got.outputs == want.outputs, where
    for name in want.order:
        g, w = got.layers[name], want.layers[name]
        at = f"{where}/{name}"
        assert g.class_name == w.class_name, at
        assert g.config == w.config, at
        assert g.inbound == w.inbound, at
        assert g.call_kwargs == w.call_kwargs, at
        assert list(g.weights) == list(w.weights), at
        for k, v in w.weights.items():
            assert g.weights[k].dtype == v.dtype, f"{at}/{k}"
            assert g.weights[k].tobytes() == v.tobytes(), f"{at}/{k}"
        assert (g.submodel is None) == (w.submodel is None), at
        if w.submodel is not None:
            assert_same_model(g.submodel, w.submodel, at)
    assert got.param_count() == want.param_count()


def twin(name):
    with open(os.path.join(FIXTURES, f"{name}_config.json")) as f:
        config = json.load(f)
    with np.load(os.path.join(FIXTURES, f"{name}_weights.npz")) as w:
        return config, {k: w[k] for k in w.files}


@pytest.mark.parametrize("name", NAMES)
def test_read_model_matches_jax_on_fixtures(name):
    path = os.path.join(FIXTURES, f"{name}.h5")
    assert_same_model(T.read_model(path), J.read_model(path))


@pytest.mark.parametrize("name", NAMES)
def test_twin_parses_to_the_same_modeldef(name):
    """_model_from_parts(config, weights) of the h5py-free twin equals
    read_model of the H5 file, the port's and JAX's."""
    md = T._model_from_parts(*twin(name))
    path = os.path.join(FIXTURES, f"{name}.h5")
    assert_same_model(md, T.read_model(path))
    assert_same_model(md, J.read_model(path))
    if name == "flagship_joined":
        assert len(twin(name)[1]) == 84
        assert [n for n in md.order if md.layers[n].submodel] == ["reg1",
                                                                  "reg2"]


def test_read_model_matches_jax_on_flat_export(tmp_path):
    """JAX's flat unified export (the heads inlined under pose1_/pose2_,
    the channel pads as TensorFlowOpLayer)."""
    from headpose_tpu.pretrained import load_flagship
    from headpose_tpu.tools.h5export import save_unified_h5

    path = str(tmp_path / "flat.h5")
    save_unified_h5(*load_flagship(), path)
    md = T.read_model(path)
    assert_same_model(md, J.read_model(path))
    assert not any(layer.submodel for layer in md.layers.values())
    assert "TensorFlowOpLayer" in {l.class_name for l in md.layers.values()}


@pytest.mark.heavy
@pytest.mark.parametrize("suffix", ["h5", "keras"])
def test_read_model_matches_jax_on_keras3(tmp_path, suffix):
    """Keras 3's legacy H5 (dict call nodes, bare ref triples) and its
    native .keras archive (positional weight store, MultiHeadAttention's
    sublayer groups, a twice-called nested submodel)."""
    keras3 = pytest.importorskip("keras")
    if not keras3.__version__.startswith("3"):
        pytest.skip("stock keras is not Keras 3 here")
    si = keras3.Input(shape=(6, 16), name="sub_in")
    sub = keras3.Model(si, keras3.layers.Dense(16, activation="tanh")(si),
                       name="subnet")
    inp = keras3.Input(shape=(6, 16))
    y = sub(sub(inp))
    a = keras3.layers.MultiHeadAttention(num_heads=2, key_dim=8)(y, y)
    b = keras3.layers.LayerNormalization()(y + a)
    c = keras3.layers.BatchNormalization(scale=False)(b)
    out = keras3.layers.Dense(3)(c)
    path = str(tmp_path / f"m.{suffix}")
    keras3.Model(inp, out).save(path)
    md = T.read_model(path)
    assert_same_model(md, J.read_model(path))
    assert md.keras3


def _kt(name):
    return {"class_name": "__keras_tensor__",
            "config": {"keras_history": [name, 0, 0]}}


INBOUND_CASES = {
    "flat_call_scalar_and_tensor_kwargs":
        [["prev", 0, 0, {"axis": 3, "y": ["other", 1, 2], "name": "ignored",
                         "skipme": None}]],
    "classic_nested_with_replicated_item_kwargs":
        [[["a", 0, 0, {"axis": 3}], ["b", 0, 0, {"axis": 3}]]],
    "tensor_kwarg_lands_after_all_positionals":
        [[["a", 0, 0, {"y": ["kw", 0, 0]}], ["b", 0, 0, {"y": ["kw", 0, 0]}]]],
    "numeric_list_kwarg_is_not_a_ref":
        [["prev", 0, 0, {"axis": [1, 2], "shape": [1, 2, 3]}]],
    "dict_style_list_valued_arg":
        [[{"args": [[_kt("a"), _kt("b")]], "kwargs": {"axis": -1}}]],
    "dict_style_tensor_kwarg":
        [[{"args": [{"config": {"keras_history": ["a", 0, 0]}}],
           "kwargs": {"y": _kt("kw")}}]],
    "mha_key_before_value_kwargs":
        [[["q", 0, 0, {"key": ["k", 0, 0], "value": ["v", 0, 0]}]]],
    "bare_keras3_dict_node":
        {"args": [_kt("a")], "kwargs": {"training": False}},
    "empty": None,
}


@pytest.mark.parametrize("case", sorted(INBOUND_CASES))
def test_parse_inbound_matches_jax(case):
    raw = INBOUND_CASES[case]
    if isinstance(raw, dict):
        raw = [raw]
    assert T._parse_inbound(raw) == J._parse_inbound(raw)
    assert T._is_keras3_nodes(raw) == J._is_keras3_nodes(raw)


def test_unroutable_weight_raises_as_jax():
    """A weight path naming no layer of a submodel raises, in both."""
    config, weights = twin("flagship_joined")
    weights["reg1/no_such_layer/kernel:0"] = np.zeros(1, np.float32)
    with pytest.raises(ValueError, match="does not match any layer"):
        T._model_from_parts(config, weights)
    md = J._parse_graph("m", config["config"])
    with pytest.raises(ValueError, match="does not match any layer"):
        J._route_weight(md.layers["reg1"].submodel,
                        ["no_such_layer", "kernel:0"], np.zeros(1))
