"""The port's Keras-H5 exporter (headpose_tpu_torch/tools/h5export.py)
against the JAX package's (headpose_tpu/tools/h5export.py): the same model
written by both is the same file — model config, layer order, weight names
and weights bitwise — with the two marshalled Lambda payloads compared by
behaviour (their code objects name their own module); the port's exports
read back through JAX's read_model and the port's graph compiler, and load
in tf_keras and Keras 3.  The port's counterpart of tests/test_h5export.py,
with its `slow` marks."""
import codecs
import json
import marshal
import types

import h5py
import jax
import numpy as np
import pytest
import torch

from headpose_tpu.models import heads as jheads
from headpose_tpu.tools import h5export as jexport
from headpose_tpu_torch.models import heads as theads
from headpose_tpu_torch.tools.convert import params_from_jax
from headpose_tpu_torch.tools.h5export import (keras3_custom_objects,
                                               save_head_h5, save_unified_h5)

pytestmark = [pytest.mark.heavy]      # tf-keras round trips, as JAX's file


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _specs(family):
    """(JAX spec, port spec) of one head family, same fields."""
    def both(name, *args, **kw):
        return getattr(jheads, name)(*args, **kw), getattr(theads, name)(
            *args, **kw)

    if family in ("ensemble", "ensemble_stacked"):
        members = [both("MLPHead", 88, ((32, "tanh"), (3, "linear"))),
                   both("SkipMLPHead", in_features=88)]
        if family == "ensemble":
            members.append(both("SEMLPHead", in_features=88))
            kw = {}
        else:
            kw = dict(weights=((0.7, -0.1, 0.4), (0.5, 1.2, 0.6)),
                      bias=(0.3, -0.2, 0.1))
        return (jheads.EnsembleHead(tuple(m[0] for m in members), **kw),
                theads.EnsembleHead(tuple(m[1] for m in members), **kw))
    return {"mlp": lambda: both("MLPHead", 96, ((32, "tanh"), (16, "tanh"),
                                                (3, "linear"))),
            "residual": lambda: both("ResidualMLPHead", in_features=88),
            "skip": lambda: both("SkipMLPHead", in_features=88),
            "se": lambda: both("SEMLPHead", in_features=88),
            "se_transformer": lambda: both("SETransformerHead",
                                           in_features=88)}[family]()


def _port_head(spec, params, x):
    net = theads.head_net(spec, device="cpu").eval()
    net.load_state_dict(params_from_jax(spec, params))
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


def _port_unified(model, params, x):
    from headpose_tpu_torch.models.unified import UnifiedPoseNet

    net = UnifiedPoseNet(model, device="cpu").eval()
    net.load_state_dict(params_from_jax(model, params))
    with torch.no_grad():
        return [t.numpy() for t in net.reference_outputs(torch.from_numpy(x))]


class _NumpyTF:
    """The two calls the Lambda payloads make, in numpy."""

    reshape = staticmethod(np.reshape)

    @staticmethod
    def shape(t):
        return np.asarray(t.shape)


def _lambda_fn(config):
    code = marshal.loads(codecs.decode(
        config["function"][0].encode("ascii"), "base64"))
    return types.FunctionType(code, {"tf": _NumpyTF})


def _walk(group, prefix=""):
    for key, item in group.items():
        yield prefix + key, item
        if isinstance(item, h5py.Group):
            yield from _walk(item, prefix + key + "/")


def _assert_same_file(ours, theirs):
    """Two exports are the same file: root and weight attrs, every weight
    dataset bitwise, the model config equal with each Lambda's payload
    (and the module that wrote it) compared by behaviour."""
    with h5py.File(ours, "r") as a, h5py.File(theirs, "r") as b:
        ca, cb = (json.loads(f.attrs["model_config"]) for f in (a, b))
        la, lb = ca["config"]["layers"], cb["config"]["layers"]
        assert [l["name"] for l in la] == [l["name"] for l in lb]
        x = np.random.default_rng(0).normal(size=(2, 3, 4, 5))
        for ya, yb in zip(la, lb):
            if ya["class_name"] == "Lambda":
                fa, fb = _lambda_fn(ya["config"]), _lambda_fn(yb["config"])
                arg = (x if ya["name"].endswith("lambda")
                       else (x.reshape(2, 12, 5), x))
                np.testing.assert_array_equal(fa(arg), fb(arg))
                for y in (ya, yb):
                    y["config"]["function"] = y["config"]["module"] = None
        assert ca == cb
        for key in ("keras_version", "backend"):
            assert a.attrs[key] == b.attrs[key]
        wa, wb = dict(_walk(a["model_weights"])), dict(_walk(b["model_weights"]))
        assert sorted(wa) == sorted(wb)
        np.testing.assert_array_equal(a["model_weights"].attrs["layer_names"],
                                      b["model_weights"].attrs["layer_names"])
        for key, item in wa.items():
            if isinstance(item, h5py.Dataset):
                assert item.dtype == wb[key].dtype, key
                np.testing.assert_array_equal(item[()], wb[key][()], key)
            else:
                assert dict(item.attrs).keys() == dict(wb[key].attrs).keys()
                for k in item.attrs:
                    np.testing.assert_array_equal(item.attrs[k],
                                                  wb[key].attrs[k])


class TestSameFileAsJax:
    @pytest.mark.parametrize("family", ["mlp", "residual", "skip", "se",
                                        "se_transformer", "ensemble",
                                        "ensemble_stacked"])
    def test_head_families(self, family, tmp_path):
        jspec, spec = _specs(family)
        params = _np(jspec.init(jax.random.PRNGKey(1)))
        save_head_h5(spec, params, str(tmp_path / "port.h5"))
        jexport.save_head_h5(jspec, params, str(tmp_path / "jax.h5"))
        _assert_same_file(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))

    @pytest.mark.parametrize("name", ["flagship", "unified-best"])
    def test_unified(self, name, tmp_path):
        """The flagship and unified-best (stacked ensemble heads, nested
        inside the unified graph), each package writing its own loaded
        model: the same file, and JAX's read_model reads the port's file
        into the ModelDef of its own."""
        from headpose_tpu.core.h5io import read_model
        from headpose_tpu.pretrained import load_flagship as jload_flagship
        from headpose_tpu.pretrained import load_pretrained as jload
        from headpose_tpu_torch.pretrained import load_flagship, load_pretrained

        if name == "flagship":
            (model, params), (jmodel, jparams) = load_flagship(), \
                jload_flagship()
        else:
            (model, params), (jmodel, jparams) = load_pretrained(name), \
                jload(name)
        save_unified_h5(model, params, str(tmp_path / "port.h5"))
        jexport.save_unified_h5(jmodel, jparams, str(tmp_path / "jax.h5"))
        _assert_same_file(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))
        ours, theirs = (read_model(str(tmp_path / f)) for f in ("port.h5",
                                                                 "jax.h5"))
        assert ours.order == theirs.order
        assert ours.outputs == theirs.outputs
        for lname in ours.order:
            for k, w in ours.layers[lname].weights.items():
                np.testing.assert_array_equal(
                    w, theirs.layers[lname].weights[k])


class TestHeadExport:
    def _spec(self):
        jspec, spec = _specs("mlp")
        return spec, _np(jspec.init(jax.random.PRNGKey(0))), jspec

    def test_roundtrip_own_reader(self, tmp_path):
        """The export loads through the port's graph compiler and computes
        the head: the port's module and JAX's apply."""
        from headpose_tpu_torch.core.graph import load_graph_model

        spec, params, jspec = self._spec()
        path = str(tmp_path / "head.h5")
        save_head_h5(spec, params, path)
        gm = load_graph_model(path, device="cpu")
        x = np.random.default_rng(0).normal(size=(5, 2, 3, 96)).astype(
            np.float32)
        with torch.no_grad():
            got = gm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, _port_head(spec, params, x),
                                   atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jspec.apply(params, x)),
                                   atol=1e-5)

    def test_tf_keras_loads_it(self, tmp_path):
        keras = pytest.importorskip("tf_keras")
        spec, params, _ = self._spec()
        path = str(tmp_path / "head_tf.h5")
        save_head_h5(spec, params, path)
        m = keras.models.load_model(path, compile=False)
        x = np.random.default_rng(1).normal(size=(7, 1, 1, 96)).astype(
            np.float32)
        np.testing.assert_allclose(m.predict(x, verbose=0),
                                   _port_head(spec, params, x),
                                   rtol=1e-5, atol=1e-5)


class TestUnifiedExport:
    def test_roundtrip_own_reader(self, tmp_path):
        """The flagship re-imports through the port's graph compiler with
        the 6-output signature intact (2e-4 of the port's forward)."""
        from headpose_tpu_torch.core.graph import load_graph_model
        from headpose_tpu_torch.pretrained import load_flagship

        model, params = load_flagship()
        path = str(tmp_path / "unified.h5")
        save_unified_h5(model, params, path)
        gm = load_graph_model(path, device="cpu")
        x = np.random.default_rng(2).uniform(-1, 1, (2, 128, 128, 3)
                                             ).astype(np.float32)
        with torch.no_grad():
            got = [o.numpy() for o in gm(torch.from_numpy(x))]
        want = _port_unified(model, params, x)
        assert [g.shape for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=2e-4)

    def test_roundtrip_back_camera_spec(self, tmp_path):
        """A 17-block back-camera model: the SSD-head conv names continue
        the backbone numbering, so no weight is overwritten."""
        from headpose_tpu.models import BLAZEFACE_BACK
        from headpose_tpu_torch.core.graph import load_graph_model
        from headpose_tpu_torch.models import BLAZEFACE_BACK as TBACK
        from headpose_tpu_torch.models.unified import join_models

        h88 = theads.MLPHead(88, ((8, "softsign"), (3, "linear")))
        h96 = theads.MLPHead(96, ((8, "tanh"), (3, "linear")))
        jh88 = jheads.MLPHead(88, ((8, "softsign"), (3, "linear")))
        jh96 = jheads.MLPHead(96, ((8, "tanh"), (3, "linear")))
        model, params = join_models(
            TBACK, _np(BLAZEFACE_BACK.init(jax.random.PRNGKey(0))),
            h88, _np(jh88.init(jax.random.PRNGKey(1))),
            h96, _np(jh96.init(jax.random.PRNGKey(2))))
        path = str(tmp_path / "unified_back.h5")
        save_unified_h5(model, params, path)
        gm = load_graph_model(path, device="cpu")
        x = np.random.default_rng(4).uniform(-1, 1, (2, 256, 256, 3)
                                             ).astype(np.float32)
        with torch.no_grad():
            got = [o.numpy() for o in gm(torch.from_numpy(x))]
        want = _port_unified(model, params, x)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, atol=2e-4)

    @pytest.mark.slow
    def test_tf_keras_loads_unified(self, tmp_path):
        """The flagship's 6 outputs through tf_keras within 2e-4 of the
        port's reference_outputs."""
        keras = pytest.importorskip("tf_keras")
        from headpose_tpu_torch.pretrained import load_flagship

        model, params = load_flagship()
        path = str(tmp_path / "unified_tf.h5")
        save_unified_h5(model, params, path)
        m = keras.models.load_model(path, compile=False)
        x = np.random.default_rng(3).uniform(-1, 1, (2, 128, 128, 3)
                                             ).astype(np.float32)
        for g, w in zip(m.predict(x, verbose=0),
                        _port_unified(model, params, x)):
            np.testing.assert_allclose(g, w, atol=2e-4)


class TestAllFamilyExports:
    @pytest.mark.parametrize("family",
                             ["residual", "skip", "se", "se_transformer",
                              "ensemble", "ensemble_stacked"])
    def test_family_roundtrip(self, family, tmp_path):
        """Every family loads in tf_keras and computes the port's head."""
        keras = pytest.importorskip("tf_keras")
        jspec, spec = _specs(family)
        params = _np(jspec.init(jax.random.PRNGKey(1)))
        path = str(tmp_path / f"{family}.h5")
        save_head_h5(spec, params, path)
        m = keras.models.load_model(path, compile=False)
        x = np.random.default_rng(0).normal(
            size=(5, 2, 2, spec.in_features)).astype(np.float32)
        np.testing.assert_allclose(m.predict(x, verbose=0),
                                   _port_head(spec, params, x),
                                   rtol=1e-5, atol=1e-5)


class TestKeras3LoadsExports:
    @staticmethod
    def _keras3():
        keras = pytest.importorskip("keras")
        if not keras.__version__.startswith("3"):
            pytest.skip("stock keras is not Keras 3 here")
        return keras

    def test_se_transformer_via_custom_objects(self, tmp_path):
        keras = self._keras3()
        jspec, spec = _specs("se_transformer")
        params = _np(jspec.init(jax.random.PRNGKey(1)))
        path = str(tmp_path / "k3_set.h5")
        save_head_h5(spec, params, path)
        with pytest.raises(Exception):
            keras.models.load_model(path, compile=False, safe_mode=False)
        m = keras.models.load_model(path, compile=False, safe_mode=False,
                                    custom_objects=keras3_custom_objects())
        x = np.random.default_rng(0).normal(size=(5, 2, 2, 88)
                                            ).astype(np.float32)
        np.testing.assert_allclose(m.predict(x, verbose=0),
                                   _port_head(spec, params, x),
                                   rtol=1e-5, atol=1e-5)

    @pytest.mark.slow
    def test_unified(self, tmp_path):
        keras = self._keras3()
        from headpose_tpu_torch.pretrained import load_flagship

        model, params = load_flagship()
        path = str(tmp_path / "k3_unified.h5")
        save_unified_h5(model, params, path)
        m = keras.models.load_model(path, compile=False,
                                    custom_objects=keras3_custom_objects())
        x = np.random.default_rng(3).uniform(-1, 1, (2, 128, 128, 3)
                                             ).astype(np.float32)
        for g, w in zip(m.predict(x, verbose=0),
                        _port_unified(model, params, x)):
            np.testing.assert_allclose(g, w, atol=2e-4)
