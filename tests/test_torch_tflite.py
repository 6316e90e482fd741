"""The port's TFLite exporter (headpose_tpu_torch/tools/tflite.py): heads and
unified models convert to flatbuffers whose serving_default signature
reproduces the port's CPU forward (the validation gate inside every export)
and JAX's forward of the same params on fresh inputs; the gate fails loudly;
spatial-context heads are refused with JAX's message.  The port's
counterpart of tests/test_tflite.py."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("tensorflow")
pytest.importorskip("tf_keras")

from headpose_tpu.models import heads as jheads
from headpose_tpu_torch.models import heads as theads
from headpose_tpu_torch.tools.convert import params_from_jax
from headpose_tpu_torch.tools.tflite import (UNIFIED_OUTPUT_NAMES,
                                             TFLiteModel, export_h5_tflite,
                                             export_head_tflite,
                                             export_unified_tflite)

pytestmark = pytest.mark.heavy      # tf-keras/TFLite round trips


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


class TestHeadExport:
    def test_mlp_head_round_trips(self, tmp_path):
        """The production-style MLP chain converts; the signature runner
        reproduces the port's head and JAX's apply on fresh inputs."""
        layers = ((32, "tanh"), (16, "tanh"), (3, "linear"))
        jspec = jheads.MLPHead(96, layers)
        spec = theads.MLPHead(96, layers)
        params = _np(jspec.init(jax.random.PRNGKey(0)))
        out = str(tmp_path / "head.tflite")
        report = export_head_tflite(spec, params, out)
        assert report["maxerr"] <= 1e-5 and report["bytes"] > 0
        tm = TFLiteModel(out)
        assert tm.input_names == ["features"]
        assert tm.output_names == ["pose"]
        assert tm.input_shape("features") == (1, 1, 1, 96)
        x = np.random.default_rng(3).normal(size=(1, 1, 1, 96)).astype(
            np.float32)
        got = tm(features=x)["pose"]
        net = theads.head_net(spec, device="cpu").eval()
        net.load_state_dict(params_from_jax(spec, params))
        with torch.no_grad():
            np.testing.assert_allclose(got, net(torch.from_numpy(x)).numpy(),
                                       rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, np.asarray(jspec.apply(params, x)),
                                   rtol=1e-5, atol=1e-5)

    def test_se_transformer_converts(self, tmp_path):
        """The attention family exports at a map input shape."""
        jspec = jheads.SETransformerHead(88)
        params = _np(jspec.init(jax.random.PRNGKey(1)))
        report = export_head_tflite(theads.SETransformerHead(88), params,
                                    str(tmp_path / "set.tflite"),
                                    input_shape=(1, 4, 4, 88))
        assert report["maxerr"] <= 1e-5
        assert report["input_shape"] == (1, 4, 4, 88)

    def test_validation_gate_fails_loud(self, tmp_path):
        """An artifact that diverges from the port's forward is not
        written: a negative tolerance proves the gate is live."""
        jspec = jheads.MLPHead(8, ((3, "linear"),))
        params = _np(jspec.init(jax.random.PRNGKey(0)))
        out = str(tmp_path / "bad.tflite")
        with pytest.raises(ValueError, match="diverges"):
            export_head_tflite(theads.MLPHead(8, ((3, "linear"),)), params,
                               out, atol=-1.0)
        assert not os.path.exists(out)

    def test_h5_artifact_exports(self, tmp_path):
        """A reference-format H5 (the port's own head export) converts,
        validated against the port's graph compiler, with the Keras
        graph's names in its signature."""
        from headpose_tpu_torch.tools.h5export import save_head_h5

        jspec = jheads.MLPHead(88, ((16, "softsign"), (3, "linear")))
        params = _np(jspec.init(jax.random.PRNGKey(2)))
        h5 = str(tmp_path / "head.h5")
        save_head_h5(theads.MLPHead(88, ((16, "softsign"), (3, "linear"))),
                     params, h5)
        report = export_h5_tflite(h5, str(tmp_path / "h5.tflite"))
        assert report["input_shape"] == (1, 1, 1, 88)
        assert report["inputs"] == ["input_1"]
        assert max(report["maxerr"].values()) <= 2e-4


@pytest.fixture(scope="module")
def flagship():
    from headpose_tpu_torch.pretrained import load_flagship

    return load_flagship()


class TestUnifiedExport:
    def test_flagship_six_output_contract(self, tmp_path, flagship):
        """The flagship exports with the reference's 6 named outputs; each
        lies within 2e-4 of the port's reference_outputs (the gate) and of
        JAX's on a fresh input."""
        from headpose_tpu.pretrained import load_flagship as jload

        model, params = flagship
        out = str(tmp_path / "flagship.tflite")
        report = export_unified_tflite(model, params, out)
        assert set(report["maxerr"]) == set(UNIFIED_OUTPUT_NAMES)
        assert max(report["maxerr"].values()) <= 2e-4
        tm = TFLiteModel(out)
        assert tm.input_names == ["image"]
        assert sorted(tm.output_names) == sorted(UNIFIED_OUTPUT_NAMES)
        x = np.random.default_rng(5).uniform(
            -1, 1, (1, 128, 128, 3)).astype(np.float32)
        got = tm(image=x)
        jmodel, jparams = jload()
        with jax.default_matmul_precision("highest"):
            want = dict(zip(UNIFIED_OUTPUT_NAMES,
                            jmodel.reference_outputs(jparams, x)))
        for name in UNIFIED_OUTPUT_NAMES:
            np.testing.assert_allclose(got[name], np.asarray(want[name]),
                                       rtol=1e-4, atol=2e-4)

    def test_spatial_heads_refused(self, flagship):
        """SE-gated heads are refused with JAX's message: the 6-output
        contract can only bake map-grafted pose maps."""
        model, params = flagship
        se = theads.SEMLPHead(88)
        bad = dataclasses.replace(model, head88=se)
        bad_params = dict(params, head88=_np(jheads.SEMLPHead(88).init(
            jax.random.PRNGKey(0))))
        with pytest.raises(ValueError, match="survivors|per-vector"):
            export_unified_tflite(bad, bad_params, "/dev/null/never.tflite")
        from headpose_tpu.tools.tflite import export_unified_tflite as jexp
        from headpose_tpu.models.unified import UnifiedPoseModel

        jmodel = UnifiedPoseModel(backbone=None, head88=jheads.SEMLPHead(88),
                                  head96=None)
        with pytest.raises(ValueError) as theirs:
            jexp(jmodel, {}, "/dev/null/never.tflite")
        with pytest.raises(ValueError) as ours:
            export_unified_tflite(bad, bad_params, "/dev/null/never.tflite")
        assert str(ours.value) == str(theirs.value)
