"""The port's H5 loaders against the JAX package's: the native imports
(unified_from_h5, head_from_h5, se_transformer_from_h5,
head_from_keras_json), FaceDetector.from_h5 and from_h5_compat on the
parity corpus, the compat refusals, the conversion tools and the join CLI,
and the H5 paths of the HTTP server and the head evaluator."""
import json
import os

import numpy as np
import pytest
import torch

from headpose_tpu_torch.models.params import flatten_params
from headpose_tpu_torch.pretrained import FLAGSHIP, load_pretrained

FIXTURES = os.path.join(os.path.dirname(__file__), "golden_torch")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
JOINED = os.path.join(FIXTURES, "flagship_joined.h5")
SE_H5 = os.path.join(FIXTURES, "se_transformer_head.h5")
HEAD96 = os.path.join(FIXTURES, "head96.h5")
POSE_TOL_DEG = 1e-3        # tests/test_detection.py:194-207


def assert_bitwise(got, want):
    a, b = flatten_params(got), flatten_params(want)
    assert sorted(a) == sorted(b)
    for k, v in b.items():
        v = np.asarray(v)
        assert a[k].dtype == v.dtype and a[k].tobytes() == v.tobytes(), k


def _twin(name):
    from headpose_tpu_torch.core.h5io import _model_from_parts

    with open(os.path.join(FIXTURES, f"{name}_config.json")) as f:
        config = json.load(f)
    with np.load(os.path.join(FIXTURES, f"{name}_weights.npz")) as w:
        return _model_from_parts(config, {k: w[k] for k in w.files})


def test_unified_from_h5_is_the_committed_flagship():
    """The fixture and its twin import to the committed flagship: the same
    spec, every parameter bit for bit; JAX's import gives the same."""
    from headpose_tpu.models import unified_from_h5 as jax_unified
    from headpose_tpu_torch.models import unified_from_h5

    spec, params = load_pretrained(FLAGSHIP)
    for source in (JOINED, _twin("flagship_joined")):
        got_spec, got = unified_from_h5(source)
        assert got_spec == spec
        assert_bitwise(got, params)
    jspec, jparams = jax_unified(JOINED)
    assert_bitwise(got, jparams)
    assert jspec.head88.layers == spec.head88.layers


def test_flat_export_raises_as_jax(tmp_path):
    """JAX's flat export inlines the heads: the native import refuses it in
    both packages, by design; from_h5_compat serves it."""
    from headpose_tpu.models import unified_from_h5 as jax_unified
    from headpose_tpu.pretrained import load_flagship
    from headpose_tpu.tools.h5export import save_unified_h5
    from headpose_tpu_torch.models import unified_from_h5
    from headpose_tpu_torch.runtime.detector import FaceDetector

    path = str(tmp_path / "flat.h5")
    save_unified_h5(*load_flagship(), path)
    with pytest.raises(ValueError) as ours:
        unified_from_h5(path)
    with pytest.raises(ValueError) as theirs:
        jax_unified(path)
    assert str(ours.value) == str(theirs.value)
    assert "expected 2 nested pose heads, found 0" in str(ours.value)
    img = np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"]
    flat = FaceDetector.from_h5_compat(path, device="cpu")
    native = FaceDetector(*load_pretrained(FLAGSHIP), device="cpu")
    a, b = flat.detect_single(img), native.detect_single(img)
    assert len(a) == len(b) > 0
    np.testing.assert_allclose(a.poses, b.poses, atol=POSE_TOL_DEG)


def test_head_imports_match_jax(tmp_path):
    """head_from_h5 and se_transformer_from_h5 (JAX infers reduction 17
    from the squeeze width 88 // 5) give JAX's specs and params bitwise;
    head_from_keras_json gives JAX's spec (the port draws its Glorot init
    from a torch.Generator, so only the shapes compare)."""
    from headpose_tpu.models import heads as J
    from headpose_tpu_torch.models import heads as T

    for fn, path in (("head_from_h5", HEAD96),
                     ("se_transformer_from_h5", SE_H5)):
        spec, params = getattr(T, fn)(path)
        jspec, jparams = getattr(J, fn)(path)
        assert spec.__class__.__name__ == jspec.__class__.__name__
        assert {f: getattr(spec, f) for f in spec.__dataclass_fields__} == \
            {f: getattr(jspec, f) for f in jspec.__dataclass_fields__}
        assert_bitwise(params, jparams)
    assert T.se_transformer_from_h5(SE_H5)[0].reduction == 17
    assert T.head_from_h5(HEAD96)[0] == load_pretrained("hrchr82r-96")[0]
    with pytest.raises(ValueError, match="MLP chain"):
        T.head_from_h5(SE_H5)

    keras = pytest.importorskip("tf_keras")
    inp = keras.Input((1, 1, 96))
    x = keras.layers.Conv2D(32, 1, activation="tanh")(inp)
    x = keras.layers.SpatialDropout2D(0.2)(x)
    x = keras.layers.Flatten()(keras.layers.Conv2D(3, 1)(x))
    path = str(tmp_path / "model.json")
    with open(path, "w") as f:
        f.write(keras.Model(inp, x).to_json())
    spec, params = T.head_from_keras_json(path)
    jspec, jparams = J.head_from_keras_json(path)
    assert (spec.in_features, spec.layers, spec.dropout_rate) == \
        (jspec.in_features, jspec.layers, jspec.dropout_rate)
    assert [p["w"].shape for p in params["layers"]] == \
        [tuple(p["w"].shape) for p in jparams["layers"]]
    again = T.head_from_keras_json(path, torch.Generator().manual_seed(0))[1]
    assert_bitwise(again, params)


@pytest.fixture(scope="module")
def frames():
    return np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:16]


@pytest.fixture(scope="module")
def jax_reference(frames):
    from headpose_tpu.runtime.detector import FaceDetector as JaxDetector

    return {name: getattr(JaxDetector, name)(JOINED).detect(frames)
            for name in ("from_h5", "from_h5_compat")}


@pytest.mark.parametrize("loader", ["from_h5", "from_h5_compat"])
def test_h5_detectors_match_jax(loader, frames, jax_reference):
    """from_h5 (the native import) and from_h5_compat (the graph compiler)
    on 16 parity frames against JAX's of the same name: identical sets,
    boxes and scores within 1e-5, poses within 1e-3 degrees."""
    from headpose_tpu_torch.runtime.detector import FaceDetector

    det = getattr(FaceDetector, loader)(JOINED, device="cpu")
    got, want = det.detect(frames), jax_reference[loader]
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    assert valid.sum() >= 16
    np.testing.assert_allclose(got.boxes.numpy()[valid],
                               np.asarray(want.boxes)[valid], atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy()[valid],
                               np.asarray(want.scores)[valid], atol=1e-5)
    np.testing.assert_allclose(got.poses.numpy()[valid],
                               np.asarray(want.poses)[valid],
                               atol=POSE_TOL_DEG)


def test_from_h5_is_the_native_flagship_bitwise(frames):
    """from_h5 and the native flagship are one model: slabs bit for bit,
    through detect and detect_fused."""
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime.detector import FaceDetector

    det = FaceDetector.from_h5(JOINED, device="cpu")
    ref = flagship_detector(device="cpu")
    assert torch.equal(det.detect(frames).slab, ref.detect(frames).slab)
    assert torch.equal(det.detect_fused(frames[:4]).slab,
                       ref.detect_fused(frames[:4]).slab)


def test_compat_refusals_match_jax(frames):
    """On a graph-compiled model the accelerated precisions and the
    survivors profile raise with JAX's messages; detect_fused raises."""
    from headpose_tpu.runtime.detector import FaceDetector as JaxDetector
    from headpose_tpu_torch.runtime.detector import FaceDetector

    for precision in ("fast", "turbo", "max"):
        with pytest.raises(ValueError) as ours:
            FaceDetector.from_h5_compat(JOINED, precision=precision,
                                        device="cpu")
        with pytest.raises(ValueError) as theirs:
            JaxDetector.from_h5_compat(JOINED,
                                       precision=precision).detect(frames[:1])
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as ours:
        FaceDetector.from_h5_compat(JOINED, head_eval="survivors",
                                    device="cpu")
    with pytest.raises(ValueError) as theirs:
        JaxDetector.from_h5_compat(JOINED, head_eval="survivors")
    assert str(ours.value) == str(theirs.value)
    det = FaceDetector.from_h5_compat(JOINED, device="cpu")
    assert det.head_eval == "map" and det.input_size == 128
    with pytest.raises(ValueError, match="graph-compiled"):
        det.detect_fused(frames[:1])


def test_graph_detector_weights_and_input_shape(frames):
    """from_h5_compat serves the compiled module's own weights (no params
    dict round trip), which equal JAX's GraphModel params bit for bit; a
    params dict given to FaceDetector loads into the module; a graph whose
    input layer has no spatial shape raises instead of assuming one."""
    import copy

    from headpose_tpu.core import load_graph_model as jax_graph
    from headpose_tpu_torch.core.graph import load_graph_model
    from headpose_tpu_torch.runtime.detector import (FaceDetector,
                                                     GraphUnifiedModel)

    det = FaceDetector.from_h5_compat(JOINED, device="cpu")
    assert_bitwise(det.net.graph.params, jax_graph(JOINED).params)
    gm = load_graph_model(_twin("flagship_joined"), device="cpu")
    params = copy.deepcopy(gm.params)      # on the CPU .params are views
    for w in gm.parameters():
        torch.nn.init.zeros_(w)
    again = FaceDetector(GraphUnifiedModel(gm), params, device="cpu")
    assert torch.equal(again.detect(frames).slab, det.detect(frames).slab)
    md = copy.deepcopy(_twin("flagship_joined"))
    md.layers[md.inputs[0][0]].config["batch_input_shape"] = [None, None,
                                                              None, 3]
    with pytest.raises(ValueError, match="no spatial shape"):
        FaceDetector.from_h5_compat(md, device="cpu")


def _reports(reps, root):
    return [(os.path.basename(r.source), r.converted, r.validated,
             r.output and os.path.relpath(r.output, root), r.error)
            for r in reps]


def test_convert_matches_jax(tmp_path, capsys):
    """batch_convert of a chain head (converts and validates) and an SE head
    (fails in both packages: not an MLP chain) against JAX's reports; the
    converted params bitwise JAX's; the CLI's output JAX's."""
    import shutil

    from headpose_tpu.tools import convert as J
    from headpose_tpu.tools.export import load_model as jax_load_model
    from headpose_tpu_torch.tools import convert as T
    from headpose_tpu_torch.tools.export import load_model

    src = tmp_path / "heads"
    src.mkdir()
    shutil.copy(HEAD96, src / "model_runid_hrchr82r.h5")
    shutil.copy(SE_H5, src / "se.h5")
    ours = T.batch_convert(str(src), str(tmp_path / "ours"), device="cpu")
    out_ours = capsys.readouterr().out
    theirs = J.batch_convert(str(src), str(tmp_path / "theirs"))
    out_theirs = capsys.readouterr().out
    assert _reports(ours, tmp_path / "ours") == \
        _reports(theirs, tmp_path / "theirs")
    assert [r.converted for r in ours] == [True, False]
    assert ours[0].max_abs_error <= 1e-5
    assert out_ours.splitlines()[-1] == out_theirs.splitlines()[-1]
    spec, params = load_model(ours[0].output)
    jspec, jparams = jax_load_model(theirs[0].output)
    assert spec.layers == jspec.layers
    assert_bitwise(params, jparams)
    rep = T.convert_head(HEAD96, str(tmp_path / "one"), device="cpu")
    assert rep.validated and rep.output.endswith("head96")
    T.main([HEAD96, str(tmp_path / "cli"), "--device", "cpu"])
    J.main([HEAD96, str(tmp_path / "cli_jax")])
    cli = capsys.readouterr().out.splitlines()
    assert cli[0].replace("cli", "cli_jax").split("max_abs_error")[0] == \
        cli[1].split("max_abs_error")[0]


def test_join_cli_matches_jax(tmp_path, capsys):
    """join_and_save of the fixture's backbone with two H5 heads against
    JAX's: the same directory name, spec and params bitwise; the joined
    model serves like the flagship; the twin's ModelDef joins the same; the
    contract check needs the card unless device='cpu'; the CLI too."""
    from headpose_tpu.pretrained import load_pretrained as jax_pretrained
    from headpose_tpu.tools import join_cli as J
    from headpose_tpu.tools.export import load_model as jax_load_model
    from headpose_tpu.tools.h5export import save_head_h5
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime.detector import FaceDetector
    from headpose_tpu_torch.tools import join_cli as T
    from headpose_tpu_torch.tools.export import load_model

    reg1 = str(tmp_path / "stoqa9pt.h5")
    save_head_h5(*jax_pretrained("stoqa9pt-88"), reg1, name="reg1")
    out = T.join_and_save(JOINED, reg1, HEAD96, str(tmp_path / "ours"),
                          device="cpu")
    jout = J.join_and_save(JOINED, reg1, HEAD96, str(tmp_path / "theirs"))
    assert os.path.basename(out) == os.path.basename(jout) == \
        "reg1-stoqa9pt-reg2-head96"
    spec, params = load_model(out)
    jspec, jparams = jax_load_model(jout)
    assert spec.head88.layers == jspec.head88.layers
    assert spec.head96.layers == jspec.head96.layers
    assert_bitwise(params, jparams)
    assert_bitwise(params, load_pretrained(FLAGSHIP)[1])
    img = np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"]
    assert torch.equal(FaceDetector.from_native(out, device="cpu")
                       .detect(img).slab,
                       flagship_detector(device="cpu").detect(img).slab)
    for path in (reg1, out + "/", "a/b/model_runid_x"):
        assert T.extract_id_from_path(path) == J.extract_id_from_path(path)
    twin_out = T.join_and_save(_twin("flagship_joined"), reg1, HEAD96,
                               str(tmp_path / "twin"), device="cpu")
    assert_bitwise(load_model(twin_out)[1], params)
    with pytest.raises(FileNotFoundError):
        T.join_and_save(JOINED, str(tmp_path / "missing.h5"), HEAD96,
                        str(tmp_path), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.join_and_save(JOINED, reg1, HEAD96, str(tmp_path / "card"))
    capsys.readouterr()
    T.main(["--detector", JOINED, "--reg1", reg1, "--reg2", HEAD96,
            "--out", str(tmp_path / "cli"), "--device", "cpu"])
    assert capsys.readouterr().out.strip().endswith(
        "cli/reg1-stoqa9pt-reg2-head96")


def test_http_and_evaluate_read_h5(tmp_path):
    """The two lifted refusals: the HTTP server's _build_detector serves an
    H5 file (through from_h5), and the head evaluator reads an H5 head
    (through head_from_h5) as JAX's does."""
    from headpose_tpu.data import Dataset as JaxDataset
    from headpose_tpu.tools.evaluate import \
        evaluate_head_pose_model as jax_evaluate
    from headpose_tpu_torch.data import Dataset
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime.http import _build_detector
    from headpose_tpu_torch.tools.evaluate import evaluate_head_pose_model

    det = _build_detector(JOINED, device="cpu", precision="fast")
    assert det.precision == "fast" and det.model == flagship_detector(
        device="cpu").model
    rng = np.random.default_rng(0)
    x = rng.normal(size=(64, 96)).astype(np.float32)
    y = rng.normal(0, 20, size=(64, 3)).astype(np.float32)
    got = evaluate_head_pose_model(HEAD96, Dataset(x, y), verbose=False,
                                   device="cpu")
    want = jax_evaluate(HEAD96, JaxDataset(x, y), verbose=False)
    for kind in ("MAE", "MSE"):
        for k, v in want[kind].items():
            np.testing.assert_allclose(got[kind][k], v, rtol=1e-5)
