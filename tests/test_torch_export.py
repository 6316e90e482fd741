"""The port's export, evaluation, backfill and training CLI
(headpose_tpu_torch.tools.{export,evaluate,backfill,train_cli}) against the
JAX package's on the CPU.

Tolerance of the evaluations: the port's fp32 heads and JAX's `"highest"`
matmuls round differently (the stacked ensembles sum member terms up to
107°, ROADMAP §3); metrics are held at atol 1e-4 degrees.
"""
import json
import os

import numpy as np
import pytest

from headpose_tpu.data import Dataset as JaxDataset
from headpose_tpu.pretrained import PRETRAINED_DIR as JAX_PRETRAINED_DIR
from headpose_tpu.pretrained import load_pretrained as jax_load_pretrained
from headpose_tpu.tools.evaluate import (
    evaluate_head_pose_model as jax_evaluate_head_pose_model)
from headpose_tpu.tools.export import spec_to_dict as jax_spec_to_dict
from headpose_tpu_torch.data import Dataset
from headpose_tpu_torch.models import MLPHead, join_models
from headpose_tpu_torch.pretrained import (FLAGSHIP, HEADS, PRETRAINED_DIR,
                                           load_pretrained)
from headpose_tpu_torch.runtime.detector import FaceDetector
from headpose_tpu_torch.tools import backfill, train_cli
from headpose_tpu_torch.tools.convert import flatten_params, load_native
from headpose_tpu_torch.tools.evaluate import (evaluate_head_pose_model,
                                               pose_metrics)
from headpose_tpu_torch.tools.export import (load_model, save_model,
                                             spec_from_dict, spec_to_dict)
from headpose_tpu_torch.train import config_96, evaluate, fit

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
METRIC_TOL_DEG = 1e-4
SHIPPED = sorted(os.listdir(PRETRAINED_DIR))


def test_the_port_ships_every_jax_artifact():
    assert SHIPPED == sorted(os.listdir(JAX_PRETRAINED_DIR))
    assert set(HEADS) | {"unified-stoqa9pt-hrchr82r", "unified-best",
                         "unified-best-distilled",
                         "unified-back-distilled"} == set(SHIPPED)


@pytest.mark.parametrize("name", SHIPPED)
@pytest.mark.filterwarnings("ignore:'unified-back-distilled' is a synthetic")
def test_spec_to_dict_is_jaxs(name):
    """The port's spec → JSON dict equals JAX's of its own spec and decodes
    back to the same spec.  (Some shipped spec.json files predate the
    ensembles' `weights`/`bias` fields, so the files are not compared.)"""
    spec, _ = load_pretrained(name)
    jspec, _ = jax_load_pretrained(name)
    d = spec_to_dict(spec)
    assert d == jax_spec_to_dict(jspec)
    assert spec_from_dict(json.loads(json.dumps(d))) == spec


def seeded_rows(c, n=256, seed=0):
    rng = np.random.default_rng(seed)
    return Dataset(rng.normal(0, 0.5, size=(n, c)).astype(np.float32),
                   rng.uniform(-60, 60, size=(n, 3)).astype(np.float32))


@pytest.mark.parametrize("name", HEADS)
def test_evaluate_matches_jax(name):
    """evaluate_head_pose_model of each shipped head on seeded rows against
    JAX's (its `_apply_highest`)."""
    spec, params = load_pretrained(name)
    ds = seeded_rows(spec.in_features, seed=len(name))
    got = evaluate_head_pose_model(spec, ds, params=params, verbose=False,
                                   device="cpu")
    jspec, jparams = jax_load_pretrained(name)
    want = jax_evaluate_head_pose_model(
        jspec, JaxDataset(ds.features, ds.poses), params=jparams,
        verbose=False)
    for kind in ("MAE", "MSE"):
        assert sorted(got[kind]) == sorted(want[kind])
        scale = 1.0 if kind == "MAE" else 2 * want["MAE"]["average"]
        for k, v in want[kind].items():
            np.testing.assert_allclose(got[kind][k], v, rtol=0,
                                       atol=METRIC_TOL_DEG * scale,
                                       err_msg=f"{kind} {k}")


def test_evaluate_paths_and_schema(tmp_path, capsys):
    """A native directory evaluates as its (spec, params); an H5 path
    raises NotImplementedError (ROADMAP §1 item 9); the printed report is
    the reference's."""
    ds = seeded_rows(96, n=64)
    path = os.path.join(PRETRAINED_DIR, "hrchr82r-96")
    spec, params = load_pretrained("hrchr82r-96")
    by_path = evaluate_head_pose_model(path, ds, device="cpu")
    assert by_path == evaluate_head_pose_model(spec, ds, params=params,
                                               verbose=False, device="cpu")
    assert "Mean Absolute Error (MAE):" in capsys.readouterr().out
    np.savez(tmp_path / "ds.npz", features=ds.features, poses=ds.poses)
    assert evaluate_head_pose_model(path, str(tmp_path / "ds.npz"),
                                    verbose=False, device="cpu") == by_path
    with pytest.raises(NotImplementedError, match="item 9"):
        evaluate_head_pose_model(str(tmp_path / "head.h5"), ds,
                                 device="cpu")
    m = pose_metrics(np.zeros((10, 3), np.float32),
                     np.ones((10, 3), np.float32))
    assert m["MAE"]["average"] == 1.0 and m["MSE"]["average"] == 1.0


def test_save_model_round_trips_and_serves(tmp_path):
    """save_model → load_model gives back spec and every leaf bit for bit;
    a joined model saved so serves through FaceDetector.from_native as the
    in-memory join does."""
    spec, params = load_pretrained("distill96")
    save_model(str(tmp_path / "head"), spec, params, {"quality": "test"})
    spec2, params2 = load_model(str(tmp_path / "head"))
    assert spec2 == spec
    want = flatten_params(params)
    for k, v in flatten_params(params2).items():
        np.testing.assert_array_equal(v, want[k])
    with open(tmp_path / "head" / "spec.json") as f:
        assert json.load(f)["metadata"] == {"quality": "test"}

    flag_spec, flag_params = load_pretrained(FLAGSHIP)
    model, joined = join_models(flag_spec.backbone, flag_params["backbone"],
                                flag_spec.head88, flag_params["head88"],
                                spec, params)
    save_model(str(tmp_path / "unified"), model, joined)
    assert load_native(str(tmp_path / "unified"))[0] == model
    img = np.load(os.path.join(GOLDEN, "e2e_production.npz"))["img"]
    a = FaceDetector(model, joined, device="cpu").detect_single(img)
    b = FaceDetector.from_native(str(tmp_path / "unified"),
                                 device="cpu").detect_single(img)
    assert len(a) > 0
    np.testing.assert_array_equal(a.poses, b.poses)
    np.testing.assert_array_equal(a.boxes, b.boxes)


def test_backfill_updates_summaries(tmp_path):
    ds = seeded_rows(16, n=128)
    cfg = config_96(in_features=16, num_filters=4, total_epochs=2,
                    batch_size=64, checkpoint_dir=str(tmp_path / "ck"),
                    run_name="r1")
    os.makedirs(tmp_path / "runs" / "r1")
    cfg.save(str(tmp_path / "runs" / "r1" / "config.json"))
    res = fit(cfg, ds, device="cpu")
    os.makedirs(tmp_path / "runs" / "broken")
    with open(tmp_path / "runs" / "broken" / "config.json", "w") as f:
        json.dump({"run_name": "missing"}, f)
    np.savez(tmp_path / "test.npz", features=ds.features, poses=ds.poses)
    out = backfill.backfill_runs(str(tmp_path / "runs"),
                                 str(tmp_path / "test.npz"),
                                 checkpoint_root=str(tmp_path / "ck"),
                                 verbose=False, device="cpu")
    want = evaluate(res.spec, res.params, ds, device="cpu")
    assert out == {"r1": want["mae"], "broken": None}
    with open(tmp_path / "runs" / "r1" / "summary.json") as f:
        summary = json.load(f)
    assert summary == {"test_AFLW2000_mae": want["mae"],
                       "test_AFLW2000_loss": want["loss"]}


def test_train_cli_writes_runs_like_jax(tmp_path, monkeypatch):
    """`python -m headpose_tpu_torch.tools.train_cli` on a feature
    directory writes runs/<id>/ with the JAX CLI's files and keys."""
    from headpose_tpu.data.datasets import SPLIT_FILES_96
    from headpose_tpu.tools import train_cli as jax_train_cli

    data = tmp_path / "data"
    os.makedirs(data)
    for i, names in enumerate(SPLIT_FILES_96.values()):
        for name in names:
            ds = seeded_rows(96, n=80, seed=i)
            np.savez(data / name, features=ds.features, poses=ds.poses)
    monkeypatch.chdir(tmp_path)
    args = ["--family", "96", "--data_dir", str(data), "--total_epochs", "2",
            "--num_filters", "8"]
    train_cli.main(args + ["--runs_dir", "runs", "--run_name", "port",
                           "--checkpoint_dir", "ck", "--device", "cpu"])
    jax_train_cli.main(args + ["--runs_dir", "jax_runs", "--run_name",
                               "jax"])
    for name, root in (("port", "runs"), ("jax", "jax_runs")):
        assert sorted(os.listdir(tmp_path / root / name)) == [
            "config.json", "metrics.jsonl", "summary.json"]
    files = {}
    for name, root in (("port", "runs"), ("jax", "jax_runs")):
        with open(tmp_path / root / name / "config.json") as f:
            config = json.load(f)
        with open(tmp_path / root / name / "summary.json") as f:
            summary = json.load(f)
        with open(tmp_path / root / name / "metrics.jsonl") as f:
            lines = [json.loads(line) for line in f]
        files[name] = (config, summary, lines)
    (pc, ps, pl), (jc, js, jl) = files["port"], files["jax"]
    assert sorted(pc) == sorted(jc)
    assert pc["total_epochs"] == 2 and pc["run_name"] == "port"
    assert sorted(ps) == sorted(js)
    assert [sorted(r) for r in pl] == [sorted(r) for r in jl]
    assert os.path.isdir(tmp_path / "ck" / "port" / "best")


def test_train_cli_without_a_card_raises(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--data_dir", str(tmp_path)])


def test_a_trained_head_exports_and_evaluates(tmp_path):
    """fit → save_model → evaluate_head_pose_model of the directory gives
    the metrics of the in-memory head."""
    ds = seeded_rows(96, n=128, seed=3)
    res = fit(config_96(num_filters=8, total_epochs=3, batch_size=32,
                        checkpoint_dir=str(tmp_path / "ck"), run_name="x"),
              ds, device="cpu")
    assert isinstance(res.spec, MLPHead)
    save_model(str(tmp_path / "head"), res.spec, res.params)
    direct = evaluate_head_pose_model(res.spec, ds, params=res.params,
                                      verbose=False, device="cpu")
    assert evaluate_head_pose_model(str(tmp_path / "head"), ds,
                                    verbose=False, device="cpu") == direct
    np.testing.assert_allclose(
        evaluate(res.spec, res.params, ds, device="cpu")["mae"],
        direct["MAE"]["average"], rtol=1e-5)
