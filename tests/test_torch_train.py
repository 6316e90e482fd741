"""The port's head training (headpose_tpu_torch.train) against the JAX
package's on the CPU: the Keras golden trajectory, optimizer steps of every
head family, whole `fit` runs at full batch, `l2_penalty`, `init`, sweeps;
and what only the port can be held to (resume, block mode, the NaN guard,
dropout's keep rate, ensemble gradients).  Inputs come from seeds with
numpy; initial params from JAX's own init through the weight bridge.

Tolerances: the Keras trajectory at rtol 1e-4 (as
tests/test_train_parity.py holds JAX); five optimizer steps at rtol 1e-5
(the same arithmetic, another sum order); whole runs at rtol 1e-4 on the
losses and atol 1e-5 on the best params (tens of epochs of rounding of
another sum order); `l2_penalty` at rtol 1e-6.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from headpose_tpu.data import Dataset as JaxDataset
from headpose_tpu.tools.export import spec_from_dict as jax_spec_from_dict
from headpose_tpu.train import config_96 as jax_config_96
from headpose_tpu.train import fit as jax_fit
from headpose_tpu.train import make_optimizer as jax_make_optimizer
from headpose_tpu.train import JsonlLogger as JaxJsonlLogger
from headpose_tpu.train import SweepConfig as JaxSweepConfig
from headpose_tpu.train import run_sweep as jax_run_sweep
from headpose_tpu.train.loop import _loss_and_metrics as jax_loss_and_metrics
from headpose_tpu_torch.data import Dataset, train_val_split
from headpose_tpu_torch.models import heads as theads
from headpose_tpu_torch.tools.convert import (flatten_params, params_from_jax,
                                              params_to_jax)
from headpose_tpu_torch.tools.export import spec_to_dict
from headpose_tpu_torch.train import (JsonlLogger, SweepConfig, TrainConfig,
                                      config_96, evaluate, fit,
                                      make_optimizer, restore_checkpoint,
                                      run_sweep, save_checkpoint)
from headpose_tpu_torch.train.loop import _loss_and_metrics, build_head

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

FAMILIES = {
    "mlp": theads.MLPHead(16, ((8, "tanh"), (6, "softsign"), (3, "linear"))),
    "residual_mlp": theads.ResidualMLPHead(in_features=16, width=8,
                                           num_blocks=2, bottleneck=4),
    "skip_mlp": theads.SkipMLPHead(in_features=16, enc1=8, enc2=6),
    "se_mlp": theads.SEMLPHead(in_features=16, reduction=4, hidden=8),
    "se_transformer": theads.SETransformerHead(
        in_features=16, reduction=4, num_heads=2, key_dim=4, ff_dim=8,
        hidden=8),
    "ensemble": theads.EnsembleHead(
        members=(theads.MLPHead(16, ((8, "tanh"), (3, "linear"))),
                 theads.MLPHead(16, ((8, "tanh"), (3, "linear"))),
                 theads.SkipMLPHead(in_features=16, enc1=8, enc2=6,
                                    activation="tanh")),
        weights=((0.5, 0.25, 1.0), (0.25, 0.5, 0.5), (0.25, 0.25, -0.5)),
        bias=(0.1, -0.2, 0.3)),
}


def jax_spec(spec):
    return jax_spec_from_dict(spec_to_dict(spec))


def jax_init(spec, seed):
    """JAX's own init of the spec, as numpy leaves in JAX layout."""
    return jax.tree.map(np.asarray,
                        jax_spec(spec).init(jax.random.PRNGKey(seed)))


def port_net(spec, params):
    net = theads.head_net(spec, device="cpu")
    net.load_state_dict(params_from_jax(spec, params))      # strict
    return net


def synthetic(n=512, c=16, seed=0, noise=0.01):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, c)).astype(np.float32)
    w = rng.normal(size=(c, 3)).astype(np.float32)
    y = x @ w + noise * rng.normal(size=(n, 3)).astype(np.float32)
    return x, y.astype(np.float32)


# ------------------------------------------------------------ Keras golden
@pytest.mark.parametrize("opt_name", ["sgd", "adam"])
def test_trajectory_matches_keras(opt_name):
    """tests/test_train_parity.py for the port: a 96→8 tanh→3 head with
    L2(1e-3) on kernels and biases, full batch, 6 epochs of SGD(0.01) and
    Adam(0.01) against tf-keras's history."""
    g = np.load(os.path.join(GOLDEN, "keras_train_traj.npz"))
    spec = theads.MLPHead(96, ((8, "tanh"), (3, "linear")))
    net = port_net(spec, {"layers": [
        {"w": g["w0_k0"][0, 0], "b": g["w0_b0"]},
        {"w": g["w0_k1"][0, 0], "b": g["w0_b1"]}]})
    n = g["x"].shape[0]
    batch = {"x": torch.tensor(g["x"].reshape(-1, 96)),
             "y": torch.tensor(g["y"].reshape(-1, 3)),
             "w": torch.ones(n), "mask": torch.ones(n)}
    opt = make_optimizer(TrainConfig(optimizer=opt_name, learning_rate=0.01),
                         net.parameters())
    losses, maes = [], []
    for _ in range(6):
        opt.zero_grad()
        loss, mae = _loss_and_metrics(net, batch, None, 1e-3)
        loss.backward()
        opt.step()
        losses.append(loss.item())       # total loss incl. L2, pre-update
        maes.append(mae.item())
    np.testing.assert_allclose(losses, g[f"loss_{opt_name}"], rtol=1e-4)
    np.testing.assert_allclose(maes, g[f"mae_{opt_name}"], rtol=1e-4)


# ------------------------------------------------- optimizer steps vs JAX
@pytest.mark.parametrize("opt_name", ["sgd", "adam", "adamax"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_five_steps_match_jax(family, opt_name):
    """Five steps of each optimizer on every family, with L2 and sample
    weights and two padded rows, from JAX's init: the losses, MAEs and the
    final params against JAX's `_loss_and_metrics` + `make_optimizer`."""
    spec = FAMILIES[family]
    params = jax_init(spec, 3)
    rng = np.random.default_rng(7)
    n = 24
    x = rng.normal(size=(n, spec.in_features)).astype(np.float32)
    y = rng.normal(0, 10, size=(n, 3)).astype(np.float32)
    mask = np.ones(n, np.float32)
    mask[-2:] = 0.0
    w = (rng.uniform(0.3, 1.0, n) * mask).astype(np.float32)
    reg = 1e-2
    cfg = TrainConfig(optimizer=opt_name, learning_rate=3e-2,
                      regularizer_rate=reg)

    jspec = jax_spec(spec)
    jbatch = {"x": jnp.asarray(x), "y": jnp.asarray(y), "w": jnp.asarray(w),
              "mask": jnp.asarray(mask)}
    optimizer = jax_make_optimizer(cfg)
    jparams = jax.tree.map(jnp.asarray, params)
    state = optimizer.init(jparams)

    @jax.jit
    def step(p, s):
        (loss, m), grads = jax.value_and_grad(
            lambda q: jax_loss_and_metrics(jspec, q, jbatch,
                                           jax.random.PRNGKey(0), reg, True),
            has_aux=True)(p)
        updates, s = optimizer.update(grads, s, p)
        return optax.apply_updates(p, updates), s, loss, m["mae"]

    net = port_net(spec, params)
    opt = make_optimizer(cfg, net.parameters())
    batch = {k: torch.tensor(v) for k, v in
             (("x", x), ("y", y), ("w", w), ("mask", mask))}
    gen = torch.Generator().manual_seed(0)      # train mode, no dropout
    got, want = [], []
    for _ in range(5):
        jparams, state, jl, jm = step(jparams, state)
        want.append((float(jl), float(jm)))
        opt.zero_grad()
        loss, mae = _loss_and_metrics(net, batch, gen, reg)
        loss.backward()
        opt.step()
        got.append((loss.item(), mae.item()))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    mine = flatten_params(params_to_jax(spec, net.state_dict()))
    for k, v in flatten_params(jax.tree.map(np.asarray, jparams)).items():
        np.testing.assert_allclose(mine[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)


# ------------------------------------------------ l2_penalty, init trees
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_l2_penalty_matches_jax(family):
    spec = FAMILIES[family]
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: (a + rng.normal(0, 0.1, a.shape)).astype(
        np.float32), jax_init(spec, 4))
    net = port_net(spec, params)
    jparams = jax.tree.map(jnp.asarray, params)
    for rate in (0.0, 1e-3, 0.7):
        want = float(jax_spec(spec).l2_penalty(jparams, rate))
        got = net.l2_penalty(rate)
        got = float(got) if isinstance(got, float) else got.item()
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(rate))
        if family not in ("se_mlp", "se_transformer") and rate:
            assert got > 0.0


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_init_tree_is_jaxs(family):
    """`spec.init(generator)` gives JAX's tree (the keys and shapes of JAX's
    init and of params_to_jax of the module), float32 leaves, kernels
    Glorot-uniform within their bound, biases zero, LayerNorm gains one;
    a seed reproduces it."""
    spec = FAMILIES[family]
    mine = flatten_params(spec.init(torch.Generator().manual_seed(5)))
    want = flatten_params(jax_init(spec, 5))
    module = flatten_params(params_to_jax(
        spec, theads.head_net(spec, device="cpu").state_dict()))
    assert sorted(mine) == sorted(want) == sorted(module)
    for k, v in mine.items():
        assert v.dtype == np.float32 and v.shape == want[k].shape, k
        leaf = k.split("/")[-1]
        if leaf == "w":
            if v.ndim == 2:
                limit = math.sqrt(6.0 / sum(v.shape))
            elif k.split("/")[-2] == "attn_out":       # (H, D, C)
                limit = math.sqrt(6.0 / (v.shape[0] * v.shape[1]
                                         + v.shape[2]))
            else:                                      # (C, H, D)
                limit = math.sqrt(6.0 / (v.shape[0]
                                         + v.shape[1] * v.shape[2]))
            assert np.abs(v).max() <= limit and np.abs(v).max() > 0.3 * limit, k
        elif leaf == "g":
            assert (v == 1.0).all(), k
        else:
            assert (v == 0.0).all(), k
    again = flatten_params(spec.init(torch.Generator().manual_seed(5)))
    assert all(np.array_equal(again[k], v) for k, v in mine.items())


def test_glorot_draw_is_uniform():
    """A wide kernel's draw has the moments of U(-limit, limit)."""
    spec = theads.MLPHead(400, ((600, "tanh"),))
    w = spec.init(torch.Generator().manual_seed(0))["layers"][0]["w"]
    limit = math.sqrt(6.0 / 1000)
    assert abs(w.mean()) < 0.01 * limit
    np.testing.assert_allclose(w.std(), limit / math.sqrt(3), rtol=0.01)


# ------------------------------------------------ whole fit vs JAX's fit
@pytest.mark.parametrize("k", [1, 4])
def test_fit_matches_jax_at_full_batch(tmp_path, k):
    """Whole runs at full batch (the row order changes only the order of a
    mean), early stopping and ReduceLROnPlateau on, from the same initial
    params: the same history length, best epoch and lr sequence, losses
    within rtol 1e-4, best params within atol 1e-5."""
    x, y = synthetic(n=96, noise=0.5)
    cfg_kw = dict(in_features=16, num_filters=8, total_epochs=60,
                  batch_size=128, learning_rate=5e-2,
                  early_stopping_patience=8, early_stopping_min_delta=1e-2,
                  reduce_lr_on_plateau=True, reduce_lr_patience=2,
                  reduce_lr_factor=0.5, min_lr=1e-3, epochs_per_sync=k)
    spec = build_head(config_96(**cfg_kw))
    params = jax_init(spec, 11)

    def lr_changes(name):
        with open(tmp_path / name / "metrics.jsonl") as f:
            return [(r["epoch"], r["learning_rate"]) for r in map(
                json.loads, f) if "learning_rate" in r]

    jres = jax_fit(
        jax_config_96(checkpoint_dir=str(tmp_path / "ck"), run_name="jax",
                      **cfg_kw),
        JaxDataset(x.copy(), y.copy()),
        logger=JaxJsonlLogger(str(tmp_path / "jax")), spec=jax_spec(spec),
        params=jax.tree.map(jnp.asarray, params))
    tres = fit(config_96(checkpoint_dir=str(tmp_path / "ck"),
                         run_name="torch", **cfg_kw),
               Dataset(x.copy(), y.copy()),
               logger=JsonlLogger(str(tmp_path / "torch")), spec=spec,
               params=params, device="cpu")
    # JAX's block mode also logs the initial lr at the first epoch when it
    # is not a float32 value (0.05 against float32(0.05)): not a change
    first = float(np.float32(cfg_kw["learning_rate"]))
    jlrs = [(e, v) for e, v in lr_changes("jax") if v != first]
    tlrs = lr_changes("torch")
    assert len(tres.history) == len(jres.history) < 60      # stopped early
    assert tres.best_epoch == jres.best_epoch
    assert len(jlrs) >= 2                                   # lr reduced
    assert [e for e, _ in tlrs] == [e for e, _ in jlrs]
    np.testing.assert_allclose([v for _, v in tlrs], [v for _, v in jlrs],
                               rtol=1e-6)
    for got, want in zip(tres.history, jres.history):
        assert got["epoch"] == want["epoch"]
        for key in ("train_loss", "val_loss", "train_mae", "val_mae"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       err_msg=f"{key}@{got['epoch']}")
    np.testing.assert_allclose(tres.best_val_loss, jres.best_val_loss,
                               rtol=1e-4)
    mine = flatten_params(tres.params)
    for key, v in flatten_params(jax.tree.map(np.asarray,
                                              jres.params)).items():
        np.testing.assert_allclose(mine[key], v, atol=1e-5, err_msg=key)


# ------------------------------------------------------------ port only
def _cfg(tmp_path, **kw):
    base = dict(in_features=16, num_filters=8, total_epochs=60,
                early_stopping_patience=15, learning_rate=3e-3,
                batch_size=64, checkpoint_dir=str(tmp_path), run_name="t")
    base.update(kw)
    return config_96(**base)


def _ds(n=512, **kw):
    return Dataset(*synthetic(n=n, **kw))


def test_converges_and_restores_best(tmp_path):
    ds = _ds()
    res = fit(_cfg(tmp_path, total_epochs=30), ds, device="cpu")
    assert res.history[-1]["val_loss"] < res.history[0]["val_loss"] * 0.5
    _, val = train_val_split(ds, 0.2, 42)
    m = evaluate(res.spec, res.params, val, device="cpu")
    best = min(h["val_loss"] for h in res.history)
    np.testing.assert_allclose(m["loss"], best, rtol=1e-4)


def test_early_stopping_on_a_frozen_run(tmp_path):
    res = fit(_cfg(tmp_path, total_epochs=10_000, early_stopping_patience=3,
                   learning_rate=0.0), _ds(), device="cpu")
    assert len(res.history) == 4 and res.best_epoch == 0


@pytest.mark.parametrize("extra", [{}, {"reduce_lr_on_plateau": True,
                                        "reduce_lr_patience": 3}])
def test_epochs_per_sync_matches_per_epoch_reads(tmp_path, extra):
    """Block mode (k epochs per host read) is the per-epoch run exactly, when
    total_epochs % k != 0 and when early stopping fires inside a block."""
    ds = _ds()
    cfg1 = _cfg(tmp_path, total_epochs=23, early_stopping_patience=6,
                run_name="sync1", **extra)
    r1 = fit(cfg1, ds, device="cpu")
    rk = fit(cfg1.replace(epochs_per_sync=4, run_name="synck"), ds,
             device="cpu")
    assert r1.history == rk.history and r1.best_epoch == rk.best_epoch
    for key, v in flatten_params(r1.params).items():
        np.testing.assert_array_equal(flatten_params(rk.params)[key], v)
    stopped = fit(_cfg(tmp_path, total_epochs=10_000, learning_rate=0.0,
                       early_stopping_patience=3, epochs_per_sync=5,
                       run_name="stop"), ds, device="cpu")
    assert len(stopped.history) == 4


@pytest.mark.parametrize("k", [1, 2])
def test_resume_is_exact_continuation(tmp_path, k):
    """Interrupt and resume reproduces the uninterrupted run: the history
    tail and the final weights, bit for bit (minibatches, so the row order
    of every epoch matters)."""
    ds = _ds()
    kw = dict(early_stopping_patience=100, epochs_per_sync=k)
    full = fit(_cfg(tmp_path, run_name="full", total_epochs=6, **kw), ds,
               device="cpu")
    cfg = _cfg(tmp_path, run_name="res", total_epochs=4, **kw)
    first = fit(cfg, ds, device="cpu")
    assert first.best_epoch == 3
    res = fit(cfg.replace(total_epochs=6), ds, resume=True, device="cpu")
    assert [r["epoch"] for r in res.history] == [4, 5]
    assert res.history == full.history[4:]
    assert res.best_epoch == full.best_epoch
    for key, v in flatten_params(full.params).items():
        np.testing.assert_array_equal(flatten_params(res.params)[key], v)


def test_resume_without_run_name_raises(tmp_path):
    with pytest.raises(ValueError, match="run_name"):
        fit(_cfg(tmp_path, total_epochs=2, run_name=None), _ds(),
            resume=True, device="cpu")


def test_mesh_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="item 8"):
        fit(_cfg(tmp_path, total_epochs=1), _ds(), mesh=object(),
            device="cpu")


def test_bad_monitor_and_ensemble_config_raise(tmp_path):
    with pytest.raises(ValueError, match="monitor_metric"):
        fit(_cfg(tmp_path, monitor_metric="val_banana"), _ds(64),
            device="cpu")
    with pytest.raises(ValueError, match="EnsembleHead"):
        build_head(_cfg(tmp_path, head="ensemble"))


def test_nan_giveup_returns_best_weights(tmp_path):
    """SGD at lr 1e20 overflows every epoch: after the 4th recovery the run
    gives up and returns the rolled-back best weights, finite, even with
    restore_best_weights=False."""
    logger = JsonlLogger(str(tmp_path / "run"))
    res = fit(_cfg(tmp_path, total_epochs=200, optimizer="sgd",
                   learning_rate=1e20, early_stopping_patience=1000,
                   restore_best_weights=False), _ds(128), logger=logger,
              device="cpu")
    assert len(res.history) < 10
    assert all(np.isfinite(v).all() for v in
               flatten_params(res.params).values())
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        recoveries = [r["nan_recovery"] for r in map(json.loads, f)
                      if "nan_recovery" in r]
    assert recoveries == [1, 2, 3, 4]


def test_sample_weights_flag_is_difficulty_weighting(tmp_path):
    from headpose_tpu_torch.data import difficulty_weights

    x, _ = synthetic(n=96)
    y = np.zeros((96, 3), np.float32)
    y[:, 0] = 85.0
    kw = dict(total_epochs=2, batch_size=32, seed=7)
    flag = fit(_cfg(tmp_path, run_name="w1", use_sample_weights=True, **kw),
               Dataset(x, y), device="cpu")
    explicit = fit(_cfg(tmp_path, run_name="w2", **kw),
                   Dataset(x, y, difficulty_weights(y)), device="cpu")
    plain = fit(_cfg(tmp_path, run_name="w3", **kw), Dataset(x, y),
                device="cpu")
    assert flag.history == explicit.history
    assert flag.history[0]["train_loss"] < plain.history[0]["train_loss"]


def test_monitor_val_mae_and_l2_in_the_loss(tmp_path):
    ds = _ds(128)
    r = fit(_cfg(tmp_path, total_epochs=3, monitor_metric="val_mae",
                 run_name="mm"), ds, device="cpu")
    np.testing.assert_allclose(r.best_val_loss,
                               min(h["val_mae"] for h in r.history),
                               rtol=1e-6)
    r0 = fit(_cfg(tmp_path, total_epochs=1, run_name="r0"), ds, device="cpu")
    r1 = fit(_cfg(tmp_path, total_epochs=1, regularizer_rate=1.0,
                  run_name="r1"), ds, device="cpu")
    assert r1.history[0]["train_loss"] > r0.history[0]["train_loss"]


def test_logger_and_plateau(tmp_path):
    logger = JsonlLogger(str(tmp_path / "run"), config={"a": 1})
    fit(_cfg(tmp_path, total_epochs=30, learning_rate=1e-8,
             early_stopping_patience=25, reduce_lr_on_plateau=True,
             reduce_lr_patience=3, min_lr=1e-9), _ds(), logger=logger,
        device="cpu")
    with open(tmp_path / "run" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    lrs = [r["learning_rate"] for r in recs if "learning_rate" in r]
    assert len(lrs) >= 2 and lrs[1] < lrs[0]
    assert "val_loss" in recs[0]
    with open(tmp_path / "run" / "summary.json") as f:
        summary = json.load(f)
    assert {"best_epoch", "total_parameters", "epochs_run"} <= set(summary)


def test_checkpoint_round_trip_and_pruning(tmp_path):
    rng = np.random.default_rng(0)
    params = {"layers": [{"w": rng.normal(size=(4, 3)).astype(np.float32),
                          "b": np.zeros(3, np.float32)}]}
    opt = {"lr": torch.tensor(0.5), "count": torch.tensor(3, dtype=torch.int32),
           "mu": [torch.ones(2)], "nu": [torch.ones(2)]}
    for step in range(5):
        save_checkpoint(str(tmp_path), step, params, opt,
                        extra={"best_val": np.float32(1.5)})
    assert sorted(os.listdir(tmp_path)) == ["step_2", "step_3", "step_4"]
    step, p, o, meta, best = restore_checkpoint(str(tmp_path))
    assert step == 4 and best is None and meta["best_val"] == 1.5
    np.testing.assert_array_equal(p["layers"][0]["w"],
                                  params["layers"][0]["w"])
    assert o["count"].dtype == np.int32 and int(o["count"]) == 3


# ------------------------------------------------- dropout and ensembles
def test_dropout_keep_rate_and_scale():
    """Train mode drops whole channels with probability `rate` and scales
    the rest by 1/keep; without a generator the module is inference."""
    spec = theads.MLPHead(8, ((512, "linear"),), dropout_rate=0.25)
    net = theads.head_net(spec, device="cpu")
    x = torch.ones(64, 8)
    with torch.no_grad():
        clean = net(x)
        y = net(x, torch.Generator().manual_seed(0))
        assert torch.equal(net(x), clean)
    kept = y != 0
    np.testing.assert_allclose(kept.float().mean().item(), 0.75, atol=0.01)
    torch.testing.assert_close(y[kept], (clean / 0.75)[kept])
    maps = torch.ones(4, 3, 3, 8)     # a map: one mask per image and channel
    with torch.no_grad():
        out = net(maps, torch.Generator().manual_seed(1))
    assert ((out == 0).all(dim=(1, 2)) | (out != 0).all(dim=(1, 2))).all()


def test_ensemble_gradients_reach_every_member():
    """The grouped (vmap) path and the training path carry the same
    gradients to every member."""
    spec = FAMILIES["ensemble"]
    params = jax_init(spec, 2)
    x = torch.tensor(np.random.default_rng(0).normal(
        size=(10, 16)).astype(np.float32))
    grads = []
    for generator in (None, torch.Generator().manual_seed(0)):
        net = port_net(spec, params)
        net(x, generator).square().sum().backward()
        grads.append({n: p.grad for n, p in net.named_parameters()})
    assert len(grads[0]) == sum(1 for _ in port_net(spec,
                                                    params).parameters())
    for name, g in grads[0].items():
        assert g is not None and g.abs().sum() > 0, name
        torch.testing.assert_close(g, grads[1][name], rtol=1e-5, atol=1e-6)


# ------------------------------------------------------------------ sweep
@pytest.mark.parametrize("method", ["random", "grid", "bayes"])
def test_sweep_candidates_equal_jaxs(method):
    grids = {"dropout_rate": [0, 1e-6, 1e-4, 1e-3, 1e-2, 0.7],
             "regularizer_rate": [0, 1e-5, 1e-3, 0.7],
             "num_filters": [16, 64, 256]}

    def objective(p):
        return {"m": (grids["dropout_rate"].index(p["dropout_rate"]) - 3) ** 2
                + (grids["num_filters"].index(p["num_filters"]) - 1) ** 2
                + 0.5 * grids["regularizer_rate"].index(
                    p["regularizer_rate"])}

    kw = dict(parameters=grids, metric="m", method=method, num_runs=20,
              warmup=6, seed=3)
    mine = run_sweep(SweepConfig(**kw), objective)
    want = jax_run_sweep(JaxSweepConfig(**kw), objective)
    assert [r["params"] for r in mine.runs] == [r["params"] for r in want.runs]
    assert mine.best == want.best
