"""The port's multi-device paths (headpose_tpu_torch.parallel, fit(mesh=),
FaceDetector(mesh=), DynamicBatcher over a mesh detector) against the JAX
package's on the 8 virtual CPU devices of tests/conftest.py.

One module fixture spawns 4 gloo ranks on the CPU once
(`parallel.dryrun.launch`) and runs every part of the dryrun; each test
reads the ranks' results and holds them to JAX's run in this process, or to
the port's unsharded run that each rank made beside its sharded one."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from headpose_tpu.parallel import create_mesh as jax_create_mesh
from headpose_tpu.parallel import head_param_specs as jax_head_param_specs
from headpose_tpu.parallel import shard_head_params as jax_shard_head_params
from headpose_tpu_torch.models.params import (DENSE, flatten_params,
                                              leaf_layouts)
from headpose_tpu_torch.parallel import dryrun
from test_torch_train import jax_spec

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
N = 4                               # ranks
TOL = dict(rtol=1e-5, atol=1e-5)    # __graft_entry__.py:285-290


def jax_frames() -> np.ndarray:
    """The 8 rolled production frames of tests/test_parallel.py:97-128."""
    g = np.load(os.path.join(GOLDEN, "e2e_production.npz"))
    img128 = np.asarray(
        jax.image.resize(jnp.asarray(g["img"], jnp.float32),
                         (128, 128, 3), "linear")).astype(np.uint8)
    return np.stack([np.roll(img128, i, axis=1) for i in range(8)])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every part of the dryrun on 4 gloo ranks: (per-rank reports, rank
    0's arrays)."""
    out = str(tmp_path_factory.mktemp("dryrun"))
    frames = os.path.join(out, "frames.npz")
    np.savez(frames, frames=jax_frames())
    results = dryrun.launch(N, out, device="cpu", frames=frames,
                            timeout=600)
    with np.load(os.path.join(out, "rank0.npz")) as f:
        arrays = {k: f[k] for k in f.files}
    return results, arrays


def checks(results, prefix):
    got = {(r["rank"], name): ok for r in results
           for name, ok in r["checks"].items() if name.startswith(prefix)}
    assert got, prefix
    return got


# ------------------------------------------------------------------- mesh
def test_create_mesh_shapes_and_refusals(ranks):
    """(4, 1), (2, 2) and (1, 4) meshes, and both refusals with JAX's
    messages."""
    results, _ = ranks
    devs = jax.devices()[:N]
    want = {}
    for name, kw in (("too_many", dict(n_devices=2 * N)),
                     ("indivisible", dict(n_devices=N, model_parallel=3))):
        with pytest.raises(ValueError) as e:
            jax_create_mesh(devices=devs, **kw)
        want[name] = str(e.value)
    assert jax_create_mesh(N, devices=devs).devices.shape == (4, 1)
    assert jax_create_mesh(N, 2, devices=devs).devices.shape == (2, 2)
    assert jax_create_mesh(N, 4, devices=devs).devices.shape == (1, 4)
    for r in results:
        mesh = r["mesh"]
        assert mesh["shape"] == [4, 1]
        assert mesh["shape_model_parallel_2"] == [2, 2]
        assert mesh["shape_model_parallel_4"] == [1, 4]
        assert mesh["error_too_many"] == want["too_many"]
        assert mesh["error_indivisible"] == want["indivisible"]


@pytest.mark.parametrize("what", ["replicate", "shard_rows",
                                  "host_local_batch"])
def test_placement_helpers(ranks, what):
    """Each rank's part is its rows (or all), and the gathered value is
    the input."""
    results, _ = ranks
    assert all(checks(results, f"mesh[{what}]").values())


# -------------------------------------------------------- tensor parallel
def _families():
    from headpose_tpu_torch.models import heads as H

    return [H.MLPHead(96, ((32, "tanh"), (16, "tanh"), (3, "linear"))),
            H.MLPHead(88, ((64, "softsign"), (3, "linear"))),
            H.ResidualMLPHead(in_features=88),
            H.SkipMLPHead(in_features=88),
            H.SEMLPHead(in_features=88),
            H.SETransformerHead(in_features=88),
            H.EnsembleHead(members=(
                H.MLPHead(88, ((64, "softsign"), (3, "linear"))),
                H.SkipMLPHead(in_features=88)))]


@pytest.mark.parametrize("i,tp", [pytest.param(i, 2, id=str(i))
                                  for i in range(7)]
                         + [pytest.param(i, 4, id=f"{i}@tp4")
                            for i in range(7)])
def test_head_param_specs_match_jax(i, tp):
    """Leaf by leaf, JAX's PartitionSpec at tp 2 (a (2, 2) mesh) and tp 4
    (the (1, 4) mesh) carried onto the port's layout (a dense kernel (out,
    in): its sharded dim flips); a width that tp does not divide stays
    replicated in both (at tp 4 the SE-MLP head on 88 features has none
    that 4 divides: JAX replicates it whole, and so does the port)."""
    from torch.distributed.tensor import Replicate, Shard

    from headpose_tpu_torch.parallel import head_param_specs

    spec = _families()[i]
    params = spec.init(torch.Generator().manual_seed(0))
    mine = head_param_specs(spec, params, tp)
    theirs = jax_head_param_specs(jax_spec(spec), params, tp)
    jax_shards = False
    for _, path, layout in leaf_layouts(spec):
        got, want = mine, theirs
        for p in path:
            got, want = got[p], want[p]
        if "model" in tuple(want):
            d = tuple(want).index("model")
            expect = (Replicate(), Shard(1 - d if layout == DENSE else d))
            jax_shards = True
        else:
            expect = (Replicate(), Replicate())
        assert tuple(got) == expect, (path, want)
    assert jax_shards or (tp, i) == (4, 4)
    assert any(not pl.is_replicate() for leaf in flatten_leaves(mine)
               for pl in leaf) == jax_shards


def flatten_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in flatten_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in flatten_leaves(v)]
    return [tree]


def mesh_cases(families):
    """(family, mesh) cases: the (2, 2) mesh, JAX's dryrun's choice for 4
    devices, under the family's name; the (1, 4) mesh as `<family>@1x4`."""
    return ([pytest.param(f, "2x2", id=f) for f in families]
            + [pytest.param(f, "1x4", id=f"{f}@1x4") for f in families])


@pytest.mark.parametrize("family,shape", mesh_cases(
    ["mlp", "se_transformer", "ensemble", "mlp_no_dropout"]))
def test_tp_step_matches_unsharded(ranks, family, shape):
    """The TP+DP step on every rank, on the (2, 2) and the (1, 4) mesh,
    against the unsharded step (dropout masks included): the loss and every
    gradient element (the dryrun's own check) and every updated parameter
    element within 1e-5.  JAX shards each of these families on both
    meshes (it refuses none: a width that 4 does not divide stays
    replicated)."""
    results, _ = ranks
    suffix = "" if shape == "2x2" else f"@{shape}"
    assert all(ok for (_, name), ok in checks(
        results, f"train[{family}]").items() if name.endswith(f"]{suffix}"))
    for r in results:
        train = r["train_meshes"][shape]
        got = train[family]
        assert train["mesh"] == [int(d) for d in shape.split("x")]
        assert got["sharded_params"] > 0
        assert got["max_param_err"] <= 1e-5
        np.testing.assert_allclose(got["loss"], got["loss_unsharded"], **TOL)
    assert results[0]["train"]["mesh"] == [2, 2]     # the first mesh's


@pytest.mark.parametrize("family,shape", mesh_cases(
    ["se_transformer", "ensemble", "mlp_no_dropout"]))
def test_tp_step_matches_jax(ranks, family, shape):
    """The same step in JAX on create_mesh(4, model_parallel=2) and
    create_mesh(4, model_parallel=4) (JAX's dryrun step; its dropout masks
    are JAX's own, so the mlp with dropout is held to the port's unsharded
    step only): loss and params 1e-5."""
    from headpose_tpu.train.loop import _loss_and_metrics

    _, arrays = ranks
    name, spec, params, data = next(c for c in dryrun.tp_cases(N)
                                    if c[0] == family)
    jspec = jax_spec(spec)
    mp = int(shape.split("x")[1])
    prefix = "train" if shape == "2x2" else f"train@{shape}"
    mesh = jax_create_mesh(N, model_parallel=mp, devices=jax.devices()[:N])
    optimizer = optax.adam(dryrun.TP_LR, eps=1e-7)
    p = jax.tree.map(jnp.asarray, params)
    opt_state = optimizer.init(p)
    p = jax_shard_head_params(jspec, p, mesh)
    row = NamedSharding(mesh, P("data"))
    batch = {k: jax.device_put(jnp.asarray(v), row) for k, v in data.items()}

    @jax.jit
    def step(p, opt_state, batch):
        (loss, _), grads = jax.value_and_grad(
            lambda q: _loss_and_metrics(jspec, q, batch,
                                        jax.random.PRNGKey(1), dryrun.TP_REG,
                                        True), has_aux=True)(p)
        updates, opt_state = optimizer.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), loss

    new, loss = step(p, opt_state, batch)
    np.testing.assert_allclose(arrays[f"{prefix}/{name}/loss"], float(loss),
                               **TOL)
    for key, want in flatten_params(jax.tree.map(np.asarray, new)).items():
        np.testing.assert_allclose(arrays[f"{prefix}/{name}/{key}"], want,
                                   **TOL, err_msg=key)


# --------------------------------------------------------------- serving
@pytest.fixture(scope="module")
def jax_mesh_detect():
    """JAX's mesh FaceDetector on the flagship, the 8 frames sharded over
    create_mesh(4)."""
    from headpose_tpu.pretrained import load_flagship
    from headpose_tpu.runtime import FaceDetector

    model, params = load_flagship()
    mesh = jax_create_mesh(N, devices=jax.devices()[:N])
    det = FaceDetector(model, params, mesh=mesh)
    frames = jax.device_put(jnp.asarray(jax_frames()),
                            NamedSharding(mesh, P("data")))
    res = det.detect(frames)
    return det, {f: np.asarray(getattr(res, f))
                 for f in ("valid", "poses", "boxes")}


@pytest.mark.parametrize("variant", ["flagship", "flagship_survivors",
                                     "flagship_fused"])
def test_mesh_detect_matches_jax(ranks, jax_mesh_detect, variant):
    """The port's mesh detect of the flagship on the 8 rolled production
    frames against JAX's mesh detector: valid identical, boxes within
    1e-4 and poses within 2e-3, the bounds that hold the port's
    single-device detector to JAX's (tests/test_torch_detector.py:32-49);
    the 1e-5 of JAX's dryrun holds the sharded port to the unsharded port
    (test_mesh_detect_matches_unsharded).  The survivors profile gives the
    flagship's map values; detect_fused is kernel #2's plain version."""
    _, arrays = ranks
    want = jax_mesh_detect[1]
    got = {f: arrays[f"detect/{variant}/{f}"] for f in want}
    np.testing.assert_array_equal(got["valid"], want["valid"])
    m = want["valid"].astype(bool)
    assert m.sum() >= 8
    np.testing.assert_allclose(got["poses"][m], want["poses"][m], atol=2e-3)
    np.testing.assert_allclose(got["boxes"][m], want["boxes"][m], atol=1e-4)


@pytest.mark.parametrize("variant", ["flagship", "flagship_fast",
                                     "flagship_survivors", "flagship_fused",
                                     "best_distilled", "back"])
def test_mesh_detect_matches_unsharded(ranks, variant):
    """Each rank's mesh detect against the unsharded port detector on the
    same frames (valid identical, poses and boxes within 1e-5), and the
    same kernel launches in each window."""
    results, _ = ranks
    assert all(checks(results, f"detect[{variant}]").values())
    assert all(r["detect"][variant]["detections"] > 0 for r in results)


def test_mesh_detect_divisibility_and_granularity(ranks, jax_mesh_detect):
    """batch_granularity is the data-axis size (4, as JAX's); a batch of 5
    raises JAX's ValueError on every rank; a host_local_batch DTensor
    gives the same slab."""
    results, _ = ranks
    det = jax_mesh_detect[0]
    with pytest.raises(ValueError) as e:
        det.detect(jax_frames()[:N + 1])
    for r in results:
        assert r["detect"]["batch_granularity"] == det.batch_granularity == 4
        assert r["detect"]["indivisible_error"] == str(e.value)
    assert all(checks(results, "detect[host_local_batch]").values())


def test_aot_refuses_mesh_detector(ranks, jax_mesh_detect, tmp_path):
    """tools.aot refuses a mesh detector with JAX's message."""
    from headpose_tpu.tools.aot import export_detector

    results, _ = ranks
    with pytest.raises(ValueError) as e:
        export_detector(jax_mesh_detect[0], str(tmp_path / "aot"))
    for r in results:
        assert r["detect"]["aot_error"] == str(e.value)


def test_batcher_over_mesh_detector(ranks):
    """Rank 0's DynamicBatcher over the 4-rank mesh detector: widths
    (4, 8, 12) at max_batch 12, 3 frames answered as plain detect
    (tests/test_server.py:96-99's bounds); ranks 1-3 follow it."""
    results, _ = ranks
    assert results[0]["batcher"]["widths"] == [4, 8, 12]
    assert results[0]["batcher"]["frames_served"] == 3
    assert all(checks(results, "batcher").values())
    assert all(r["batcher"]["followed"] >= 1 for r in results[1:])


# --------------------------------------------------------------- training
def _jax_fit_history(ds_index: int, batch: int, epochs: int, tmp_path):
    from headpose_tpu.data import Dataset as JaxDataset
    from headpose_tpu.train import config_96 as jax_config_96
    from headpose_tpu.train import fit as jax_fit
    from headpose_tpu_torch.train import config_96
    from headpose_tpu_torch.train.loop import build_head

    kw = dict(in_features=16, num_filters=8, total_epochs=epochs,
              batch_size=batch, checkpoint_dir=str(tmp_path))
    spec = build_head(config_96(**kw))
    params = spec.init(torch.Generator().manual_seed(config_96().seed))
    ds = dryrun.fit_datasets()[ds_index]
    res = jax_fit(jax_config_96(run_name="jax", **kw),
                  JaxDataset(ds.features.copy(), ds.poses.copy()),
                  spec=jax_spec(spec),
                  params=jax.tree.map(jnp.asarray, params),
                  mesh=jax_create_mesh(N, devices=jax.devices()[:N]))
    return np.array([[h["train_loss"], h["val_loss"]] for h in res.history])


def test_dp_fit_matches_one_process(ranks):
    """fit(mesh=) over 4 ranks (batch 64, 3 epochs) against the port's
    one-process fit: rtol 1e-4 (tests/test_parallel.py:52-54)."""
    results, arrays = ranks
    assert all(checks(results, "fit[dp").values())
    for r in results:
        np.testing.assert_allclose(r["fit"]["dp"]["history"],
                                   r["fit"]["dp"]["history_one_process"],
                                   rtol=1e-4)
        np.testing.assert_array_equal(r["fit"]["dp"]["history"],
                                      arrays["fit/dp"])


def test_dp_fit_matches_jax(ranks, tmp_path):
    """fit(mesh=) over 4 ranks against JAX's fit(mesh=create_mesh(4)) from
    the same initial params, at full batch (the row order, which the two
    draw differently, changes only a sum's order): rtol 1e-4."""
    _, arrays = ranks
    want = _jax_fit_history(2, 256, 3, tmp_path)
    np.testing.assert_allclose(arrays["fit/dp_full_batch"], want, rtol=1e-4)


def test_block_mode_matches_per_epoch(ranks):
    """epochs_per_sync=3 on the mesh against per-epoch mode on the mesh:
    rtol 1e-5 (tests/test_parallel.py:73-76)."""
    results, _ = ranks
    assert all(checks(results, "fit[block]").values())
    for r in results:
        assert len(r["fit"]["block"]["history"]) == 5


def test_checkpoint_resume_on_mesh(ranks):
    """A mesh run saved after 2 of 4 epochs and resumed continues to the
    uninterrupted run's history (rank 0 writes the shared checkpoint, the
    others read it after the barrier)."""
    results, _ = ranks
    assert all(checks(results, "fit[resume]").values())
    for r in results:
        assert r["fit"]["resume"]["resumed_at"] == 2
        np.testing.assert_allclose(r["fit"]["resume"]["history"],
                                   r["fit"]["resume"]["history_whole"],
                                   rtol=1e-5)


def test_ranks_agree(ranks):
    """Every rank reports the same training and serving numbers."""
    results, _ = ranks
    for r in results[1:]:
        assert r["fit"]["dp"]["history"] == results[0]["fit"]["dp"]["history"]
        for fam in ("mlp", "se_transformer", "ensemble"):
            assert r["train"][fam]["loss"] == results[0]["train"][fam]["loss"]
        assert (r["detect"]["flagship"]["detections"]
                == results[0]["detect"]["flagship"]["detections"])


# ---------------------------------------------------- bring-up, in process
CLUSTER_VARS = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "SLURM_NTASKS", "SLURM_PROCID",
                "SLURM_LOCALID", "OMPI_COMM_WORLD_SIZE",
                "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK")


@pytest.fixture
def no_cluster(monkeypatch):
    for k in CLUSTER_VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_initialize_is_noop_single_process(no_cluster):
    """No cluster environment, no argument: nothing is brought up, and a
    second call is as harmless (JAX's TestDistributed)."""
    import torch.distributed as dist

    from headpose_tpu_torch.parallel import (initialize_distributed,
                                             is_distributed)

    initialize_distributed()
    assert not dist.is_initialized() and not is_distributed()
    initialize_distributed()
    no_cluster.setenv("WORLD_SIZE", "1")        # torchrun's single process
    initialize_distributed()
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,want", [
    ({"WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "1"}, (4, 2, 1)),
    ({"SLURM_NTASKS": "8", "SLURM_PROCID": "5", "SLURM_LOCALID": "1"},
     (8, 5, 1)),
    ({"OMPI_COMM_WORLD_SIZE": "2", "OMPI_COMM_WORLD_RANK": "1",
      "OMPI_COMM_WORLD_LOCAL_RANK": "0"}, (2, 1, 0)),
    ({"SLURM_NTASKS": "1"}, None)])
def test_cluster_environment_detection(no_cluster, env, want):
    from headpose_tpu_torch.parallel.distributed import _cluster_env

    for k, v in env.items():
        no_cluster.setenv(k, v)
    assert _cluster_env() == want


def test_explicit_request_is_not_quietly_single_process(no_cluster):
    """Any explicit argument asks for bring-up (JAX's :74-77): without an
    address to reach, it raises instead of training alone."""
    import torch.distributed as dist

    from headpose_tpu_torch.parallel import initialize_distributed

    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_distributed(num_processes=2, process_id=0)
    no_cluster.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        initialize_distributed()
    assert not dist.is_initialized()


NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="asserts the refusal of a host with no "
                                    "CUDA device")


@NO_CARD
def test_resolve_device_without_gpu_raises():
    """The rank's device is a CUDA device: with none, None still raises."""
    from headpose_tpu_torch.utils.device import (resolve_device,
                                                 set_local_device)

    set_local_device(1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(None)
    finally:
        set_local_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_dryrun_cli_fails_on_a_missed_rank(tmp_path):
    """A rank that fails makes the launcher raise (the CLI exits non-zero):
    an unknown part fails every rank before any collective."""
    with pytest.raises(RuntimeError, match="dryrun failed"):
        dryrun.launch(2, str(tmp_path), device="cpu",
                      parts=("no_such_part",), timeout=120)


@NO_CARD
def test_mesh_and_dryrun_default_to_the_card(tmp_path):
    """create_mesh, FaceDetector(mesh=)'s and fit(mesh=)'s source of the
    device, and the dryrun's launcher run on the card unless asked for the
    CPU: with no card they raise, before any process group or rank."""
    import torch.distributed as dist

    from headpose_tpu_torch.parallel import create_mesh, global_mesh

    for make in (create_mesh, global_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.launch(2, str(tmp_path / "out"), parts=("mesh",))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.dryrun_multichip(2, out=str(tmp_path / "out"))
    assert not dist.is_initialized()
    assert not (tmp_path / "out").exists()


def test_tp_parameter_check_allows_only_adams_slack():
    """The TP step's parameter check: a gradient gap near |g| = eps moves
    Adam's first step by more than TP_TOL and is allowed exactly that
    much; a step not applied (a stale shard) or applied from another
    gradient is refused."""
    from headpose_tpu_torch.train.loop import HeadOptimizer

    lr, eps = dryrun.TP_LR, HeadOptimizer.EPS
    p0 = torch.tensor([0.5, -0.25, 0.125, 0.0625], dtype=torch.float64)
    g = torch.tensor([3e-2, -2e-7, 1e-8, 1e-3], dtype=torch.float64)
    g_tp = g + torch.tensor([1e-9, 2e-9, -8e-9, 1e-9], dtype=torch.float64)

    def step(grad):
        return (p0 - lr * grad / (grad.abs() + eps)).float()

    want = step(g)
    got = step(g_tp)
    assert float((got.double() - want.double()).abs().max()) > 1e-5
    ok, past, g_past = dryrun.params_held(got, want, g_tp.float(), g.float())
    assert ok and past == 1 and g_past == pytest.approx(1e-8)
    stale = got.clone()
    stale[0] = p0[0]                              # the update not applied
    assert not dryrun.params_held(stale, want, g_tp.float(), g.float())[0]
    wrong = step(g_tp * 2)                        # another gradient
    assert not dryrun.params_held(wrong, want, g_tp.float(), g.float())[0]
