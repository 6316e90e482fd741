"""The port's precision calibration (headpose_tpu_torch.train.calibrate)
and the simulate_fast modes of its models against the JAX package's on the
CPU, on the tiny unified model of tests/test_calibrate.py:21-32.

JAX's images come from its own random stream, which the port cannot
reproduce without jax; so the one-step and 20-step checks run on GIVEN
images (the port's `_calibrate(..., images=)`), and the JAX side is the
loss closure of calibrate.py:107-133 rebuilt from JAX's `apply`, through
optax.adam(cosine_decay_schedule) as calibrate.py builds it.

Tolerances: the forward under every simulate_fast mode 1e-5 (the same
roundings, another sum order); the upsampling of synthesize_images atol
2e-7 of jax.image.resize (interpolation weights computed another way); one
step's loss and gradients rtol 1e-4 / atol 1e-6 (a backward through convs
summed in another order, and through bf16 casts: both sides round the
cotangent to bf16 there, so an ulp of difference upstream can flip a
rounding, 2^-8 of that element); 20-step params atol 1e-5 at lr 1e-5, the
recipe chip_smoke.py calibrates the flagship with.  The island forward is
piecewise constant in the weights (they are rounded to bf16), so once the
two sides' params differ by an ulp a weight can cross a rounding boundary
on one side only, and Adam turns that element's changed gradient into an
lr-sized step: at lr 3e-5 and 1e-4 the two trajectories separate by 3.5e-5
and 4.7e-5 in 20 steps, at lr 1e-5 by 1.6e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from headpose_tpu.models.blazeface import BlazeFace as JBlazeFace
from headpose_tpu.models.heads import MLPHead as JMLPHead
from headpose_tpu.models.unified import UnifiedPoseModel as JUnified
from headpose_tpu.train import calibrate as jcal
from headpose_tpu_torch.models.blazeface import BlazeFace
from headpose_tpu_torch.models.heads import MLPHead
from headpose_tpu_torch.models.params import (flatten_params, params_from_jax,
                                              params_to_jax)
from headpose_tpu_torch.models.unified import UnifiedPoseModel, UnifiedPoseNet
from headpose_tpu_torch.train import calibrate as tcal

FORWARD_TOL = dict(rtol=1e-5, atol=1e-5)
RESIZE_ATOL = 2e-7
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
TRAJ_ATOL = 1e-5

SPEC = BlazeFace(input_size=32, stem_features=8, block_channels=(8, 12, 16),
                 downsample_blocks=(1,), tap88_block=0)
HEAD88 = ((4, "tanh"), (3, "linear"))
HEAD96 = ((3, "linear"),)
FAST = (0, 1, 2)
WEIGHTS = (1.0, 1.0, 10.0, 0.1)


def tiny():
    """(port spec, JAX spec, params in JAX layout from JAX's init)."""
    model = UnifiedPoseModel(backbone=SPEC, head88=MLPHead(8, HEAD88),
                             head96=MLPHead(16, HEAD96))
    jmodel = JUnified(backbone=JBlazeFace(**dataclasses.asdict(SPEC)),
                      head88=JMLPHead(8, HEAD88), head96=JMLPHead(16, HEAD96))
    key = jax.random.PRNGKey(0)
    params = {"backbone": jmodel.backbone.init(key),
              "head88": jmodel.head88.init(jax.random.fold_in(key, 1)),
              "head96": jmodel.head96.init(jax.random.fold_in(key, 2))}
    return model, jmodel, jax.tree.map(np.asarray, params)


def images(n, seed, size=32):
    return tcal.synthesize_images(torch.Generator().manual_seed(seed), n,
                                  size, device="cpu").numpy()


def net_of(model, params):
    net = UnifiedPoseNet(model, device="cpu")
    net.load_state_dict(params_from_jax(model, params))
    return net


def test_synthesize_images_range_shape_and_variety():
    """tests/test_calibrate.py::test_synthesize_images_range_and_shape, on
    the port, and the same seed giving the same images."""
    imgs = images(6, 0)
    assert imgs.shape == (6, 32, 32, 3) and imgs.dtype == np.float32
    assert imgs.min() >= -1.0 and imgs.max() <= 1.0
    flat = imgs.reshape(6, -1)
    assert np.std(flat, axis=1).min() > 0.01
    assert np.abs(flat[0] - flat[1]).max() > 0.05
    assert np.array_equal(images(6, 0), imgs)
    assert not np.array_equal(images(6, 1), imgs)
    assert images(2, 0, size=128).shape == (2, 128, 128, 3)


@pytest.mark.parametrize("src,dst", [(1, 32), (2, 32), (8, 32), (2, 128),
                                     (32, 128)])
def test_upsampling_matches_jax_image_resize(src, dst):
    v = np.random.default_rng(src).uniform(-1, 1, (3, src, src, 3)).astype(
        np.float32)
    got = tcal._upsample(torch.from_numpy(v), dst).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(v), (3, dst, dst, 3),
                                       "bilinear"))
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ATOL)


@pytest.mark.parametrize("mode", [True, False, "weights", "acts"])
def test_simulate_fast_modes_match_jax(mode):
    """UnifiedPoseNet.forward(dense=True, fast_blocks=, simulate_fast=mode)
    against JAX's apply under the same mode at HIGHEST: every output."""
    model, jmodel, params = tiny()
    x = images(2, 2)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply(jax.tree.map(jnp.asarray, params),
                            jnp.asarray(x), dense=True, fast_blocks=FAST,
                            simulate_fast=mode)
    with torch.no_grad():
        got = net_of(model, params)(torch.from_numpy(x), dense=True,
                                    fast_blocks=FAST, simulate_fast=mode)
    for k in ("feat88", "feat96", "scores", "loc", "pose_front",
              "pose_back"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **FORWARD_TOL)


def test_selective_modes_round_only_their_operand():
    """tests/test_calibrate.py::test_simulate_fast_operand_selective_modes
    on the port: each mode differs from fp32 and from both-rounded; no
    island means no rounding; the default is True; a bad mode raises."""
    model, _, params = tiny()
    net = net_of(model, params)
    x = torch.from_numpy(images(2, 2))
    with torch.no_grad():
        outs = {m: net(x, dense=True, fast_blocks=FAST,
                       simulate_fast=m)["pose_back"]
                for m in (False, True, "weights", "acts")}
        default = net(x, dense=True, fast_blocks=FAST)["pose_back"]
        off = net(x, dense=True, simulate_fast=True)["pose_back"]
        base = net(x, dense=True)["pose_back"]
    for m in (True, "weights", "acts"):
        assert float((outs[m] - outs[False]).abs().max()) > 1e-7, m
    for m in ("weights", "acts"):
        assert float((outs[m] - outs[True]).abs().max()) > 1e-7, m
    assert torch.equal(default, outs[True])
    assert torch.equal(off, base)
    with pytest.raises(ValueError, match="simulate_fast"):
        net(x, fast_blocks=FAST, simulate_fast="both")


def jax_loss(jmodel, params0):
    """The loss closure of JAX's calibrate_fast_params (calibrate.py:
    107-133) over the backbone."""
    w_pf, w_pb, w_sc, w_loc = WEIGHTS
    params0 = jax.tree.map(jnp.asarray, params0)

    def loss_fn(backbone, x):
        with jax.default_matmul_precision("highest"):
            ref = jax.lax.stop_gradient(jmodel.apply(params0, x))
        with jax.default_matmul_precision("high"):
            out = jmodel.apply(dict(params0, backbone=backbone), x,
                               dense=True, fast_blocks=FAST,
                               simulate_fast=True)
        terms = {
            "pose_front": w_pf * jnp.mean(
                (out["pose_front"] - ref["pose_front"]) ** 2),
            "pose_back": w_pb * jnp.mean(
                (out["pose_back"] - ref["pose_back"]) ** 2),
            "scores": w_sc * jnp.mean(
                (jax.nn.sigmoid(out["scores"])
                 - jax.nn.sigmoid(ref["scores"])) ** 2),
            "loc": w_loc * jnp.mean((out["loc"] - ref["loc"]) ** 2),
        }
        return sum(terms.values()), terms
    return loss_fn


def perturbed(params, scale, seed):
    """The tiny model's params with its backbone moved off the targets'
    weights (a student some steps into calibration), so the loss is not
    only the roundings."""
    rng = np.random.default_rng(seed)
    bb = jax.tree.map(lambda a: (a + scale * rng.normal(size=a.shape))
                      .astype(np.float32), params["backbone"])
    return dict(params, backbone=bb)


def test_one_step_loss_and_gradients_match_jax():
    model, jmodel, params = tiny()
    x = images(4, 3)
    student = net_of(model, perturbed(params, 1e-3, 0))
    teacher = net_of(model, params).requires_grad_(False)
    loss, terms = tcal._calibration_loss(student, teacher,
                                         torch.from_numpy(x), FAST, WEIGHTS)
    loss.backward()
    (jl, jterms), jg = jax.jit(jax.value_and_grad(
        jax_loss(jmodel, params), has_aux=True))(
        jax.tree.map(jnp.asarray, perturbed(params, 1e-3, 0)["backbone"]),
        jnp.asarray(x))
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=STEP_TOL["rtol"])
    for t, k in zip(terms, ("pose_front", "pose_back", "scores", "loc")):
        np.testing.assert_allclose(float(t.detach()), float(jterms[k]),
                                   rtol=STEP_TOL["rtol"], err_msg=k)
    got = flatten_params(params_to_jax(SPEC, {
        k[len("backbone."):]: p.grad
        for k, p in student.named_parameters() if k.startswith("backbone.")}))
    want = flatten_params(jax.tree.map(np.asarray, jg))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=STEP_TOL["rtol"],
                                   atol=STEP_TOL["atol"], err_msg=k)


def test_calibration_trajectory_matches_jax_and_freezes_heads():
    """20 steps of calibrate_fast_params on given images against JAX's loss
    through optax.adam(cosine_decay_schedule(lr, steps)): params atol 1e-5;
    the heads come back bit for bit; the history has JAX's keys and one
    value a step."""
    model, jmodel, params = tiny()
    steps, lr = 20, 1e-5
    x = np.stack([images(4, 10 + i) for i in range(steps)])
    newp, hist = tcal._calibrate(model, params, steps=steps, batch=4,
                                 learning_rate=lr, fast_blocks=FAST, seed=0,
                                 loss_weights=WEIGHTS, device="cpu", images=x)
    loss_fn = jax_loss(jmodel, params)
    tx = optax.adam(optax.cosine_decay_schedule(lr, steps))

    @jax.jit
    def step(bb, state, xb):
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(bb, xb)
        upd, state = tx.update(g, state, bb)
        return optax.apply_updates(bb, upd), state, loss

    bb = jax.tree.map(jnp.asarray, params["backbone"])
    state, losses = tx.init(bb), []
    for xb in x:
        bb, state, loss = step(bb, state, jnp.asarray(xb))
        losses.append(float(loss))
    got, want = (flatten_params(newp["backbone"]),
                 flatten_params(jax.tree.map(np.asarray, bb)))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=TRAJ_ATOL,
                                   err_msg=k)
    assert max(np.abs(got[k] - flatten_params(params["backbone"])[k]).max()
               for k in got) > 5 * TRAJ_ATOL         # it moved
    # the first step starts from the same params: its loss to rtol 1e-4;
    # later losses are rounding residuals (1e-6) of params an ulp apart
    np.testing.assert_allclose(hist["loss"][0], losses[0],
                               rtol=STEP_TOL["rtol"])
    assert np.all(np.isfinite(hist["loss"]))
    assert sorted(hist) == ["loc", "loss", "pose_back", "pose_front",
                            "scores"]
    assert all(len(v) == steps for v in hist.values())
    for name in ("head88", "head96"):
        for k, v in flatten_params(params[name]).items():
            assert np.array_equal(flatten_params(newp[name])[k], v)


def test_public_entry_point_and_surface():
    """calibrate_fast_params draws its own images (seeded: two runs are
    equal) and keeps JAX's defaults; ALL_BLOCKS is JAX's."""
    model, _, params = tiny()
    runs = [tcal.calibrate_fast_params(model, params, steps=3, batch=2,
                                       fast_blocks=FAST, device="cpu")
            for _ in range(2)]
    assert np.array_equal(runs[0][1]["loss"], runs[1][1]["loss"])
    assert np.all(np.isfinite(runs[0][1]["loss"]))
    assert tcal.ALL_BLOCKS == jcal.ALL_BLOCKS
    assert set(jcal.__all__) <= set(dir(tcal))
    import inspect
    ours = inspect.signature(tcal.calibrate_fast_params).parameters
    for name, p in inspect.signature(
            jcal.calibrate_fast_params).parameters.items():
        assert ours[name].default == p.default, name
