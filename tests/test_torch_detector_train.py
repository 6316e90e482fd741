"""The port's detector training (headpose_tpu_torch.train.detector, the
model hooks BlazeFace.init / BlazeFaceNet.tap, train.optim) against the JAX
package's on the CPU.

Inputs come from seeds with numpy; params are drawn once and handed to
both sides in JAX layout (the port converts them through
models/params.params_from_jax).  JAX's random stream cannot be reproduced
without jax, so the trajectories run on GIVEN batch indices: the port's
trainers take them through their private twins (`_fit_detector(...,
indices=)`), and the JAX side is a composition of JAX's own loss functions
(`ssd_loss`, `_distill_loss`, and the prefix closure rebuilt from `apply`
as detector.py:354-364 composes it) with the same optax chain.

Tolerances: ssd_targets labels bitwise, loc atol 1e-5 (pixel units: the
same float32 arithmetic); ssd_loss terms and their gradients rtol 1e-5
(elementwise, another sum order); the forward hooks 1e-5; distill targets
and norms rtol 1e-5; one step's loss and gradients rtol 1e-4 / atol 1e-6
(a backward through convs summed in another order); 20-step trajectories
params atol 1e-5; the optimizer against optax rtol 1e-6 (the same
elementwise float32 arithmetic); the schedules rtol 1e-5 and atol 1e-6
of the peak (optax evaluates them in float32, where 1 + cos(x) near the
end of the decay keeps few digits; the port in float64 on the host).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from headpose_tpu.models.blazeface import BlazeFace as JBlazeFace
from headpose_tpu.ops.image import preprocess as jpreprocess
from headpose_tpu.train import detector as jdet
from headpose_tpu_torch.models.blazeface import (BLAZEFACE_BACK,
                                                 BLAZEFACE_FRONT, BlazeFace,
                                                 BlazeFaceNet)
from headpose_tpu_torch.models.params import (flatten_params, params_from_jax,
                                              params_to_jax)
from headpose_tpu_torch.ops.image import preprocess
from headpose_tpu_torch.train import detector as tdet
from headpose_tpu_torch.train import optim

# the tiny teacher/student pair of tests/test_detector_train.py:27-32
TINY_TEACHER = BlazeFace(input_size=16, stem_features=4,
                         block_channels=(8, 12), downsample_blocks=(1,),
                         tap88_block=0)
TINY_STUDENT = BlazeFace(input_size=32, stem_features=4,
                         block_channels=(8, 8, 12), downsample_blocks=(0, 2),
                         tap88_block=1)

TARGET_LOC_ATOL = 1e-5
LOSS_RTOL = 1e-5
HOOK_TOL = dict(rtol=1e-5, atol=1e-5)
TARGETS_RTOL = 1e-5
STEP_TOL = dict(rtol=1e-4, atol=1e-6)
TRAJ_ATOL = 1e-5
OPTAX_RTOL = 1e-6
SCHEDULE_RTOL = 1e-5
SCHEDULE_ATOL = 1e-6       # of the peak: float32's 1 + cos near the end


def jspec(spec: BlazeFace) -> JBlazeFace:
    return JBlazeFace(**dataclasses.asdict(spec))


def jcfg(cfg):
    cls = (jdet.DetectorFitConfig if isinstance(cfg, tdet.DetectorFitConfig)
           else jdet.DetectorDistillConfig)
    return cls(**dataclasses.asdict(cfg))


def init(spec, seed):
    return spec.init(torch.Generator().manual_seed(seed))


def jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def assert_trees(a, b, exact=False, **tol):
    fa, fb = flatten_params(a), flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if exact:
            assert np.array_equal(fa[k], fb[k]), k
        else:
            np.testing.assert_allclose(fa[k], fb[k], err_msg=k, **tol)


def port_net(spec, params):
    net = BlazeFaceNet(spec, device="cpu")
    net.load_state_dict(params_from_jax(spec, params))
    return net


def port_grads(spec, net):
    return params_to_jax(spec, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in net.named_parameters()})


def squares(n, size, seed, k=1):
    """Dark-noise frames with k bright squares, their boxes, a mask and 6
    keypoints a box (tests/test_detector_train.py::_squares / with_kps)."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 60, size=(n, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((n, k, 4), np.float32)
    for i in range(n):
        for j in range(k):
            s = rng.uniform(0.15, 0.6)
            cx, cy = rng.uniform(s / 2, 1 - s / 2, size=2)
            boxes[i, j] = [cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2]
            px = (boxes[i, j] * size).astype(int)
            imgs[i, px[1]:px[3], px[0]:px[2]] = rng.integers(180, 256,
                                                              size=3)
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    mx = (x1 + x2) / 2
    kps = np.stack([np.stack(p, -1) for p in (
        (x1, y1), (x2, y1), (x2, y2), (x1, y2), (mx, y1), (mx, y2))], -2)
    return imgs, boxes, np.ones((n, k), np.float32), kps.astype(np.float32)


def blobs(n, size, seed):
    """Smooth blobs + noise (tests/test_detector_train.py TestDistill)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(n, 4, 4, 3))
    imgs = np.repeat(np.repeat(base, size // 4, 1), size // 4, 2)
    imgs = imgs + rng.integers(-20, 20, size=(n, size, size, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8)


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("spec", [BLAZEFACE_FRONT, BLAZEFACE_BACK,
                                  TINY_STUDENT])
def test_init_shapes_limits_and_seed(spec):
    """BlazeFace.init: JAX's shapes, Glorot-uniform within JAX's limits,
    zero biases, the same params for the same seed."""
    p = init(spec, 0)
    want = jax.eval_shape(lambda: jspec(spec).init(jax.random.PRNGKey(0)))
    got = flatten_params(p)
    shapes = {k: tuple(v.shape) for k, v in flatten_params(
        jax.tree.map(lambda s: np.zeros(s.shape), want)).items()}
    assert {k: v.shape for k, v in got.items()} == shapes
    for k, v in got.items():
        assert v.dtype == np.float32
        if k.endswith("bias"):
            assert not v.any(), k
            continue
        kh, kw, cin, cout = v.shape
        lim = (np.sqrt(6.0 / (9 * cout + 9)) if "dw_kernel" in k
               else np.sqrt(6.0 / (kh * kw * (cin + cout))))
        assert np.abs(v).max() <= lim, k
        assert np.abs(v).max() > 0.5 * lim, k           # it spans the range
    assert_trees(p, init(spec, 0), exact=True)
    assert not np.array_equal(got["stem/kernel"],
                              flatten_params(init(spec, 1))["stem/kernel"])


@pytest.mark.parametrize("spec,taps", [(TINY_STUDENT, (-1, 0, 1)),
                                       (BLAZEFACE_FRONT, (-1, 0, 10))])
def test_tap_blocks_match_jax(spec, taps):
    """tap(x, tap_blocks) returns JAX's apply(tap_blocks=) block{i}_out
    maps (-1 the stem), each also alone, and the tap88 block's map is
    forward's feat88."""
    p = init(spec, 3)
    x = np.random.default_rng(0).uniform(
        -1, 1, (2, spec.input_size, spec.input_size, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jspec(spec).apply(jtree(p), jnp.asarray(x), tap_blocks=taps)
    net = port_net(spec, p)
    with torch.no_grad():
        got = net.tap(torch.from_numpy(x), taps)
        assert sorted(got) == sorted(f"block{t}_out" for t in taps)
        for t in taps:
            key = f"block{t}_out"
            np.testing.assert_allclose(got[key].numpy(), want[key], **HOOK_TOL)
            assert torch.equal(net.tap(torch.from_numpy(x), (t,))[key],
                               got[key])
        tap88 = net.tap(torch.from_numpy(x), (spec.tap88_block,))
        assert torch.equal(tap88[f"block{spec.tap88_block}_out"],
                           net(torch.from_numpy(x))["feat88"])
    with pytest.raises(ValueError, match="tap_blocks"):
        net.tap(torch.from_numpy(x), (len(spec.block_channels),))


# --------------------------------------------------------------- targets
@pytest.mark.parametrize("spec", [BLAZEFACE_FRONT, BLAZEFACE_BACK,
                                  TINY_STUDENT, TINY_TEACHER])
def test_ssd_grids_match_jax(spec):
    assert tdet.ssd_grids(spec) == jdet.ssd_grids(jspec(spec))
    if spec.input_size >= 128:
        assert tdet.ssd_grids(spec) == (16, 8, 2, 6)


def colliding_boxes(seed, B=5, K=7):
    """Random boxes with masked rows, fine and coarse faces, and cell
    collisions: each GT k in 1, 3, 5 repeats the center of GT k-1 (one
    cell, shifted within it), at a scale on the same grid or the other."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.05, 0.7, (B, K))
    c = rng.uniform(0.0, 1.0, (B, K, 2))
    c[:, 1::2] = c[:, 0:-1:2] + rng.uniform(-1e-3, 1e-3, (B, K // 2, 2))
    s[:, 1::4] = s[:, 0:-1:4]                    # same grid, same cell
    boxes = np.concatenate([c - s[..., None] / 2, c + s[..., None] / 2],
                           -1).astype(np.float32)
    mask = (rng.uniform(size=(B, K)) > 0.2).astype(np.float32)
    mask[0] = 1.0
    kps = rng.uniform(0.0, 1.0, (B, K, 6, 2)).astype(np.float32)
    return boxes, mask, kps


@pytest.mark.parametrize("spec", [TINY_STUDENT, BLAZEFACE_FRONT])
@pytest.mark.parametrize("with_kps", [False, True])
def test_ssd_targets_match_jax_with_collisions(spec, with_kps):
    """Labels bit for bit and loc within 1e-5 px of JAX's, where several
    GTs share a cell (JAX keeps the last write: the highest live k)."""
    boxes, mask, kps = colliding_boxes(1)
    got = tdet.ssd_targets(spec, torch.from_numpy(boxes), mask,
                           torch.from_numpy(kps) if with_kps else None)
    want = jdet.ssd_targets(jspec(spec), jnp.asarray(boxes),
                            jnp.asarray(mask),
                            jnp.asarray(kps) if with_kps else None)
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0,
                               atol=TARGET_LOC_ATOL)
    # the collisions are real: fewer positives than live (GT, anchor) pairs
    g1, g2, pc1, pc2 = tdet.ssd_grids(spec)
    fine = np.maximum(boxes[..., 2] - boxes[..., 0],
                      boxes[..., 3] - boxes[..., 1]) < 0.35
    pairs = float((mask * np.where(fine, pc1, pc2)).sum())
    assert float(got[0].sum()) < pairs


@pytest.mark.parametrize("kp_weight", [0.0, 1.0])
def test_ssd_loss_terms_and_gradients_match_jax(kp_weight):
    """The focal and Huber terms and d(total)/d(scores, loc) at rtol
    1e-5."""
    spec = TINY_STUDENT
    boxes, mask, kps = colliding_boxes(2, B=4, K=3)
    labels, loc_tgt = tdet.ssd_targets(spec, torch.from_numpy(boxes), mask,
                                       torch.from_numpy(kps))
    A = labels.shape[1]
    rng = np.random.default_rng(3)
    scores = rng.normal(0, 3, (4, A)).astype(np.float32)
    loc = (loc_tgt.numpy() + rng.normal(0, 4, (4, A, 16))).astype(np.float32)
    cfg = tdet.DetectorFitConfig()
    s_t = torch.tensor(scores, requires_grad=True)
    l_t = torch.tensor(loc, requires_grad=True)
    total, terms = tdet.ssd_loss(spec, {"scores": s_t, "loc": l_t}, labels,
                                 loc_tgt, cfg, kp_weight)
    total.backward()

    def jloss(sc, lc):
        return jdet.ssd_loss(jspec(spec), {"scores": sc, "loc": lc},
                             jnp.asarray(labels.numpy()),
                             jnp.asarray(loc_tgt.numpy()), jcfg(cfg),
                             kp_weight)

    (jt, jterms), (gs, gl) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                has_aux=True)(
        jnp.asarray(scores), jnp.asarray(loc))
    for k in ("loss", "focal", "loc"):
        np.testing.assert_allclose(float(terms[k].detach()), float(jterms[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    for got, want in ((s_t.grad, gs), (l_t.grad, gl)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * np.abs(want).max())


# ------------------------------------------------------------- warm start
def test_warmstart_back_from_front():
    """(BACK, FRONT), where every student leaf has a teacher analog: stem
    and SSD heads copy the teacher's leaves bit for bit, block k >= 1 the
    teacher's block k-1 (aligned from the end), the extra block 0 borrows
    front block 0 (the first with its shapes), as JAX's warmstart_params
    places them (tests/test_detector_train.py::TestWarmstart)."""
    t = init(BLAZEFACE_FRONT, 0)
    ws = tdet.warmstart_params(BLAZEFACE_BACK, BLAZEFACE_FRONT, t)
    for name in ("stem", "cls_front", "cls_back", "loc_front", "loc_back"):
        assert_trees(ws[name], t[name], exact=True)
    for k in range(1, len(BLAZEFACE_BACK.block_channels)):
        assert_trees(ws["blocks"][k], t["blocks"][k - 1], exact=True)
    assert_trees(ws["blocks"][0], t["blocks"][0], exact=True)
    ws["blocks"][0]["pw_kernel"][0, 0, 0, 0] += 1.0   # copies, not views
    assert ws["blocks"][0]["pw_kernel"][0, 0, 0, 0] != \
        t["blocks"][0]["pw_kernel"][0, 0, 0, 0]


def test_warmstart_tiny_keeps_the_given_init():
    """TINY_STUDENT block 1 (8->8) has no shape-compatible teacher block:
    it keeps the init drawn from `key`; the suffix and block 0 copy."""
    t = init(TINY_TEACHER, 1)
    ws = tdet.warmstart_params(TINY_STUDENT, TINY_TEACHER, t,
                               key=torch.Generator().manual_seed(7))
    rnd = init(TINY_STUDENT, 7)
    assert_trees(ws["blocks"][1], rnd["blocks"][1], exact=True)
    assert_trees(ws["blocks"][2], t["blocks"][1], exact=True)
    assert_trees(ws["blocks"][0], t["blocks"][0], exact=True)
    for name in ("stem", "cls_front", "cls_back", "loc_front", "loc_back"):
        same = {k: np.shape(v) for k, v in t[name].items()} == {
            k: np.shape(v) for k, v in rnd[name].items()}
        assert_trees(ws[name], t[name] if same else rnd[name], exact=True)
    # the default key is seed 0
    assert_trees(tdet.warmstart_params(TINY_STUDENT, TINY_TEACHER, t)[
        "blocks"][1], init(TINY_STUDENT, 0)["blocks"][1], exact=True)


# ------------------------------------------------------------ distillation
def test_distill_targets_match_jax_chunked():
    """A chunk that does not divide N: targets and norms at rtol 1e-5."""
    t = init(TINY_TEACHER, 0)
    imgs = blobs(37, 16, 0)
    got, gn = tdet.distill_targets(TINY_TEACHER, t, imgs, chunk=16,
                                   device="cpu")
    want, wn = jdet.distill_targets(jspec(TINY_TEACHER), jtree(t), imgs,
                                    chunk=16)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=TARGETS_RTOL,
                                   atol=TARGETS_RTOL * np.abs(w).max(),
                                   err_msg=k)
    for k in wn:
        np.testing.assert_allclose(float(gn[k]), float(wn[k]),
                                   rtol=TARGETS_RTOL, err_msg=k)


def jax_cell_weights(tgt, norms, spec, eps):
    """detector.py:226-240 (feat_cell_eps > 0) on JAX's targets."""
    g1, g2, pc1, pc2 = jdet.ssd_grids(spec)
    p = tgt["loc_prob"]
    n_front = g1 * g1 * pc1
    tgt["w88"] = eps + p[:, :n_front].reshape(-1, g1, g1, pc1).max(-1)[
        ..., None]
    tgt["w96"] = eps + p[:, n_front:].reshape(-1, g2, g2, pc2).max(-1)[
        ..., None]
    for k, wk in (("feat88", "w88"), ("feat96", "w96")):
        norms[k] = (jnp.sum(tgt[wk] * tgt[k] ** 2)
                    / (jnp.sum(tgt[wk]) * tgt[k].shape[-1] + 1e-6) + 1e-6)
    return tgt, norms


def jax_prefix_loss(s_spec, s_tap, t_spec, t_tap):
    """The loss closure of JAX's distill_prefix (detector.py:354-364)."""
    def loss_fn(p, t_params, imgs):
        with jax.default_matmul_precision("highest"):
            tgt = jax.lax.stop_gradient(t_spec.apply(
                t_params, jpreprocess(imgs, t_spec.input_size, "bgr"),
                tap_blocks=(t_tap,))[f"block{t_tap}_out"])
            out = s_spec.apply(
                p, jpreprocess(imgs, s_spec.input_size, "bgr"),
                tap_blocks=(s_tap,))[f"block{s_tap}_out"]
        loss = jnp.mean((out - tgt) ** 2) / (jnp.mean(tgt ** 2) + 1e-6)
        return loss, {"loss": loss}
    return loss_fn


def jax_fit_loss(spec, cfg, kp_weight):
    """The loss closure of JAX's fit_detector (detector.py:545-551)."""
    js, jc = jspec(spec), jcfg(cfg)

    def loss_fn(p, imgs, labels, loc_tgt):
        with jax.default_matmul_precision("highest"):
            out = js.apply(p, jpreprocess(imgs, spec.input_size, "bgr"))
        return jdet.ssd_loss(js, out, labels, loc_tgt, jc, kp_weight)
    return loss_fn


def jax_distill_loss(s_spec, t_spec, cfg):
    js, jc = jspec(s_spec), jcfg(cfg)
    scale = s_spec.input_size / t_spec.input_size

    def loss_fn(p, imgs, tgt, norms):
        return jdet._distill_loss(js, p, imgs, tgt, norms, scale, jc, "bgr")
    return loss_fn


def jax_targets(t_spec, t_params, imgs, eps):
    tgt, norms = jdet.distill_targets(jspec(t_spec), jtree(t_params), imgs)
    if eps > 0:
        tgt, norms = jax_cell_weights(tgt, norms, jspec(t_spec), eps)
    return tgt, norms


@pytest.mark.parametrize("objective", ["fit", "distill", "distill_cells",
                                       "prefix"])
def test_one_step_loss_and_gradients_match_jax(objective):
    """One batch's loss and its gradient in every leaf against jax.grad of
    JAX's objective on the same params and images."""
    if objective == "fit":
        spec = TINY_STUDENT
        imgs, boxes, mask, kps = squares(8, 32, 0)
        cfg = tdet.DetectorFitConfig()
        p = init(spec, 0)
        labels, loc_tgt = tdet.ssd_targets(spec, torch.from_numpy(boxes),
                                           mask, torch.from_numpy(kps))
        net = port_net(spec, p)
        out = net(preprocess(torch.from_numpy(imgs), spec.input_size))
        loss, _ = tdet.ssd_loss(spec, out, labels, loc_tgt, cfg, 1.0)
        (jl, _), jg = jax.jit(jax.value_and_grad(jax_fit_loss(
            spec, cfg, 1.0), has_aux=True))(
            jtree(p), imgs, jnp.asarray(labels.numpy()),
            jnp.asarray(loc_tgt.numpy()))
    elif objective.startswith("distill"):
        spec = TINY_STUDENT
        eps = 0.2 if objective == "distill_cells" else 0.0
        cfg = tdet.DetectorDistillConfig(feat_cell_eps=eps)
        t = init(TINY_TEACHER, 1)
        imgs = blobs(8, 16, 1)
        p = init(spec, 2)
        tgt, norms = tdet.distill_targets(TINY_TEACHER, t, imgs,
                                          device="cpu")
        if eps:
            jt, jn = jax_targets(TINY_TEACHER, t, imgs, eps)
            tgt.update({k: torch.from_numpy(np.array(jt[k]))
                        for k in ("w88", "w96")})
            norms.update({k: torch.tensor(float(jn[k]))
                          for k in ("feat88", "feat96")})
        net = port_net(spec, p)
        out = net(preprocess(torch.from_numpy(imgs), spec.input_size))
        loss, _ = tdet._distill_loss(out, tgt, norms, 2.0, cfg)
        jt = {k: jnp.asarray(v.numpy()) for k, v in tgt.items()}
        jn = {k: jnp.asarray(v.numpy()) for k, v in norms.items()}
        (jl, _), jg = jax.jit(jax.value_and_grad(jax_distill_loss(
            spec, TINY_TEACHER, cfg), has_aux=True))(jtree(p), imgs, jt, jn)
    else:
        spec = TINY_STUDENT
        t = init(TINY_TEACHER, 1)
        imgs = blobs(8, 16, 2)
        p = tdet.warmstart_params(spec, TINY_TEACHER, t)
        net = port_net(spec, p)
        teacher = port_net(TINY_TEACHER, t)
        loss = tdet._prefix_loss(net, 0, teacher, 0, torch.from_numpy(imgs),
                                 "bgr")
        (jl, _), jg = jax.jit(jax.value_and_grad(jax_prefix_loss(
            jspec(spec), 0, jspec(TINY_TEACHER), 0), has_aux=True))(
            jtree(p), jtree(t), imgs)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=STEP_TOL["rtol"])
    got = port_grads(spec, net)
    want = jax.tree.map(np.asarray, jg)
    fg, fw = flatten_params(got), flatten_params(want)
    for k in fw:
        np.testing.assert_allclose(fg[k], fw[k], rtol=STEP_TOL["rtol"],
                                   atol=STEP_TOL["atol"], err_msg=k)


def jax_trajectory(loss_fn, params, opt, batches, labels=None):
    """A JAX composition of the trainers' step (detector.py run_block):
    jax.grad of loss_fn, the optax chain, apply_updates; one step per
    batch."""
    @jax.jit
    def step(params, state, *batch):
        grads, m = jax.grad(loss_fn, has_aux=True)(params, *batch)
        updates, state = opt.update(grads, state, params)
        return optax.apply_updates(params, updates), state, m

    state = opt.init(params)
    hist = []
    for batch in batches:
        params, state, m = step(params, state, *batch)
        hist.append(float(m["loss"]))
    return jax.tree.map(np.asarray, params), np.asarray(hist)


def optax_sched(cfg):
    return optax.warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, max(cfg.warmup_steps, 1),
        max(cfg.steps, cfg.warmup_steps + 1))


STEPS = 20


def given_indices(n, batch, seed=5):
    return np.random.default_rng(seed).integers(0, n, (STEPS, batch))


def test_fit_detector_trajectory_matches_jax():
    """20 steps of fit_detector (keypoints on) on given batches against
    JAX's ssd_loss through optax.adam(warmup_cosine): params atol 1e-5."""
    spec = TINY_STUDENT
    imgs, boxes, mask, kps = squares(24, 32, 1)
    cfg = tdet.DetectorFitConfig(steps=STEPS, batch_size=6, warmup_steps=5,
                                 learning_rate=2e-3, steps_per_sync=7)
    p0 = init(spec, 4)
    idx = given_indices(24, 6)
    got, hist = tdet._fit_detector(spec, imgs, boxes, mask, cfg,
                                   keypoints=kps, kp_weight=1.0,
                                   init_params=p0, device="cpu", indices=idx)
    labels, loc_tgt = jdet.ssd_targets(jspec(spec), jnp.asarray(boxes),
                                       jnp.asarray(mask), jnp.asarray(kps))
    loss = jax_fit_loss(spec, cfg, 1.0)
    want, jh = jax_trajectory(
        lambda p, i: loss(p, jnp.asarray(imgs)[i], labels[i], loc_tgt[i]),
        jtree(p0), optax.adam(optax_sched(cfg)), [(i,) for i in idx])
    assert_trees(got, want, rtol=0, atol=TRAJ_ATOL)
    np.testing.assert_allclose(hist["loss"], jh, rtol=STEP_TOL["rtol"])
    assert sorted(hist) == ["focal", "loc", "loss"]


def test_distill_detector_trajectory_matches_jax():
    """20 steps of distill_detector (feat_cell_eps 0.2, the clip on) on
    given batches against JAX's _distill_loss through
    chain(clip_by_global_norm, adam(warmup_cosine)), at lr 2e-3: at 5e-3
    the two separate by 4.0e-5 from step 10, where a kink (a ReLU or a
    pooling tie) is crossed on one side only, though from JAX's params at
    every step the port's gradients agree within 1.9e-6 of each leaf's
    largest."""
    imgs = blobs(20, 16, 3)
    t = init(TINY_TEACHER, 3)
    cfg = tdet.DetectorDistillConfig(steps=STEPS, batch_size=5,
                                     warmup_steps=4, learning_rate=2e-3,
                                     steps_per_sync=8, feat_cell_eps=0.2)
    p0 = tdet.warmstart_params(TINY_STUDENT, TINY_TEACHER, t)
    idx = given_indices(20, 5)
    got, hist = tdet._distill_detector(TINY_STUDENT, TINY_TEACHER, t, imgs,
                                       cfg, init_params=p0, device="cpu",
                                       indices=idx)
    tgt, norms = jax_targets(TINY_TEACHER, t, imgs, 0.2)
    loss = jax_distill_loss(TINY_STUDENT, TINY_TEACHER, cfg)
    opt = optax.chain(optax.clip_by_global_norm(cfg.clip_norm),
                      optax.adam(optax_sched(cfg)))
    want, jh = jax_trajectory(
        lambda p, i: loss(p, jnp.asarray(imgs)[i],
                          jax.tree.map(lambda a: a[i], tgt), norms),
        jtree(p0), opt, [(i,) for i in idx])
    assert_trees(got, want, rtol=0, atol=TRAJ_ATOL)
    np.testing.assert_allclose(hist["loss"], jh, rtol=STEP_TOL["rtol"])
    assert sorted(hist) == ["feat", "loc", "loss", "score"]


def test_distill_prefix_trajectory_matches_jax():
    """20 steps of distill_prefix (stem + block 0 trained) on given batches
    against JAX's prefix closure through multi_transform({train: chain(
    clip, adam), freeze: set_to_zero}); the frozen leaves stay bitwise."""
    imgs = blobs(20, 16, 4)
    t = init(TINY_TEACHER, 5)
    cfg = tdet.DetectorDistillConfig(steps=STEPS, batch_size=5,
                                     warmup_steps=4, learning_rate=5e-3,
                                     steps_per_sync=6)
    p0 = tdet.warmstart_params(TINY_STUDENT, TINY_TEACHER, t)
    idx = given_indices(20, 5)
    got, hist = tdet._distill_prefix(TINY_STUDENT, 0, TINY_TEACHER, 0, t,
                                     imgs, cfg, init_params=p0,
                                     device="cpu", indices=idx)
    labels = jax.tree.map(lambda _: "freeze", p0)
    labels["stem"] = jax.tree.map(lambda _: "train", labels["stem"])
    labels["blocks"][0] = jax.tree.map(lambda _: "train",
                                       labels["blocks"][0])
    inner = optax.chain(optax.clip_by_global_norm(cfg.clip_norm),
                        optax.adam(optax_sched(cfg)))
    opt = optax.multi_transform({"train": inner,
                                 "freeze": optax.set_to_zero()}, labels)
    loss = jax_prefix_loss(jspec(TINY_STUDENT), 0, jspec(TINY_TEACHER), 0)
    jt = jtree(t)
    want, jh = jax_trajectory(
        lambda p, i: loss(p, jt, jnp.asarray(imgs)[i]), jtree(p0), opt,
        [(i,) for i in idx])
    assert_trees(got, want, rtol=0, atol=TRAJ_ATOL)
    np.testing.assert_allclose(hist["loss"], jh, rtol=STEP_TOL["rtol"])
    for i in (1, 2):
        assert_trees(got["blocks"][i], p0["blocks"][i], exact=True)
    for name in ("cls_front", "cls_back", "loc_front", "loc_back"):
        assert_trees(got[name], p0[name], exact=True)
    assert not np.array_equal(got["stem"]["kernel"], p0["stem"]["kernel"])


def test_frozen_stem_stays_bitwise_and_the_loss_finite():
    """train_stem=False: the stem upstream of the tap is frozen and comes
    back bit for bit, the loss stays finite (the port's side of JAX's
    test_frozen_upstream_params_do_not_drift)."""
    t = init(TINY_TEACHER, 3)
    imgs = np.random.default_rng(1).integers(
        0, 256, size=(16, 16, 16, 3)).astype(np.uint8)
    ws = tdet.warmstart_params(TINY_STUDENT, TINY_TEACHER, t)
    cfg = tdet.DetectorDistillConfig(steps=40, batch_size=8,
                                     learning_rate=5e-3, warmup_steps=5,
                                     steps_per_sync=20)
    p2, hist = tdet.distill_prefix(TINY_STUDENT, 0, TINY_TEACHER, 0, t, imgs,
                                   cfg, train_stem=False, init_params=ws,
                                   device="cpu")
    assert np.all(np.isfinite(hist["loss"]))
    assert_trees(p2["stem"], ws["stem"], exact=True)
    assert not np.array_equal(p2["blocks"][0]["pw_kernel"],
                              ws["blocks"][0]["pw_kernel"])


def test_on_sync_fires_at_block_ends_and_history_has_every_step():
    spec = TINY_STUDENT
    imgs, boxes, mask, _ = squares(12, 32, 2)
    seen = []
    cfg = tdet.DetectorFitConfig(steps=7, batch_size=4, steps_per_sync=3)
    _, hist = tdet.fit_detector(spec, imgs, boxes, mask, cfg, device="cpu",
                                on_sync=lambda d, m: seen.append((d, m)))
    assert [d for d, _ in seen] == [3, 6, 7]
    assert all(len(v) == 7 for v in hist.values())
    for d, m in seen:
        assert sorted(m) == ["focal", "loc", "loss"]
        assert m["loss"] == pytest.approx(float(hist["loss"][d - 1]))
    # the same seed draws the same batches: a second run repeats the first
    _, again = tdet.fit_detector(spec, imgs, boxes, mask, cfg, device="cpu")
    assert np.array_equal(again["loss"], hist["loss"])
    # the first update is zero (warmup from 0, schedule at the count before)
    p0 = init(spec, 9)
    p1, _ = tdet.fit_detector(spec, imgs, boxes, mask,
                              dataclasses.replace(cfg, steps=1),
                              init_params=p0, device="cpu")
    assert_trees(p1, p0, exact=True)


def test_other_precisions_raise():
    """Strings outside the three JAX's trainers pass (JAX's enum spellings
    "bfloat16" and "tensorfloat32") raise, naming the served strings."""
    spec = TINY_STUDENT
    imgs, boxes, mask, _ = squares(4, 32, 0)
    served = "'highest', 'high', 'default'"
    with pytest.raises(NotImplementedError, match=served):
        tdet.fit_detector(spec, imgs, boxes, mask,
                          tdet.DetectorFitConfig(precision="bfloat16"),
                          device="cpu")
    with pytest.raises(NotImplementedError, match=served):
        tdet.distill_detector(
            TINY_STUDENT, TINY_TEACHER, init(TINY_TEACHER, 0),
            imgs[:, :16, :16],
            tdet.DetectorDistillConfig(precision="tensorfloat32"),
            device="cpu")


def test_surface_and_defaults_match_jax():
    assert set(jdet.__all__) <= set(dir(tdet))
    for cls in ("DetectorFitConfig", "DetectorDistillConfig"):
        assert dataclasses.asdict(getattr(tdet, cls)()) == \
            dataclasses.asdict(getattr(jdet, cls)())


# -------------------------------------------------------------- optimizer
def test_schedules_match_optax():
    for args in ((0.0, 1e-3, 50, 300), (0.0, 2e-3, 1, 2), (0.1, 1.0, 7, 20)):
        ours = optim.warmup_cosine_decay_schedule(*args)
        want = optax.warmup_cosine_decay_schedule(*args)
        for c in range(0, args[3] + 5):
            np.testing.assert_allclose(ours(c), float(want(c)),
                                       rtol=SCHEDULE_RTOL,
                                       atol=SCHEDULE_ATOL * args[1])
    assert optim.warmup_cosine_decay_schedule(0.0, 1e-3, 50, 300)(0) == 0.0
    ours, want = (optim.cosine_decay_schedule(1e-5, 36),
                  optax.cosine_decay_schedule(1e-5, 36))
    for c in range(40):
        np.testing.assert_allclose(ours(c), float(want(c)),
                                   rtol=SCHEDULE_RTOL,
                                   atol=SCHEDULE_ATOL * 1e-5)


@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adam_clip_and_freeze_match_optax_step_by_step(clip):
    """Adam (+ clip) over the "train" leaves and set_to_zero over the
    "freeze" ones, against optax.multi_transform step by step: the first
    update zero, the clip's norm over the trained leaves only (a frozen
    leaf's huge gradient would clip everything), frozen leaves bitwise."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "frozen": (2, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * (100.0 if k == "frozen" else 0.3))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(6)]
    sched = optax.warmup_cosine_decay_schedule(0.0, 0.05, 2, 6)
    inner = optax.adam(sched)
    if clip:
        inner = optax.chain(optax.clip_by_global_norm(clip), inner)
    labels = {"a": "train", "b": "train", "frozen": "freeze"}
    opt = optax.multi_transform({"train": inner,
                                 "freeze": optax.set_to_zero()}, labels)
    jp, state = jtree(p0), opt.init(jtree(p0))

    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    trained = optim.freeze(tp.items(), lambda k: k != "frozen")
    ours = optim.Adam(trained, optim.warmup_cosine_decay_schedule(
        0.0, 0.05, 2, 6), clip_norm=clip)
    for i, g in enumerate(grads):
        upd, state = opt.update(jtree(g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.tensor(g[k]) if p.requires_grad else None
        ours.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=OPTAX_RTOL,
                                       atol=1e-7, err_msg=f"step {i} {k}")
        if i == 0:
            for k in shapes:
                assert np.array_equal(tp[k].detach().numpy(), p0[k])
    assert np.array_equal(tp["frozen"].detach().numpy(), p0["frozen"])
    assert not tp["frozen"].requires_grad
