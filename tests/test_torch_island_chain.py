"""The island plan of "turbo" and "max" and its chains, on the CPU:
`dense_bf16.island_chains` (which island blocks run as one chain launch and
which run alone) on the front, back and wide specs, the Python mirror of
the chain kernel's shared-memory layout (`chain_plan`, which the plan
reads; the block kernel picks its own tiles, and tests/test_torch_gpu.py
and chip_smoke.py hold its plan to a block's shared memory), the
plain chain (`dense_chain_plain`) inside `apply_fused_plain` against the
per-block plain composition bit for bit, the plain chain against float64
on the same bf16-rounded operands, block by block and whole, and the
backbone with chains against the JAX function at simulate_fast=True.
Inputs are made from a seed with numpy.

How a chain is held, here and on the card (chip_smoke.py, tests/
test_torch_gpu.py): (a) each block of a chain exactly as tight as one
island block, fed the chain's own intermediate (here SUM_ORDER_ULPS of
float64, as tests/test_torch_precision_modes.py holds dense_block_plain;
on the card the kernel's prefix chains, first..k, give the chain's own
intermediates and each block is held at 1e-5 of the map against
dense_block_plain on them); and (b) the whole chain against its composition
within CHAIN_TOL_FRAC, because an element one fp32 ulp apart before the
next block's bf16 rounding can land one bf16 step apart and carry that
through the blocks after it.  Both, because (a) alone does not see a fault
between blocks that a prefix shares with the whole chain (none is known),
and (b) alone is too loose to see a small arithmetic fault."""
import numpy as np
import pytest
import torch

from headpose_tpu.models.blazeface import BlazeFace as JaxBlazeFace
from headpose_tpu.models.blazeface import turbo_fast_blocks as jax_turbo
from headpose_tpu_torch.models import (BLAZEFACE_BACK, BLAZEFACE_FRONT,
                                       BlazeFace, BlazeFaceNet,
                                       turbo_fast_blocks)
from headpose_tpu_torch.ops.kernels import backbone as kbb
from headpose_tpu_torch.ops.kernels import backbone2 as kb2
from headpose_tpu_torch.ops.kernels import dense_bf16 as kd
from headpose_tpu_torch.ops.kernels import library
from headpose_tpu_torch.runtime.fused import island_of
from test_torch_precision_modes import (SUM_ORDER_ULPS, U32, _float64_island,
                                        _frames, _island_input,
                                        _outputs_close, models)  # noqa: F401

WIDE = BlazeFace(block_channels=(24, 28, 32, 36, 42, 48, 56, 64, 72, 80, 88,
                                 96, 104, 112, 120, 128))
# a 16x16 map at 128 channels: its fp32 map (131,072 bytes) and A operand
# (18 x 18 x 68 words, 88,128 bytes) leave no room for two weight slots
TOO_WIDE = BlazeFace(input_size=32, stem_features=128,
                     block_channels=(128, 128), downsample_blocks=(1,),
                     tap88_block=0)
SPECS = {"front": BLAZEFACE_FRONT, "back": BLAZEFACE_BACK, "wide": WIDE}

# The whole chain against its composition: one bf16 step (2^-7 of a value:
# bf16 keeps 8 significant bits) of the output map's largest |value|.  An
# fp32 ulp before a rounding moves that element by at most one bf16 step of
# itself, and the blocks after it carry the change on; measured against
# float64 on the CPU at most 4.5e-3 (10 blocks, random frames) and 1.4e-3
# (corpus frames), on the card against the plain chain (chip_smoke.py)
CHAIN_TOL_FRAC = 2.0 ** -7

BLK = [("block", i) for i in range(7)]
PLANS = {
    ("front", "turbo"): (("chain", 10, 15),),
    ("front", "max"): (*BLK[:6], ("chain", 6, 15)),
    ("front", "empty"): (),
    ("back", "turbo"): (("chain", 11, 16),),
    ("back", "max"): (*BLK, ("chain", 7, 16)),
    ("back", "empty"): (),
    ("wide", "turbo"): (("chain", 10, 15),),
    ("wide", "max"): (*BLK[:6], ("chain", 6, 15)),
    # arbitrary islands: a run split by a missing block, a run split at the
    # 32x32 -> 16x16 boundary, a single small-map block, large maps only
    ("front", (6, 7, 9, 10, 11)): (("chain", 6, 7), ("chain", 9, 11)),
    ("front", (4, 5, 6, 7)): (("block", 4), ("block", 5), ("chain", 6, 7)),
    ("front", (13,)): (("chain", 13, 13),),
    ("front", (0, 2, 3)): (("block", 0), ("block", 2), ("block", 3)),
    ("back", (6, 12, 13, 15)): (("block", 6), ("chain", 12, 13),
                                ("chain", 15, 15)),
    ("too_wide", "max"): (("block", 0), ("block", 1)),
}


def _spec(name):
    return TOO_WIDE if name == "too_wide" else SPECS[name]


def _island(spec, mode):
    if mode == "empty":
        return ()
    if isinstance(mode, tuple):
        return mode
    return island_of(spec, mode) if mode == "turbo" else tuple(
        range(len(spec.block_channels)))


# ---------------------------------------------------------------- the plan
@pytest.mark.parametrize("key", list(PLANS), ids=[f"{s}-{m}" for s, m in
                                                  PLANS])
def test_island_chains(key):
    """The expected launches; every island block in exactly one of them, in
    block order; every chain a run of consecutive blocks on maps of at most
    CHAIN_PIXELS pixels whose layout fits."""
    spec = _spec(key[0])
    island = _island(spec, key[1])
    steps = kd.island_chains(spec, island)
    assert steps == PLANS[key]
    covered = []
    for step in steps:
        covered += (list(range(step[1], step[2] + 1)) if step[0] == "chain"
                    else [step[1]])
    assert covered == sorted(island)
    shapes = kd._shapes(spec)
    for step in steps:
        if step[0] == "chain":
            assert all(shapes[i][3] ** 2 <= kd.CHAIN_PIXELS
                       for i in range(step[1], step[2] + 1))
            assert kd.chain_plan(*kd._chain_args(spec, step[1], step[2]))


def test_turbo_chain_covers_jax_turbo_island():
    """The "turbo" plan runs exactly JAX's turbo island, as one chain, on
    both topologies."""
    for spec, jspec in ((BLAZEFACE_FRONT, JaxBlazeFace()),
                        (BLAZEFACE_BACK, JaxBlazeFace(
                            input_size=256,
                            block_channels=BLAZEFACE_BACK.block_channels,
                            downsample_blocks=(0, 3, 6, 12),
                            tap88_block=11))):
        want = jax_turbo(jspec)
        assert kd.island_chains(spec, turbo_fast_blocks(spec)) == (
            ("chain", want[0], want[-1]),)


def test_island_chains_refuses_blocks_the_spec_lacks():
    with pytest.raises(ValueError, match="not blocks of this spec"):
        kd.island_chains(BLAZEFACE_FRONT, (15, 16))


# ------------------------------------------------------------- the layouts
def test_layouts_by_hand():
    """The mirror against the chain kernel's layout worked by hand.  The
    front chain 6-15 (and 10-15): the 16x16 map at its widest 88 channels,
    90,112 bytes (the 8x8 map at 96, 24,576, shares it); the largest A
    operand, block 11's 17 x 17 pixels of 48 + 2 words, 57,800 -> 57,808; a
    tap's weights, 96 rows of 48 + 4 words, 19,968 a slot; 4 slots fit,
    with an 8-byte mbarrier each: 227,824."""
    for first in (6, 10):
        plan = kd.chain_plan(*kd._chain_args(BLAZEFACE_FRONT, first, 15))
        assert plan == kd.ChainPlan(4, 227824, 90112, 12)


@pytest.mark.parametrize("name", ["front", "back", "wide", "too_wide"])
def test_every_block_and_chain_fits_or_runs_alone(name):
    """Every maximal run of small-map blocks in "max" is a chain whose
    layout fits a block's shared memory (232,448 bytes), or runs block by
    block (TOO_WIDE: its 16x16 map at 128 channels does not fit); every
    block the plan runs alone is one the block kernel takes."""
    spec = _spec(name)
    n = len(spec.block_channels)
    steps = kd.island_chains(spec, range(n))
    for step in steps:
        if step[0] == "block":
            cin, cout, s, h = kd._shapes(spec)[step[1]]
            assert kd._block_takes(h, cin, cout, s)
    small = [i for i, (_, _, _, h) in enumerate(kd._shapes(spec))
             if h * h <= kd.CHAIN_PIXELS]
    plan = kd.chain_plan(*kd._chain_args(spec, small[0], n - 1))
    if plan is None:
        assert all(step[0] == "block" for step in steps)
    else:
        assert plan.smem <= kd.SMEM_MAX and 2 <= plan.stages
        assert steps[-1] == ("chain", small[0], n - 1)


# ------------------------------------------------- the plain composition
def _by_hand(net, x, island):
    """The backbone as it ran before chains: the plain stem, each segment,
    each fp32 block and each island block alone, in block order; (feat88,
    feat96)."""
    spec = net.spec
    plan = kb2.segment_plan(spec, island)
    firsts = {f: name for name, (f, _, _) in plan.items()}
    w = list(kbb._leaves(net))
    with torch.no_grad():
        y = torch.relu(kbb._stem(x, w[0], w[1]))
        feat88, i = None, 0
        while i < len(spec.block_channels):
            if i in firsts:
                y = kb2.run_segment_plain(net, y, firsts[i], island)
                last = plan[firsts[i]][1]
            elif i in island:
                y, last = kd.dense_block_plain(net, i, y), i
            else:
                y = kbb._block(y, *w[2 + 4 * i:6 + 4 * i], kb2._stride(net, i))
                last = i
            if last == spec.tap88_block:
                feat88 = y
            i = last + 1
    return feat88, y


@pytest.mark.parametrize("mode", ["turbo", "max"])
@pytest.mark.parametrize("model", ["flagship", "back"])
def test_apply_fused_plain_with_chains_is_block_by_block(models, model,
                                                         mode):
    """apply_fused_plain, whose island now runs as chains, against the same
    backbone composed block by block, bit for bit, feat88 included (the
    tap lies inside the chain in both modes)."""
    net = models[model][3].backbone
    x = torch.from_numpy(_frames("corpus", net.spec.input_size))
    island = _island(net.spec, mode)
    assert any(s[0] == "chain" and s[1] <= net.spec.tap88_block < s[2]
               for s in kd.island_chains(net.spec, island))
    got = kb2.apply_fused_plain(net, x, island)
    want = _by_hand(net, x, island)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_dense_chain_on_the_cpu_is_the_plain_chain(models):
    """dense_chain on a CPU tensor is dense_chain_plain (no kernel, no
    launch counted), the composition of dense_block_plain; the tap inside
    the chain comes back, and None when it lies outside."""
    net = models["flagship"][3].backbone
    x = torch.from_numpy(_island_input(np.random.default_rng(5), 2, 16, 80))
    before = library.launches()["dense_chain"]
    y, tap = kd.dense_chain(net, 10, 15, x)
    assert library.launches()["dense_chain"] == before
    want = x
    for i in range(10, 16):
        want = kd.dense_block_plain(net, i, want)
        if i == 10:
            assert torch.equal(tap, want)
    assert torch.equal(y, want)
    x12 = torch.from_numpy(_island_input(np.random.default_rng(6), 2, 8, 96))
    y, tap = kd.dense_chain(net, 12, 15, x12)
    assert tap is None and tuple(y.shape) == (2, 8, 8, 96)


def test_dense_chain_refuses_what_the_plan_does_not_take(models):
    """A run the plan does not make a chain (a large map in it, a block the
    spec lacks), another input side, a float16 input, and the kernel side
    on a CPU tensor: ValueError."""
    net = models["flagship"][3].backbone
    with pytest.raises(ValueError, match="not a chain"):
        kd.dense_chain(net, 5, 7, torch.zeros((1, 32, 32, 42)))
    with pytest.raises(ValueError, match="not blocks"):
        kd.dense_chain(net, 12, 16, torch.zeros((1, 8, 8, 96)))
    with pytest.raises(ValueError, match=r"takes \(B, 8, 8, 96\)"):
        kd.dense_chain(net, 12, 15, torch.zeros((1, 16, 16, 96)))
    with pytest.raises(ValueError, match="float32"):
        kd.dense_chain(net, 12, 15, torch.zeros((1, 8, 8, 96),
                                                dtype=torch.float16))
    with pytest.raises(ValueError, match="CUDA"):
        kd.dense_chain_cuda(net, 12, 15, torch.zeros((1, 8, 8, 96)))


# ----------------------------------------------------------- float64
def _chain_cases():
    cases = []
    for model in ("flagship", "back"):
        for mode in ("turbo", "max"):
            cases.append((model, mode))
    return cases


@pytest.mark.parametrize("frames", ["random", "corpus"])
@pytest.mark.parametrize("model,mode", _chain_cases(),
                         ids=[f"{m}-{o}" for m, o in _chain_cases()])
def test_plain_chain_against_float64(models, model, mode, frames):
    """Each chain of the mode's plan in plain torch ops against float64 on
    the same bf16-rounded operands, from the chain's own input (the
    backbone's map in front of it, on 2 frames): (a) each block, fed the
    plain chain's own intermediate, within SUM_ORDER_ULPS units of fp32
    roundoff of its sum of |terms|; (b) the whole chain against the float64
    chain (each block's input its float64 predecessor rounded to fp32)
    within CHAIN_TOL_FRAC of the map's largest |value|."""
    net = models[model][3].backbone
    island = _island(net.spec, mode)
    x = torch.from_numpy(_frames(frames, net.spec.input_size))
    inputs = {}
    with torch.no_grad():
        w = list(kbb._leaves(net))
        y = torch.relu(kbb._stem(x, w[0], w[1]))
        for i in range(len(net.blocks)):
            inputs[i] = y
            y = kd.dense_block_plain(net, i, y)
    for step in kd.island_chains(net.spec, island):
        if step[0] != "chain":
            continue
        first, last = step[1], step[2]
        got, _ = kd.dense_chain_plain(net, first, last, inputs[first])
        y, y64 = inputs[first], inputs[first].numpy()
        for i in range(first, last + 1):                        # (a)
            want, scale = _float64_island(net, i, y.numpy())
            y = kd.dense_block_plain(net, i, y)
            units = np.abs(y.numpy() - want) / (U32 * scale)
            assert units.max() <= SUM_ORDER_ULPS, (i, units.max())
            y64, _ = _float64_island(net, i, y64.astype(np.float32))
        assert torch.equal(got, y)
        diff = np.abs(got.numpy() - y64)                         # (b)
        assert diff.max() <= CHAIN_TOL_FRAC * np.abs(y64).max(), (
            step, diff.max() / np.abs(y64).max())


@pytest.mark.parametrize("mode", ["turbo", "max"])
@pytest.mark.parametrize("model", ["flagship", "back"])
def test_backbone_with_chains_matches_jax_simulate_fast(models, model, mode):
    """The backbone of apply_fused_plain with the island in chains against
    JAX's BlazeFace.apply(dense=True, fast_blocks=island,
    simulate_fast=True) at HIGHEST on 2 corpus frames: both taps within
    test_torch_precision_modes's MEAN_DIFF_FRAC / MAX_DIFF_FRAC (the
    blocks outside the island run split-bf16 here, fp32 there; a bf16 flip
    now and then in the island)."""
    import jax
    import jax.numpy as jnp

    spec, jspec, params, net = models[model]
    bb = net.backbone
    x = _frames("corpus", bb.spec.input_size)
    island = _island(bb.spec, mode)
    with jax.default_matmul_precision("highest"):
        want = jspec.backbone.apply(params["backbone"], jnp.asarray(x),
                                    dense=True, fast_blocks=island,
                                    simulate_fast=True)
    got = dict(zip(("feat88", "feat96"),
                   kb2.apply_fused_plain(bb, torch.from_numpy(x), island)))
    _outputs_close(got, want, ("feat88", "feat96"))


def test_wide_spec_chain_composes_block_by_block():
    """The 128-channel wide spec (random weights from a seed): its "max"
    chain 6-15 in plain ops equals the blocks one by one, tap included."""
    net = BlazeFaceNet(WIDE, device="cpu").eval()
    rng = np.random.default_rng(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.from_numpy(
                rng.normal(0.0, 0.2, tuple(p.shape)).astype(np.float32)))
    x = torch.from_numpy(_island_input(np.random.default_rng(9), 2, 16, 48))
    y, tap = kd.dense_chain_plain(net, 6, 15, x)
    want = x
    for i in range(6, 16):
        want = kd.dense_block_plain(net, i, want)
        if i == WIDE.tap88_block:
            assert torch.equal(tap, want)
    assert torch.equal(y, want) and tuple(y.shape) == (2, 8, 8, 128)
