"""The MLP pose-head kernel's arithmetic (csrc/head_mlp.cu), emulated on the
CPU from its padded pack and launch table, against the plain version at the
kernel's tolerance (rtol = atol = 1e-5, chip_smoke.py's HEAD_TOL); and why
the kernel multiplies in fp32 and not in 3-pass TF32 on the tensor cores.
Inputs: tests/golden/heads.npz's feature-map cells for the shipped heads,
rows made from a seed with numpy for random heads."""
import os
import re

import numpy as np
import pytest
import torch

from headpose_tpu_torch.core.activations import (ACTIVATIONS, activation_id,
                                                 get_activation)
from headpose_tpu_torch.models import MLPHead, MLPHeadNet
from headpose_tpu_torch.models.params import params_from_jax
from headpose_tpu_torch.ops.kernels import head_mlp as khead
from headpose_tpu_torch.ops.kernels.tf32 import matmul_3xtf32
from headpose_tpu_torch.pretrained import BEST, FLAGSHIP, load_pretrained

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
HEAD_TOL = dict(rtol=1e-5, atol=1e-5)
SHIPPED = [f"{m}.{h}" for m in (FLAGSHIP, BEST) for h in ("head88", "head96")]


def _ratio(got, want):
    """max |got - want| / (atol + rtol |want|): <= 1 within HEAD_TOL."""
    return float(((got - want).abs()
                  / (HEAD_TOL["atol"] + HEAD_TOL["rtol"] * want.abs())).max())


def _shipped(name):
    """(net, its heads.npz cells as rows) of 'model.head'."""
    model, head = name.split(".")
    spec, params = load_pretrained(model)
    hspec = getattr(spec, head)
    net = MLPHeadNet(hspec, device="cpu")
    net.load_state_dict(params_from_jax(hspec, params[head]))
    k = hspec.in_features
    x = np.load(os.path.join(GOLDEN, "heads.npz"))[f"xmap{k}"].reshape(-1, k)
    return net, torch.from_numpy(x)


def _random(layers, n, seed, c=88):
    """A head with Glorot-uniform weights and small normal biases, and n
    rows of N(0, 2), made with numpy."""
    rng = np.random.default_rng(seed)
    net = MLPHeadNet(MLPHead(c, layers), device="cpu")
    with torch.no_grad():
        for layer in net.layers:
            out, cin = layer.weight.shape
            lim = np.sqrt(6.0 / (cin + out))
            layer.weight.copy_(torch.from_numpy(
                rng.uniform(-lim, lim, (out, cin)).astype(np.float32)))
            layer.bias.copy_(torch.from_numpy(
                rng.normal(0, 0.05, out).astype(np.float32)))
    x = torch.from_numpy(rng.normal(0, 2, (n, c)).astype(np.float32))
    return net, x


def _fma_chain(a, w):
    """a (n, K) @ w (K, M) as the kernel sums each output: one fmaf chain
    over k in order from 0 (each step exact in float64, rounded to
    float32)."""
    acc = torch.zeros((a.shape[0], w.shape[1]), dtype=torch.float32)
    a64, w64 = a.double(), w.double()
    for k in range(a.shape[1]):
        acc = (acc.double() + a64[:, k:k + 1] * w64[k:k + 1]).float()
    return acc


def _emulate(net, x):
    """The kernel's arithmetic from what it is given: the pack and the
    launch table.  Each layer computes all its padded columns (a padded
    column is act(0 + 0)); the next layer reads only its K real inputs; the
    last layer's real columns are the output."""
    pack = khead.head_pack(net)
    table = list(pack.table)
    n, c = table[:2]
    h, k = x, c
    for layer in range(n):
        width, act, w_off, b_off = table[2 + 4 * layer:6 + 4 * layer]
        np4 = width + -width % 4
        w = pack.weights[w_off:w_off + k * np4].reshape(k, np4)
        b = pack.weights[b_off:b_off + np4]
        act_fn = get_activation(list(ACTIVATIONS)[act])
        h = act_fn(_fma_chain(h[:, :k], w) + b)
        k = width
    return h[:, :k]


# 88 -> 37 -> 5 -> 3: widths that are not multiples of 4 (padded columns
# carry act(0), nonzero for sigmoid, softplus, gelu, ...), each activation
# in both hidden layers
PADDED = {f"padded_{a}": ((37, a), (5, a), (3, "linear")) for a in ACTIVATIONS}


@pytest.mark.parametrize("name", SHIPPED + list(PADDED))
def test_kernel_arithmetic_within_head_tol(name):
    """The emulated kernel lies within HEAD_TOL of mlp_head_forward_plain
    (measured: bitwise equal on every case here, the plain version's CPU
    product summing in the same order)."""
    if name in PADDED:
        net, x = _random(PADDED[name], 513, len(name))
    else:
        net, x = _shipped(name)
    with torch.no_grad():
        want = khead.mlp_head_forward_plain(net, x)
        got = _emulate(net, x)
    assert got.shape == want.shape
    assert _ratio(got, want) <= 1.0
    torch.testing.assert_close(got, want, **HEAD_TOL)


def test_3xtf32_misses_head_tol():
    """Why the kernel is not on the tensor cores: every product as 3-pass
    TF32 (lo.hi + hi.lo + hi.hi, csrc/se_attention.cu's precision) lies
    beyond HEAD_TOL of the plain version on a shipped head's cells
    (measured: 1.39x on unified-best-distilled's head96, 1.001x on the
    flagship's head88, 0.71x on the other two), though it lies as close to
    float64 as the plain version does (about 0.7x each)."""
    ratios = {}
    for name in SHIPPED:
        net, x = _shipped(name)
        with torch.no_grad():
            want = khead.mlp_head_forward_plain(net, x)
            h = x
            for layer, (_, act) in zip(net.layers, net.spec.layers):
                h = get_activation(act)(
                    matmul_3xtf32(h, layer.weight.t().contiguous())
                    + layer.bias)
            exact = net.double()(x.double()).float()
        assert _ratio(h, exact) < 1.0 and _ratio(want, exact) < 1.0
        ratios[name] = _ratio(h, want)
    assert ratios[f"{BEST}.head96"] > 1.0, ratios


def test_launch_table_and_pack_layout():
    """The table lists the layers as the kernel reads them; every leaf
    starts 16-byte aligned, with zero padding columns; table and pack are
    built once and follow the weights."""
    net, _ = _random(((37, "gelu"), (5, "selu"), (3, "linear")), 1, 0)
    pack = khead.head_pack(net)
    table = list(pack.table)
    assert table[:2] == [3, 88]
    assert [table[2 + 4 * i:4 + 4 * i] for i in range(3)] == [
        [37, activation_id("gelu")], [5, activation_id("selu")],
        [3, activation_id("linear")]]
    offs = [table[4 + 4 * i:6 + 4 * i] for i in range(3)]
    assert [o for pair in offs for o in pair] == list(pack.offsets)
    assert all(o % 4 == 0 for o in pack.offsets)
    assert pack.offsets == (0, 88 * 40, 88 * 40 + 40, 88 * 40 + 40 + 37 * 8,
                            88 * 40 + 40 + 37 * 8 + 8,
                            88 * 40 + 40 + 37 * 8 + 8 + 5 * 4)
    w0 = pack.weights[:88 * 40].reshape(88, 40)
    assert not w0[:, 37:].any()
    assert torch.equal(w0[:, :37], net.layers[0].weight.t())
    assert khead.head_pack(net) is pack
    with torch.no_grad():
        net.layers[1].bias.add_(1.0)
    again = khead.head_pack(net)
    assert again is not pack and again.table is not pack.table


def test_kernel_limits_match_the_wrapper():
    """csrc/head_mlp.cu's domain is the one domain_error states."""
    src = open(os.path.join(REPO, "headpose_tpu_torch", "csrc",
                            "head_mlp.cu")).read()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kMaxLayers"]) == khead.MAX_LAYERS
    assert int(consts["kMaxWidth"]) == khead.MAX_WIDTH
    wide = MLPHeadNet(MLPHead(khead.MAX_WIDTH, ((khead.MAX_WIDTH, "tanh"),
                                                (3, "linear"))), device="cpu")
    assert khead.domain_error(wide) is None
    wider = MLPHeadNet(MLPHead(88, ((khead.MAX_WIDTH + 1, "tanh"),
                                    (3, "linear"))), device="cpu")
    assert "at most" in khead.domain_error(wider)
