"""The port's heads, backbone and unified model against the goldens and the
JAX package, with the same weights (handed over as numpy through the port's
weight bridge)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu.models.blazeface import BLAZEFACE_BACK as JAX_BACK
from headpose_tpu.models.heads import MLPHead as JaxMLPHead
from headpose_tpu_torch.core.activations import ACTIVATIONS
from headpose_tpu_torch.models import (BLAZEFACE_BACK, BlazeFaceNet, MLPHead,
                                       MLPHeadNet, UnifiedPoseNet)
from headpose_tpu_torch.models.params import params_from_jax, params_to_jax
from headpose_tpu_torch.pretrained import FLAGSHIP, load_pretrained

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _head(spec, params):
    net = MLPHeadNet(spec, device="cpu")
    net.load_state_dict(params_from_jax(spec, params))
    return net


@pytest.fixture(scope="module")
def flagship():
    spec, params = load_pretrained(FLAGSHIP)
    net = UnifiedPoseNet(spec, device="cpu").eval()
    net.load_state_dict(params_from_jax(spec, params))
    return spec, params, net


@pytest.mark.parametrize("x,y,head", [("x88", "y88", "head88"),
                                      ("x96", "y96", "head96"),
                                      ("xmap88", "ymap88", "head88"),
                                      ("xmap96", "ymap96", "head96")])
def test_flagship_heads_match_golden(flagship, x, y, head):
    """The production heads (stoqa9pt, hrchr82r) on per-face vectors and on
    whole maps against tests/golden/heads.npz; rtol/atol 1e-5."""
    spec, params, _ = flagship
    g = np.load(os.path.join(GOLDEN, "heads.npz"))
    net = _head(getattr(spec, head), params[head])
    with torch.no_grad():
        out = net(torch.from_numpy(g[x])).numpy()
    np.testing.assert_allclose(out, g[y], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("act", sorted(ACTIVATIONS))
def test_mlp_head_matches_jax_for_every_activation(act):
    """Every Keras activation of the table, through a 2-layer head on a
    feature map, against JAX MLPHead.apply; rtol/atol 1e-5."""
    jspec = JaxMLPHead(8, ((16, act), (3, "linear")))
    params = _numpy(jspec.init(jax.random.PRNGKey(len(act))))
    x = np.random.default_rng(1).normal(0, 2, (2, 4, 4, 8)).astype(np.float32)
    want = np.asarray(jspec.apply(params, jnp.asarray(x)))
    net = _head(MLPHead(8, ((16, act), (3, "linear"))), params)
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_unified_reference_outputs_match_golden(flagship):
    """All six outputs of the reference H5 signature against
    tests/golden/unified_forward.npz at the tolerances of
    tests/test_models.py:115 (rtol 1e-3, atol 2e-4)."""
    _, _, net = flagship
    g = np.load(os.path.join(GOLDEN, "unified_forward.npz"))
    with torch.no_grad():
        outs = net.reference_outputs(torch.from_numpy(g["inputs"]))
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o.numpy(), g[f"out{i}"], rtol=1e-3,
                                   atol=2e-4, err_msg=f"output {i}")


def _backbone_vs_jax(jspec, spec, params, seed):
    rng = np.random.default_rng(seed)
    s = spec.input_size
    x = rng.uniform(-1, 1, (2, s, s, 3)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jspec.apply(params, jnp.asarray(x))
    net = BlazeFaceNet(spec, device="cpu")
    net.load_state_dict(params_from_jax(spec, params))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    for k in ("feat88", "feat96", "scores", "loc"):
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-4, err_msg=k)


def test_backbone_front_matches_jax(flagship):
    """The flagship backbone at B=2 against JAX BlazeFace.apply; rtol/atol
    1e-4 (fp32 convs summed in another order)."""
    from headpose_tpu.models.blazeface import BLAZEFACE_FRONT as JAX_FRONT

    spec, params, _ = flagship
    _backbone_vs_jax(JAX_FRONT, spec.backbone, params["backbone"], 0)


def test_backbone_back_spec_matches_jax():
    """BLAZEFACE_BACK (256 input, four downsample stages) at a random
    Glorot-uniform init made with numpy from a seed."""
    rng = np.random.default_rng(3)
    shapes = params_to_jax(BLAZEFACE_BACK, BlazeFaceNet(
        BLAZEFACE_BACK, device="cpu").state_dict())

    def init(leaf):
        if leaf.ndim == 1:
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        kh, kw, cin, cout = leaf.shape
        lim = np.sqrt(6.0 / (kh * kw * (cin + cout)))
        return rng.uniform(-lim, lim, leaf.shape).astype(np.float32)

    params = jax.tree.map(init, shapes)
    _backbone_vs_jax(JAX_BACK, BLAZEFACE_BACK, params, 1)
