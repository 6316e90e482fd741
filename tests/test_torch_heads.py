"""The port's head families, EnsembleHead, the weight bridge for each, and
the survivors head profile of FaceDetector, on the CPU against the JAX
package.  Random weights start from JAX's own init; inputs come from a seed
with numpy."""
import dataclasses
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from headpose_tpu.models import heads as jheads
from headpose_tpu.pretrained import PRETRAINED_DIR as JAX_PRETRAINED_DIR
from headpose_tpu.pretrained import load_pretrained as jax_load_pretrained
from headpose_tpu.runtime.detector import FaceDetector as JaxFaceDetector
from headpose_tpu.tools.export import spec_from_dict as jax_spec_from_dict
from headpose_tpu_torch.models import heads as theads
from headpose_tpu_torch.models.params import (flatten_params, params_from_jax,
                                              params_to_jax, spec_from_dict)
from headpose_tpu_torch.pretrained import (BEST, FLAGSHIP, UNIFIED_BEST,
                                           load_pretrained)
from headpose_tpu_torch.runtime.detector import FaceDetector

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")


def perturbed_init(jspec, seed):
    """JAX's init of a head, each leaf then moved by N(0, 0.05) noise so
    that biases are not zero: numpy leaves in JAX layout."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + rng.normal(
        0, 0.05, a.shape)).astype(np.float32),
        jspec.init(jax.random.PRNGKey(seed)))


def port_head(spec, params):
    net = theads.head_net(spec, device="cpu")
    net.load_state_dict(params_from_jax(spec, params))   # strict
    return net


FAMILIES = {
    "mlp": ("MLPHead", dict(in_features=88, layers=((32, "tanh"),
                                                    (3, "linear")))),
    "residual": ("ResidualMLPHead", dict(in_features=88)),
    "residual_tanh": ("ResidualMLPHead", dict(in_features=96, width=24,
                                              num_blocks=2,
                                              activation="tanh")),
    "skip": ("SkipMLPHead", dict(in_features=96, activation="tanh")),
    "se_mlp": ("SEMLPHead", dict(in_features=88)),
    "se_transformer": ("SETransformerHead", dict(in_features=96,
                                                 num_heads=2, key_dim=8)),
}


def _family(name):
    cls, fields = FAMILIES[name]
    return getattr(jheads, cls)(**fields), getattr(theads, cls)(**fields)


@pytest.mark.parametrize("form", ["rows", "map"])
@pytest.mark.parametrize("name", ["residual", "residual_tanh", "skip",
                                  "se_mlp"])
def test_family_matches_jax_apply(name, form):
    """Each module against the JAX `apply` at rtol = atol = 1e-5, on (40, C)
    rows and on (2, 8, 8, C) maps."""
    jspec, spec = _family(name)
    params = perturbed_init(jspec, 7)
    c = spec.in_features
    shape = (40, c) if form == "rows" else (2, 8, 8, c)
    x = np.random.default_rng(7).normal(0, 2, shape).astype(np.float32)
    want = np.asarray(jspec.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port_head(spec, params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (*shape[:-1], 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_se_mlp_pools_on_a_map_and_not_on_rows():
    """On a map the SE gate averages every cell (spatial_context); on rows
    each vector is its own squeeze, so a map's cells evaluated as rows give
    another result."""
    jspec, spec = _family("se_mlp")
    params = perturbed_init(jspec, 8)
    x = np.random.default_rng(8).normal(0, 2, (1, 8, 8, 88)).astype(
        np.float32)
    net = port_head(spec, params)
    with torch.no_grad():
        on_map = net(torch.from_numpy(x)).reshape(-1, 3)
        on_rows = net(torch.from_numpy(x.reshape(-1, 88)))
    assert spec.spatial_context and not theads.SkipMLPHead().spatial_context
    assert float((on_map - on_rows).abs().max()) > 1e-3
    want = np.asarray(jspec.apply(params, jnp.asarray(x.reshape(-1, 88))))
    np.testing.assert_allclose(on_rows.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_bridge_round_trips_every_family(name):
    """params_from_jax → module → params_to_jax gives back every leaf of a
    JAX init bit for bit (the SE-Transformer's 3-D and 2-D attention leaves
    keep their layout)."""
    jspec, spec = _family(name)
    params = perturbed_init(jspec, 1)
    back = flatten_params(params_to_jax(spec, port_head(spec, params)
                                        .state_dict()))
    want = flatten_params(params)
    assert sorted(back) == sorted(want)
    for k in want:
        assert back[k].shape == want[k].shape, k
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_bridge_round_trips_an_ensemble_of_every_family():
    jmembers, members = zip(*(_family(n) for n in ("mlp", "residual",
                                                   "se_mlp", "residual")))
    jspec = jheads.EnsembleHead(jmembers)
    spec = theads.EnsembleHead(members)
    params = perturbed_init(jspec, 2)
    net = port_head(spec, params)
    assert net.groups == [[0], [1, 3], [2]]
    back = flatten_params(params_to_jax(spec, net.state_dict()))
    want = flatten_params(params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_ensemble_spec_validates_as_jax_does():
    m = theads.SkipMLPHead()
    with pytest.raises(ValueError, match="at least one"):
        theads.EnsembleHead(())
    with pytest.raises(ValueError, match="in_features"):
        theads.EnsembleHead((m, theads.SkipMLPHead(in_features=96)))
    with pytest.raises(ValueError, match="weight rows"):
        theads.EnsembleHead((m,), weights=((1.0, 1.0, 1.0),) * 2)
    with pytest.raises(ValueError, match="bias requires"):
        theads.EnsembleHead((m,), bias=(0.0, 0.0, 0.0))
    assert not theads.EnsembleHead((m, m)).spatial_context
    assert theads.EnsembleHead((m, theads.SEMLPHead())).spatial_context


# ------------------------------------------------------------- ensembles
@pytest.fixture(scope="module")
def heads_golden():
    return np.load(os.path.join(GOLDEN, "heads.npz"))


@pytest.mark.parametrize("model,head", [
    (UNIFIED_BEST, "head88"), (UNIFIED_BEST, "head96"),
    ("ensemble88", None), ("ensemble96-stacked", None)])
def test_ensemble_matches_jax_apply(heads_golden, model, head):
    """unified-best's stacked ensembles (99 members in 18 groups), the
    uniform ensemble88 and the stacked ensemble96 against the JAX
    EnsembleHead.apply (its grouped inference path) on the feature-map
    cells of tests/golden/heads.npz, at rtol 1e-5 and atol 1e-6 of the
    largest output.  The members' sum cancels terms of up to about 100
    degrees, and both implementations lie 2.4e-5 to 5.3e-5 from a float64
    evaluation of the same ensemble (outputs up to 107 degrees), so an atol
    of 1e-5 on outputs near 0 is below fp32's resolution here; measured
    port against JAX: 4.6e-5 at most, 0.46 of this bound."""
    jspec, jparams = jax_load_pretrained(model)
    if head is not None:
        jspec, jparams = getattr(jspec, head), jparams[head]
    spec = _port_spec(jspec)
    assert isinstance(spec, theads.EnsembleHead)
    assert (spec.weights is None) == (model == "ensemble88")
    c = spec.in_features
    x = heads_golden[f"xmap{c}"].reshape(-1, c)
    want = np.asarray(jspec.apply(jparams, jnp.asarray(x)))
    net = port_head(spec, jax.tree.map(np.asarray, jparams))
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (len(x), 3)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _port_spec(jspec):
    """The port's spec of a JAX spec, through the JSON format."""
    from headpose_tpu.tools.export import spec_to_dict

    return spec_from_dict(json.loads(json.dumps(spec_to_dict(jspec))))


def test_every_shipped_spec_decodes():
    """spec_from_dict decodes each spec.json the JAX package ships (18) into
    the port's specs, field for field."""
    paths = sorted(glob.glob(os.path.join(JAX_PRETRAINED_DIR, "*",
                                          "spec.json")))
    assert len(paths) == 18
    for path in paths:
        with open(path) as f:
            doc = json.load(f)["spec"]
        spec, jspec = spec_from_dict(doc), jax_spec_from_dict(doc)
        assert type(spec).__name__ == type(jspec).__name__, path
        assert dataclasses.asdict(spec) == dataclasses.asdict(jspec), path


# ------------------------------------------------------- the detector
@pytest.fixture(scope="module")
def corpus4():
    return np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:4]


def _np(batch):
    return {k: np.asarray(getattr(batch, k)) for k in FIELDS}


def _assert_detections(got, want, pose_tol):
    """Identical valid, boxes / keypoints / scores at the detector tests'
    tolerances, poses at rtol = atol = pose_tol."""
    np.testing.assert_array_equal(got["valid"], want["valid"])
    assert want["valid"].sum() >= 4
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-4)
    np.testing.assert_allclose(got["keypoints"], want["keypoints"],
                               atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5)
    np.testing.assert_allclose(got["poses"], want["poses"], rtol=pose_tol,
                               atol=pose_tol)


@pytest.fixture(scope="module")
def unified_best_jax(corpus4):
    jspec, jparams = jax_load_pretrained(UNIFIED_BEST)
    jdet = JaxFaceDetector(jspec, jparams)
    assert jdet.head_eval == "survivors"
    return _np(jdet.detect(corpus4))


@pytest.mark.parametrize("path", ["detect", "detect_fused"])
def test_unified_best_matches_jax_detector(unified_best_jax, corpus4, path):
    """unified-best (99 ensemble members) at head_eval='auto' against the
    JAX FaceDetector on 4 corpus frames: identical detection sets, poses
    within rtol = atol = 1e-4."""
    spec, params = load_pretrained(UNIFIED_BEST)
    det = FaceDetector(spec, params, device="cpu")
    assert det.head_eval == "survivors"
    _assert_detections(_np(getattr(det, path)(corpus4)), unified_best_jax,
                       1e-4)


@pytest.mark.parametrize("name,want", [(FLAGSHIP, "map"), (BEST, "map"),
                                       (UNIFIED_BEST, "survivors")])
def test_auto_resolves_as_jax_does(name, want):
    spec, params = load_pretrained(name)
    jdet = JaxFaceDetector(*jax_load_pretrained(name))
    assert FaceDetector(spec, params, device="cpu").head_eval == want
    assert jdet.head_eval == want


def test_survivors_profile_keeps_per_cell_heads_exact(corpus4):
    """For per-cell heads (the flagship's MLPs) the survivors profile runs
    the same function on the same vectors: the 'map' poses."""
    spec, params = load_pretrained(FLAGSHIP)
    a = _np(FaceDetector(spec, params, head_eval="map",
                         device="cpu").detect(corpus4))
    b = _np(FaceDetector(spec, params, head_eval="survivors",
                         device="cpu").detect(corpus4))
    for k in ("valid", "boxes", "scores"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    np.testing.assert_allclose(b["poses"], a["poses"], rtol=1e-5, atol=1e-5)
    assert (b["poses"][~b["valid"]] == 0).all()
