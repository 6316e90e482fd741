"""The four faults of the port found against the JAX package, each held to
the JAX function on the same input: the package surface, the contract of
`ops.detection.anchor_cells` (and the single-image detection blocks beside
it), the positional options of `FaceDetector`, and `like=` of the
checkpoint restore."""
import collections
import importlib
import os

import numpy as np
import pytest
import torch

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# names of JAX's __all__ that wait for a later slice (ROADMAP.md §1)
NOT_PORTED = {
    "": {"parallel"},                                    # item 8
}


def _surface(pkg: str) -> list[str]:
    mod = importlib.import_module(f"headpose_tpu{'.' + pkg if pkg else ''}")
    return sorted(set(mod.__all__) - {"__version__"})


@pytest.mark.parametrize("pkg", ["", "core", "models", "ops", "data",
                                 "utils", "runtime", "train", "tools"])
def test_subpackages_export_jax_names(pkg):
    """Every name of JAX's __all__ that the port has ported is importable
    from the port's subpackage of the same name."""
    port = importlib.import_module(
        f"headpose_tpu_torch{'.' + pkg if pkg else ''}")
    want = set(_surface(pkg)) - NOT_PORTED.get(pkg, set())
    assert want, pkg
    missing = [n for n in sorted(want) if not hasattr(port, n)]
    assert not missing, missing
    assert want <= set(port.__all__) | {"__version__"}


def test_anchor_cells_matches_jax():
    """An index array in, (is_front, r16, c16, r8, c8) out: at 513 JAX
    gives (False, 15, 0, 0, 0); every anchor index, and sentinels past the
    table, as JAX's."""
    from headpose_tpu.ops.detection import anchor_cells as jax_cells
    from headpose_tpu_torch.ops import anchor_cells

    got = [t.numpy() for t in anchor_cells([0, 511, 512, 513, 895])]
    assert [int(t[3]) if i else bool(t[3]) for i, t in enumerate(got)] == \
        [False, 15, 0, 0, 0]
    idx = np.concatenate([np.arange(896), [896, 1000, 4095]]).astype(np.int32)
    for ours, theirs in zip(anchor_cells(torch.from_numpy(idx)),
                            jax_cells(idx)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_detection_blocks_match_jax():
    """decode_boxes, decode_keypoints, pairwise_iou, nms_static (with ties,
    nan and invalid rows) and gather_poses against JAX's on seeded inputs."""
    import jax.numpy as jnp

    import headpose_tpu.ops.detection as J
    import headpose_tpu_torch.ops as T
    from headpose_tpu_torch.models.anchors import (FRONT_CONFIG,
                                                   generate_anchors)

    rng = np.random.default_rng(0)
    anchors = generate_anchors(FRONT_CONFIG).astype(np.float32)
    loc = rng.normal(0.0, 8.0, (2, 896, 16)).astype(np.float32)
    ta, tl = torch.from_numpy(anchors), torch.from_numpy(loc)
    for name in ("decode_boxes", "decode_keypoints"):
        np.testing.assert_allclose(getattr(T, name)(tl, ta, 128).numpy(),
                                   np.asarray(getattr(J, name)(loc, anchors,
                                                               128)),
                                   rtol=1e-6, atol=1e-7)
    boxes = np.array(J.decode_boxes(loc[0], anchors, 128))
    np.testing.assert_allclose(T.pairwise_iou(torch.from_numpy(boxes[:64]))
                               .numpy(),
                               np.asarray(J.pairwise_iou(boxes[:64])),
                               rtol=1e-6, atol=1e-7)
    scores = rng.normal(size=896).astype(np.float32)
    scores[10] = scores[20] = 5.0                    # a tie: 10 wins
    scores[30] = np.nan
    valid = rng.random(896) < 0.7
    for max_out, thr in ((100, 0.3), (5, 0.5), (896, 0.0)):
        sel, keep = T.nms_static(torch.from_numpy(boxes),
                                 torch.from_numpy(scores),
                                 torch.from_numpy(valid), max_out, thr)
        jsel, jkeep = J.nms_static(jnp.asarray(boxes), jnp.asarray(scores),
                                   jnp.asarray(valid), max_out, thr)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    pf = rng.normal(size=(16, 16, 3)).astype(np.float32)
    pb = rng.normal(size=(8, 8, 3)).astype(np.float32)
    idx = np.array([0, 1, 77, 511, 512, 513, 600, 895], np.int32)
    np.testing.assert_array_equal(
        T.gather_poses(torch.from_numpy(idx), torch.from_numpy(pf),
                       torch.from_numpy(pb)).numpy(),
        np.asarray(J.gather_poses(idx, pf, pb)))
    assert T.score_threshold_to_logit(0.4) == J.score_threshold_to_logit(0.4)


@pytest.fixture(scope="module")
def flagship():
    from headpose_tpu_torch.pretrained import load_flagship

    return load_flagship()


def test_face_detector_takes_jax_positional_order(flagship):
    """FaceDetector(model, params, 0.5) sets the score threshold, and the
    whole positional order is JAX's: the resolved attributes agree."""
    from headpose_tpu.pretrained import load_flagship as jax_load
    from headpose_tpu.runtime.detector import FaceDetector as JaxDetector
    from headpose_tpu_torch.models.anchors import FRONT_CONFIG
    from headpose_tpu_torch.runtime.detector import FaceDetector

    model, params = flagship
    assert FaceDetector(model, params, 0.5,
                        device="cpu").score_threshold == 0.5
    args = (0.5, 0.35, 50, 128, "rgb", "highest", None, None, "xla", "map")
    det = FaceDetector(model, params, *args, device="cpu")
    jdet = JaxDetector(*jax_load(), *args)
    for attr in ("score_threshold", "iou_threshold", "max_faces",
                 "input_size", "channel_order", "precision", "postprocess",
                 "head_eval", "turbo_island"):
        assert getattr(det, attr) == getattr(jdet, attr), attr
    np.testing.assert_array_equal(det.anchors.numpy(),
                                  np.asarray(jdet.anchors))
    FaceDetector(model, params, input_size=128, anchor_config=FRONT_CONFIG,
                 device="cpu")


def test_face_detector_refusals(flagship):
    """Another input size or anchor table than the backbone's, an unknown
    postprocess, and a mesh (ROADMAP §1 item 8) raise."""
    from headpose_tpu_torch.models.anchors import BACK_CONFIG
    from headpose_tpu_torch.runtime.detector import FaceDetector

    model, params = flagship
    with pytest.raises(ValueError, match="input_size"):
        FaceDetector(model, params, input_size=256, device="cpu")
    with pytest.raises(ValueError, match="anchor_config"):
        FaceDetector(model, params, anchor_config=BACK_CONFIG, device="cpu")
    with pytest.raises(ValueError, match="postprocess"):
        FaceDetector(model, params, postprocess="triton", device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        FaceDetector(model, params, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="item 8"):
        FaceDetector(model, params, data_axis="batch", device="cpu")


def test_postprocess_backends_match_jax(flagship):
    """postprocess='xla' (the plain chain), 'pallas' and 'auto' (the
    kernel's wrapper: its plain version on the CPU) give bit-identical
    slabs, and JAX's 'xla' detect the same sets and poses."""
    from headpose_tpu.pretrained import flagship_detector as jax_flagship
    from headpose_tpu_torch.runtime.detector import FaceDetector

    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:4]
    model, params = flagship
    slabs = {pp: FaceDetector(model, params, postprocess=pp,
                              device="cpu").detect(imgs).slab
             for pp in ("xla", "pallas", "auto")}
    assert torch.equal(slabs["xla"], slabs["pallas"])
    assert torch.equal(slabs["xla"], slabs["auto"])
    want = jax_flagship(postprocess="xla").detect(imgs)
    valid = slabs["xla"][..., 20].numpy() > 0.5
    np.testing.assert_array_equal(valid, np.asarray(want.valid))
    np.testing.assert_allclose(slabs["xla"][..., 16:19].numpy()[valid],
                               np.asarray(want.poses)[valid], atol=2e-3)


class OptState(collections.namedtuple("OptState", "count mu")):
    pass


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"layers": [{"w": rng.normal(size=(4, 3)).astype(np.float32),
                        "b": rng.normal(size=3).astype(np.float32)}]}


@pytest.mark.parametrize("best", [False, True])
def test_restore_checkpoint_like_matches_jax(tmp_path, best):
    """restore_checkpoint(..., like=) re-imposes the leaves onto like's
    structure and container types (a NamedTuple optimizer state, a tuple),
    best_params sharing params' structure, as JAX's does."""
    from headpose_tpu.train import checkpoints as J
    from headpose_tpu_torch.train import checkpoints as T

    params, best_params = _tree(0), _tree(1)
    opt = OptState(np.array(3, np.int32), (_tree(2), _tree(3)))
    kw = {"best_params": best_params} if best else {}
    like = {"params": params, "opt_state": opt}
    J.save_checkpoint(str(tmp_path / "jax"), 5, params, opt, **kw)
    T.save_checkpoint(str(tmp_path / "torch"), 5, params, opt, **kw)
    got = T.restore_checkpoint(str(tmp_path / "torch"), like=like)
    want = J.restore_checkpoint(str(tmp_path / "jax"), like=like)
    assert got[0] == want[0] == 5
    for g, w in ((got[1], want[1]), (got[2], want[2]), (got[4], want[4])):
        assert type(g) is type(w)
        if w is None:
            continue
        gl, gd = _flat(g)
        wl, wd = _flat(w)
        assert gd == wd
        for a, b in zip(gl, wl):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert isinstance(got[2], OptState) and isinstance(got[2].mu, tuple)
    if best:
        np.testing.assert_array_equal(got[4]["layers"][0]["w"],
                                      best_params["layers"][0]["w"])
    plain = T.restore_pytree(str(tmp_path / "torch" / "step_5"))
    assert isinstance(plain["opt_state"], list)    # no like: plain lists


def _flat(tree):
    """(leaves, container-type description) in a stable order."""
    if isinstance(tree, dict):
        parts = [_flat(tree[k]) for k in sorted(tree)]
        return ([l for p in parts for l in p[0]],
                ("dict", tuple(sorted(tree)), tuple(p[1] for p in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [_flat(v) for v in tree]
        return ([l for p in parts for l in p[0]],
                (type(tree).__name__, tuple(p[1] for p in parts)))
    return [np.asarray(tree)], "leaf"
