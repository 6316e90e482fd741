"""A configuration brings its pose heads by kind and its detector options
as data: each head's `kind` names perfbench/reference/heads/<kind>.py,
each key of its launch plan perfbench/kernels/<key>.py, and its optional
"detector" object reaches `FaceDetector.from_native`.  A head kind, a
kernel and a configuration added as new files only are taken by the
harness, the reference and the counts."""
import json
import os
import shutil

import numpy as np
import pytest

from perfbench.harness import cells
from perfbench.kernels import model
from perfbench.reference import image
from perfbench.reference.detector import Reference
from perfbench.reference.model import head_kind
from perfbench.runners import common

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SEED = 2**31 + 24

# a head that couples its map's cells: each cell's first three channels
# less their mean over the map
TOY_HEAD = '''"""A toy head kind for the tests."""
COUPLES_CELLS = True


def build(head_spec, params, prefix, device):
    def head(x):
        return x[..., :3] - x[..., :3].mean(dim=(1, 2), keepdim=True)
    return head


def flops(head_spec, cells):
    return 2 * cells * 3
'''
TOY_KERNEL = '''"""A toy kernel for the tests."""


def matches(name):
    return "toy_head_kernel" in name
'''


def _config(name="flagship.fast"):
    with open(os.path.join(ROOT, "perfbench", "configs", name + ".json")) as f:
        return json.load(f)


def _frames():
    return np.load(os.path.join(ROOT, "tests", "golden",
                                "parity_corpus.npz"))["imgs"][:4]


@pytest.fixture(scope="module")
def room(tmp_path_factory):
    """A copy of perfbench/ to which a toy head kind, a toy kernel, a
    configuration naming both (its heads "map"-evaluated) and a limits file
    are added as new files; (repository root, the bytes of every file the
    copy had before)."""
    top = tmp_path_factory.mktemp("room")
    pb = top / "perfbench"
    shutil.copytree(os.path.join(ROOT, "perfbench"), pb,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in pb.rglob("*") if p.is_file()}
    (pb / "reference" / "heads" / "toy.py").write_text(TOY_HEAD)
    (pb / "kernels" / "toy.py").write_text(TOY_KERNEL)
    cfg = _config()
    for name in ("head88", "head96"):
        cfg["spec"][name]["kind"] = "toy"
    cfg["launches"] = {"backbone2": 8, "toy": 2, "postprocess": 1}
    cfg["detector"] = {"head_eval": "map"}
    (pb / "configs" / "toy.fast.json").write_text(json.dumps(cfg))
    shutil.copy(pb / "limits" / "flagship.fast-b256-128px.json",
                pb / "limits" / "toy.fast-b256-128px.json")
    return top, before


def test_a_head_kind_added_as_files_is_taken(room):
    """The cell loads from its files; the reference runs the toy heads
    over the network's taps; the model's FLOPs count them by their kind;
    the launch guard finds the toy kernel's matcher; no file the copy had
    before is edited."""
    import torch

    top, before = room
    pb = str(top / "perfbench")
    cell = cells.from_files("toy.fast-b256-128px", root=str(top))
    assert cell.config["spec"]["head88"]["kind"] == "toy"
    weights = os.path.join(ROOT, cell.config["weights"])
    ref = Reference(cell.config, weights, root=pb)
    frames = _frames()
    out = ref.outputs(frames)
    with torch.no_grad():
        f88, f96 = (t.permute(0, 2, 3, 1)[..., :3] for t in ref.net.taps(
            image.preprocess(torch.from_numpy(frames), ref.size)))
    np.testing.assert_array_equal(
        out["pose_front"], (f88 - f88.mean(dim=(1, 2), keepdim=True)).numpy())
    np.testing.assert_array_equal(
        out["pose_back"], (f96 - f96.mean(dim=(1, 2), keepdim=True)).numpy())
    flagship = Reference(_config(), weights)
    for got, want in zip(ref.detect(frames), flagship.detect(frames)):
        np.testing.assert_array_equal(got["boxes"], want["boxes"])
        assert got["poses"].shape == want["poses"].shape
    spec = _config()["spec"]
    mlp = head_kind("mlp")
    heads = mlp.flops(spec["head88"], 256) + mlp.flops(spec["head96"], 64)
    assert model.network_flops(cell.config["spec"], root=pb) == (
        model.network_flops(spec) - heads + 2 * (256 + 64) * 3)
    found = common.matchers(cell.config["launches"], root=pb)
    assert sorted(found) == ["backbone2", "postprocess", "toy"]
    assert found["toy"]("void (anonymous namespace)::toy_head_kernel<1>()")
    assert not found["toy"]("void mlp_head_kernel<64>()")
    assert all(p.read_bytes() == data for p, data in before.items())


@pytest.mark.parametrize("detector", [None, {"head_eval": "survivors"},
                                      {"head_eval": "auto"}])
def test_the_reference_refuses_another_profile_for_coupled_heads(room,
                                                                 detector):
    """Without "map", the program would judge coupled heads on each face's
    own vector (or "auto" resolve to that): the reference refuses."""
    top, _ = room
    cfg = cells.from_files("toy.fast-b256-128px", root=str(top)).config
    cfg.pop("detector")
    if detector is not None:
        cfg["detector"] = detector
    with pytest.raises(ValueError, match="'map'"):
        Reference(cfg, os.path.join(ROOT, cfg["weights"]),
                  root=str(top / "perfbench"))


def test_an_unknown_head_kind_names_its_file():
    cfg = _config()
    cfg["spec"]["head96"]["kind"] = "no_such_kind"
    want = os.path.join(ROOT, "perfbench", "reference", "heads",
                        "no_such_kind.py")
    with pytest.raises(FileNotFoundError, match=want):
        Reference(cfg, os.path.join(ROOT, cfg["weights"]))
    with pytest.raises(FileNotFoundError, match=want):
        model.network_flops(cfg["spec"])


def test_an_unknown_launch_plan_key_names_its_file():
    want = os.path.join(ROOT, "perfbench", "kernels", "no_such_kernel.py")
    with pytest.raises(FileNotFoundError, match=want):
        common.matchers({"postprocess": 1, "no_such_kernel": 2})


@pytest.fixture(scope="module")
def se_model(tmp_path_factory):
    """A native model directory: the flagship's backbone with seeded
    SE-Transformer heads."""
    import torch
    from headpose_tpu_torch.models.heads import SETransformerHead
    from headpose_tpu_torch.models.unified import UnifiedPoseModel
    from headpose_tpu_torch.pretrained import FLAGSHIP, load_pretrained
    from headpose_tpu_torch.tools.export import save_model

    spec, params = load_pretrained(FLAGSHIP)
    g = torch.Generator().manual_seed(SEED)
    heads = {"head88": SETransformerHead(88), "head96": SETransformerHead(96)}
    path = tmp_path_factory.mktemp("se") / "model"
    save_model(str(path), UnifiedPoseModel(backbone=spec.backbone, **heads),
               {"backbone": params["backbone"],
                **{k: h.init(g) for k, h in heads.items()}})
    return str(path / "params.npz")


@pytest.mark.parametrize("detector,head_eval", [
    (None, "survivors"), ({"head_eval": "map"}, "map"),
    ({"head_eval": "survivors"}, "survivors")])
def test_detector_options_reach_the_detector(se_model, detector, head_eval):
    """The configuration's "detector" object is passed to
    `FaceDetector.from_native`; without it the SE heads' "auto" resolves to
    "survivors"."""
    cfg = dict(_config(), weights=se_model)
    if detector is not None:
        cfg["detector"] = detector
    assert common.detector(cfg, "cpu").head_eval == head_eval


@pytest.mark.parametrize("clash", [{"precision": "highest"},
                                   {"max_faces": 5}, {"device": "cpu"},
                                   {"head_eval": "map", "mesh": None}])
def test_a_detector_option_the_harness_sets_raises(se_model, clash):
    cfg = dict(_config(), weights=se_model, detector=clash)
    with pytest.raises(ValueError, match="the harness sets itself"):
        common.detector(cfg, "cpu")
