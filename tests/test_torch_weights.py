"""The port's committed weights and its independence from JAX.

* params.npz of each shipped model is bitwise the JAX package's Orbax
  checkpoint of the same name;
* the weight bridge round-trips;
* headpose_tpu_torch imports neither jax nor headpose_tpu (an AST scan, and
  a subprocess in which both are import-blocked runs a CPU detect);
* an entry point with no device and no card raises.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from headpose_tpu.pretrained import PRETRAINED_DIR as JAX_PRETRAINED_DIR
from headpose_tpu.pretrained import load_pretrained as jax_load_pretrained
from headpose_tpu_torch.models import (BLAZEFACE_BACK, BlazeFaceNet, MLPHead,
                                       MLPHeadNet, UnifiedPoseNet)
from headpose_tpu_torch.pretrained import load_pretrained
from headpose_tpu_torch.tools.convert import (flatten_params, load_npz,
                                              params_from_jax, params_to_jax,
                                              save_npz, spec_from_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "headpose_tpu_torch")


@pytest.mark.parametrize("name,leaves,count", [
    ("unified-stoqa9pt-hrchr82r", 84, 110964),
    ("unified-best-distilled", 86, 215572),
    ("unified-best", 786, 979619),
    ("unified-back-distilled", 88, 111804)])
@pytest.mark.filterwarnings("ignore:'unified-back-distilled' is a synthetic")
def test_npz_is_bitwise_the_orbax_checkpoint(name, leaves, count):
    jspec, jparams = jax_load_pretrained(name)
    want = flatten_params(jax.tree.map(np.asarray, jparams))
    spec, params = load_pretrained(name)
    got = flatten_params(params)
    assert sorted(got) == sorted(want)
    assert len(got) == leaves
    assert sum(v.size for v in got.values()) == count
    for k, v in want.items():
        assert got[k].dtype == v.dtype == np.float32, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)


@pytest.mark.parametrize("name", ["unified-stoqa9pt-hrchr82r",
                                  "unified-best-distilled", "unified-best",
                                  "unified-back-distilled"])
def test_pretrained_quality_matches_jax(name):
    """pretrained_quality reads the tier the JAX package reads, and
    load_pretrained warns exactly on the synthetic bring-up artifact (as the
    JAX load_pretrained does, headpose_tpu/pretrained.py:116-123)."""
    import warnings

    from headpose_tpu.pretrained import pretrained_quality as jax_quality
    from headpose_tpu_torch.pretrained import pretrained_quality

    assert pretrained_quality(name) == jax_quality(name)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        load_pretrained(name)
    ours = [w for w in caught if issubclass(w.category, UserWarning)
            and "synthetic-imagery bring-up" in str(w.message)]
    assert len(ours) == (name == "unified-back-distilled")
    with pytest.raises(FileNotFoundError):
        pretrained_quality("no-such-model")


def test_bridge_round_trips(tmp_path):
    """params_from_jax → params_to_jax gives back every leaf bit for bit,
    the state_dict loads strictly, and save_npz / load_npz round-trip."""
    spec, params = load_pretrained("unified-stoqa9pt-hrchr82r")
    sd = params_from_jax(spec, params)
    assert sd["backbone.stem.weight"].shape == (24, 3, 5, 5)          # OIHW
    assert sd["backbone.blocks.3.dw.weight"].shape == (32, 1, 3, 3)   # depthwise
    assert sd["head88.layers.0.weight"].shape == (64, 88)             # (out, in)
    net = UnifiedPoseNet(spec, device="cpu")
    net.load_state_dict(sd)                                          # strict
    back = flatten_params(params_to_jax(spec, net.state_dict()))
    want = flatten_params(params)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    save_npz(str(tmp_path / "p.npz"), params)
    again = flatten_params(load_npz(str(tmp_path / "p.npz")))
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)


@pytest.mark.parametrize("spec,net", [
    (BLAZEFACE_BACK, BlazeFaceNet),
    (MLPHead(96, ((32, "tanh"), (3, "linear"))), MLPHeadNet)])
def test_bridge_round_trips_back_spec_and_lone_head(spec, net):
    module = net(spec, device="cpu")
    tree = params_to_jax(spec, module.state_dict())
    again = net(spec, device="cpu")
    again.load_state_dict(params_from_jax(spec, tree))      # strict
    for k, v in module.state_dict().items():
        assert torch.equal(again.state_dict()[k], v), k


def test_unported_head_types_raise():
    """spec_from_dict raises on a spec type the port does not know, here
    unified-best's spec with one ensemble member renamed."""
    with open(os.path.join(JAX_PRETRAINED_DIR, "unified-best",
                           "spec.json")) as f:
        doc = json.load(f)
    spec_from_dict(doc["spec"])                     # every family is ported
    member = doc["spec"]["fields"]["head88"]["fields"]["members"][
        "__tuple__"][0]
    member["__spec__"] = "ConvLSTMHead"
    with pytest.raises(NotImplementedError, match="ConvLSTMHead"):
        spec_from_dict(doc["spec"])


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_ast_scan_finds_no_jax_or_headpose_tpu_import():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 15
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "headpose_tpu"), \
                f"{os.path.relpath(path, REPO)} imports {mod}"


_BLOCKED_SCRIPT = """\
import sys

sys.path.insert(0, {repo!r})


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "headpose_tpu"):
            raise ImportError(f"{{name}} blocked")
        return None


sys.meta_path.insert(0, _Block())

import numpy as np

import headpose_tpu_torch
from headpose_tpu_torch.pretrained import flagship_detector

img = np.load({golden!r})["img"]
res = flagship_detector(device="cpu").detect_single(img)
assert len(res) > 0
fast = flagship_detector(device="cpu", precision="fast").detect_single(img)
assert len(fast) == len(res)
for mode in ("turbo", "max"):
    assert len(flagship_detector(device="cpu",
                                 precision=mode).detect_single(img)) == len(res)
import headpose_tpu_torch.tools.certify_modes
from headpose_tpu_torch.pretrained import load_pretrained
from headpose_tpu_torch.runtime.detector import FaceDetector

spec, params = load_pretrained("unified-best")
ub = FaceDetector(spec, params, device="cpu")
assert ub.head_eval == "survivors"
assert len(ub.detect_single(img)) == len(res)
from headpose_tpu_torch.runtime import PoseClient, PoseServer
from headpose_tpu_torch.runtime.offline import process_frames

det = flagship_detector(device="cpu")
with PoseServer(det, port=0) as srv, \
        PoseClient(srv.url, timeout=120) as client:
    served = client.detect(img)
assert len(served) == len(res)
assert abs(served.poses - res.poses).max() < 1e-4
assert process_frames(det, img[None], batch_size=1).valid.sum() == len(res)
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "headpose_tpu")]
assert not leaked, leaked
print("OK", len(res))
"""


def test_detect_with_jax_and_headpose_tpu_blocked():
    script = _BLOCKED_SCRIPT.format(
        repo=REPO, golden=os.path.join(REPO, "tests", "golden",
                                       "e2e_production.npz"))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_entry_points_without_a_card_raise(monkeypatch):
    """device=None means the card; with none present the entry points raise
    instead of carrying on on the CPU."""
    from headpose_tpu_torch.pretrained import best_detector, flagship_detector
    from headpose_tpu_torch.runtime.http import _build_detector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for factory in (flagship_detector, best_detector,
                    lambda: _build_detector(None),
                    lambda: _build_detector("unified-best-distilled")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory()
