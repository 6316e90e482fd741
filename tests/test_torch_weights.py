"""The port's committed weights and its independence from JAX.

* params.npz of each shipped model is bitwise the JAX package's Orbax
  checkpoint of the same name;
* the weight bridge round-trips;
* headpose_tpu_torch imports neither jax nor headpose_tpu (an AST scan, and
  a subprocess in which both, and h5py, are import-blocked runs a CPU
  detect, and the H5 loaders and the graph compiler from the flagship
  fixture's h5py-free twin; only reading an .h5 file needs h5py);
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
from headpose_tpu_torch.pretrained import HEADS, load_pretrained
from headpose_tpu_torch.tools.convert import (flatten_params, load_npz,
                                              params_from_jax, params_to_jax,
                                              save_npz, spec_from_dict)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "headpose_tpu_torch")


@pytest.mark.parametrize("name,leaves,count", [
    ("unified-stoqa9pt-hrchr82r", 84, 110964),
    ("unified-best-distilled", 86, 215572),
    ("unified-best", 786, 979619),
    ("unified-back-distilled", 88, 111804),
    ("stoqa9pt-88", 4, 5891), ("hrchr82r-96", 6, 3683),
    ("sweep88-best", 4, 11779), ("sweep96-best", 4, 3203),
    ("distill96", 6, 58115), ("stack88-distilled", 6, 56067),
    ("stack96-distilled", 6, 58115), ("ensemble88", 12, 29449),
    ("ensemble88-mixed", 8, 17670), ("ensemble88-stacked", 232, 258380),
    ("ensemble88-stacked-mixed", 236, 264271), ("ensemble96", 30, 16365),
    ("ensemble96-stacked", 464, 552160),
    ("ensemble96-stacked-mixed", 476, 613958)])
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
                                  "unified-back-distilled", *HEADS])
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
    for new in ("tools/aot.py", "tools/h5export.py", "tools/tflite.py",
                "runtime/edge.py", "ops/kernels/library.py"):
        assert os.path.join(PORT, new) in files, new
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
        if name.split(".")[0] in ("jax", "jaxlib", "headpose_tpu", "h5py"):
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
from headpose_tpu_torch.pretrained import HEADS, load_pretrained
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
import headpose_tpu_torch.tools.backfill
import headpose_tpu_torch.tools.train_cli
from headpose_tpu_torch.data import Dataset
from headpose_tpu_torch.tools.evaluate import evaluate_head_pose_model
from headpose_tpu_torch.tools.extract_features import FeatureExtractor
from headpose_tpu_torch.train import config_96, fit

feats = FeatureExtractor(device="cpu").extract(img)
assert feats.found[0]
head, head_params = load_pretrained("hrchr82r-96")
ds = Dataset(np.repeat(feats.features96, 16, 0),
             np.zeros((16, 3), np.float32))
assert evaluate_head_pose_model(head, ds, params=head_params, verbose=False,
                                device="cpu")["MAE"]["average"] > 0
trained = fit(config_96(total_epochs=1, batch_size=8,
                        checkpoint_dir={ckpt!r}), ds, device="cpu")
assert len(trained.history) == 1
import json

import headpose_tpu_torch.compat
import headpose_tpu_torch.core.graph
from headpose_tpu_torch.core.h5io import _model_from_parts
from headpose_tpu_torch.runtime.detector import FaceDetector as Detector

with open({twin!r} + "_config.json") as f:
    config = json.load(f)
with np.load({twin!r} + "_weights.npz") as w:
    md = _model_from_parts(config, dict(w))
h5 = Detector.from_h5(md, device="cpu").detect_single(img)
assert len(h5) == len(res) and abs(h5.poses - res.poses).max() == 0
compat = Detector.from_h5_compat(md, device="cpu").detect_single(img)
assert len(compat) == len(res)
try:
    Detector.from_h5({twin!r} + ".h5", device="cpu")
    raise AssertionError("read an H5 file with h5py blocked")
except ImportError:
    pass
import headpose_tpu_torch.train.calibrate
from headpose_tpu_torch.models import BlazeFace
from headpose_tpu_torch.train.detector import DetectorFitConfig, fit_detector

tiny = BlazeFace(input_size=32, stem_features=4, block_channels=(8, 8, 12),
                 downsample_blocks=(0, 2), tap88_block=1)
frames = np.random.default_rng(0).integers(0, 256, (8, 32, 32, 3),
                                           dtype=np.uint8)
boxes = np.tile(np.float32([[[0.2, 0.2, 0.6, 0.6]]]), (8, 1, 1))
_, hist = fit_detector(tiny, frames, boxes, np.ones((8, 1), np.float32),
                       DetectorFitConfig(steps=2, batch_size=4),
                       device="cpu")
assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
import tempfile

import torch

from headpose_tpu_torch.ops import resize_bicubic_np
from headpose_tpu_torch.ops.image import preprocess
from headpose_tpu_torch.runtime.edge import NativePostprocess
from headpose_tpu_torch.tools.aot import export_detector, load_exported
from headpose_tpu_torch.tools.h5export import save_unified_h5
from headpose_tpu_torch.tools.tflite import TFLiteModel

with tempfile.TemporaryDirectory() as d:
    export_detector(det, d, batch_sizes=(1,), image_shape=img.shape[:2])
    assert torch.equal(load_exported(d).detect(img).slab,
                       det.detect(img).slab)
    try:
        save_unified_h5(det.model, load_pretrained("unified-stoqa9pt-"
                                                   "hrchr82r")[1],
                        d + "/x.h5")
        raise AssertionError("wrote an H5 file with h5py blocked")
    except ImportError:
        pass
with torch.no_grad():
    out = det.net(preprocess(torch.from_numpy(img[None])))
edge = NativePostprocess(det.anchors.numpy())(
    out["scores"].numpy(), out["loc"].numpy(), out["pose_front"].numpy(),
    out["pose_back"].numpy())
assert len(edge[0]) == len(res) and (edge[0].poses == res.poses).all()
assert resize_bicubic_np(img.astype(np.float32), (128, 128)).shape == (
    128, 128, 3)
leaked = [m for m in sys.modules
          if m.split(".")[0] in ("jax", "jaxlib", "headpose_tpu", "h5py")]
assert not leaked, leaked
print("OK", len(res))
"""


def test_detect_with_jax_and_headpose_tpu_blocked(tmp_path):
    script = _BLOCKED_SCRIPT.format(
        repo=REPO, golden=os.path.join(REPO, "tests", "golden",
                                       "e2e_production.npz"),
        ckpt=str(tmp_path),
        twin=os.path.join(REPO, "tests", "golden_torch", "flagship_joined"))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith("OK")


def test_entry_points_without_a_card_raise(monkeypatch):
    """device=None means the card; with none present the entry points raise
    instead of carrying on on the CPU."""
    from headpose_tpu_torch.data import Dataset
    from headpose_tpu_torch.pretrained import best_detector, flagship_detector
    from headpose_tpu_torch.runtime.http import _build_detector
    from headpose_tpu_torch.tools import backfill, train_cli
    from headpose_tpu_torch.tools.evaluate import evaluate_head_pose_model
    from headpose_tpu_torch.tools.extract_features import (FeatureExtractor,
                                                           extract_dataset)
    from headpose_tpu_torch.train import config_96, evaluate, fit
    from headpose_tpu_torch.models import BLAZEFACE_FRONT
    from headpose_tpu_torch.pretrained import FLAGSHIP
    from headpose_tpu_torch.train import calibrate, detector

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    head, head_params = load_pretrained("hrchr82r-96")
    ds = Dataset(np.zeros((8, 96), np.float32), np.zeros((8, 3), np.float32))
    frames = np.zeros((2, 128, 128, 3), np.uint8)
    front = BLAZEFACE_FRONT
    front_params = front.init(torch.Generator().manual_seed(0))
    boxes = np.float32([[[0.2, 0.2, 0.6, 0.6]]] * 2)
    for factory in (flagship_detector, best_detector,
                    lambda: _build_detector(None),
                    lambda: _build_detector("unified-best-distilled"),
                    FeatureExtractor,
                    lambda: extract_dataset(frames, np.zeros((2, 3))),
                    lambda: fit(config_96(total_epochs=1), ds),
                    lambda: evaluate(head, head_params, ds),
                    lambda: evaluate_head_pose_model(head, ds,
                                                     params=head_params),
                    lambda: backfill.backfill_runs(".", "missing.npz"),
                    lambda: train_cli.main([]),
                    lambda: detector.fit_detector(
                        front, frames, boxes, np.ones((2, 1), np.float32)),
                    lambda: detector.distill_targets(front, front_params,
                                                     frames),
                    lambda: detector.distill_detector(front, front,
                                                      front_params, frames),
                    lambda: detector.distill_prefix(front, 0, front, 0,
                                                    front_params, frames),
                    lambda: calibrate.synthesize_images(
                        torch.Generator(), 2),
                    lambda: calibrate.calibrate_fast_params(
                        *load_pretrained(FLAGSHIP), steps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            factory()
