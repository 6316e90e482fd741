"""The port's AOT serving artifacts (headpose_tpu_torch/tools/aot.py) on the
CPU: a FaceDetector's pipeline exported with torch.export and replayed
without model code, against the source detector (bit for bit at exported
widths, row for row when chunked) and against the JAX detector at the
tolerances of tests/test_torch_detector.py.  The port's counterpart of
tests/test_aot.py."""
import io
import json
import os
import re
import shutil
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from headpose_tpu_torch.pretrained import best_detector, flagship_detector
from headpose_tpu_torch.runtime.detector import FaceDetector
from headpose_tpu_torch.tools.aot import (ExportedDetector, export_detector,
                                          load_exported)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")
OP = "headpose_tpu_torch.postprocess.default"


def _frames(n, size=128, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


def _corpus(n):
    return np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:n]


@pytest.fixture(scope="module")
def detector():
    return flagship_detector(device="cpu", score_threshold=0.5)


@pytest.fixture(scope="module")
def artifact(detector, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("aot") / "flagship")
    meta = export_detector(detector, path, batch_sizes=(4, 2))
    return path, meta


def _assert_bitwise(got, want, what=""):
    for field in FIELDS:
        g, w = getattr(got, field), getattr(want, field)
        assert g.shape == w.shape, (what, field)
        assert torch.equal(g, w), f"{what}: {field}"


class TestExport:
    def test_artifact_layout(self, artifact):
        path, meta = artifact
        assert meta["batch_sizes"] == [2, 4]
        assert meta["platforms"] == ["cpu"] and meta["device"] == "cpu"
        assert meta["dtype"] == "uint8"
        assert meta["image_shape"] == [128, 128]
        assert meta["config"]["precision"] == "highest"
        assert meta["config"]["head_eval"] == "map"
        assert meta["config"]["score_threshold"] == 0.5
        assert meta["max_faces"] == 100
        assert meta["versions"]["torch"] == torch.__version__
        with open(os.path.join(path, "aot.json")) as f:
            assert json.load(f) == meta
        for entry in meta["programs"].values():
            assert os.path.getsize(os.path.join(path, entry["file"])) > 1000
            assert entry["postprocess"] == "xla"   # the CPU's plain chain
            assert entry["ops"] == ["postprocess"]

    def test_graph_holds_the_postprocess_op(self, artifact):
        """The program's kernel #1 is the op node the card runs; on the CPU
        its implementation is the plain chain."""
        aot = load_exported(artifact[0])
        targets = [str(n.target) for n in aot.program(2).graph.nodes
                   if n.op == "call_function"]
        assert targets.count(OP) == 1

    def test_exact_match_at_exported_width(self, detector, artifact):
        aot = load_exported(artifact[0])
        for b in (2, 4):
            frames = _corpus(b)
            want = detector.detect(frames)
            assert int(want.valid.sum()) >= b
            _assert_bitwise(aot.detect(frames), want, f"width {b}")

    @pytest.mark.parametrize("b", [1, 3, 7])
    def test_chunked_and_padded_batches(self, detector, artifact, b):
        """Widths not exported (1, 3, 7) serve through greedy chunking +
        tail padding, row for row the source detector."""
        aot = load_exported(artifact[0])
        frames = _frames(b, seed=b)
        frames[:min(b, 2)] = _corpus(min(b, 2))
        got = aot.detect(frames)
        assert got.boxes.shape[0] == b
        _assert_bitwise(got, detector.detect(frames), f"batch {b}")

    def test_chunk_plan_greedy(self, artifact):
        aot = load_exported(artifact[0])
        assert aot._chunks(1) == [2]
        assert aot._chunks(4) == [4]
        assert aot._chunks(5) == [4, 2]
        assert aot._chunks(11) == [4, 4, 4]

    def test_single_image_rank3(self, detector, artifact):
        aot = load_exported(artifact[0])
        frame = _corpus(1)[0]
        _assert_bitwise(aot.detect(frame), detector.detect(frame))

    def test_tensor_frames(self, detector, artifact):
        aot = load_exported(artifact[0])
        frames = torch.from_numpy(_corpus(2))
        _assert_bitwise(aot.detect(frames), detector.detect(frames))

    def test_replay_matches_jax_detector(self, artifact):
        """The replay against JAX's FaceDetector.detect on six corpus
        images (chunks 4 + 2) at tests/test_torch_detector.py's
        tolerances."""
        from headpose_tpu.pretrained import flagship_detector as jax_flagship

        imgs = _corpus(6)
        got = load_exported(artifact[0]).detect(imgs)
        want = jax_flagship(score_threshold=0.5).detect(imgs)
        want = {k: np.asarray(getattr(want, k)) for k in FIELDS}
        np.testing.assert_array_equal(got.valid.numpy(), want["valid"])
        assert want["valid"].sum() >= 6
        np.testing.assert_allclose(got.boxes.numpy(), want["boxes"],
                                   atol=1e-4)
        np.testing.assert_allclose(got.keypoints.numpy(), want["keypoints"],
                                   atol=1e-4)
        np.testing.assert_allclose(got.scores.numpy(), want["scores"],
                                   atol=1e-5)
        np.testing.assert_allclose(got.poses.numpy(), want["poses"],
                                   atol=2e-3)


def test_fast_precision_round_trips(tmp_path):
    """A "fast" detector (the split-bf16 backbone's plain version on the
    CPU) exports with its precision baked in and replays bit for bit."""
    det = flagship_detector(device="cpu", precision="fast")
    path = str(tmp_path / "fast")
    meta = export_detector(det, path, batch_sizes=(2,))
    assert meta["config"]["precision"] == "fast"
    frames = _corpus(2)
    _assert_bitwise(load_exported(path).detect(frames), det.detect(frames))


class TestSurvivorsExport:
    def test_ensemble_survivors_profile_round_trips(self, detector,
                                                    tmp_path):
        """head_eval='survivors' (an ensemble with an SE-gated member,
        through the ensemble's vmap) is a baked config like every other:
        the replay is the source detector bit for bit, the map profile of
        the same weights differs, and JAX's detector on the same weights
        agrees at tests/test_torch_detector.py's tolerances."""
        import jax

        from headpose_tpu.models import heads as jheads
        from headpose_tpu.models.unified import UnifiedPoseModel as JModel
        from headpose_tpu.pretrained import load_flagship
        from headpose_tpu.runtime.detector import FaceDetector as JDetector
        from headpose_tpu_torch.models import heads as theads
        from headpose_tpu_torch.models.unified import UnifiedPoseModel

        jh88 = jheads.EnsembleHead(members=(
            jheads.SEMLPHead(in_features=88, reduction=8, hidden=16),
            jheads.MLPHead(in_features=88,
                           layers=((16, "softsign"), (3, "linear")))))
        jh96 = jheads.SEMLPHead(in_features=96, reduction=8, hidden=16)
        h88 = theads.EnsembleHead(members=(
            theads.SEMLPHead(in_features=88, reduction=8, hidden=16),
            theads.MLPHead(in_features=88,
                           layers=((16, "softsign"), (3, "linear")))))
        h96 = theads.SEMLPHead(in_features=96, reduction=8, hidden=16)
        jmodel, jparams = load_flagship()
        numpy_tree = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
        params = {"backbone": numpy_tree(jparams["backbone"]),
                  "head88": numpy_tree(jh88.init(jax.random.PRNGKey(0))),
                  "head96": numpy_tree(jh96.init(jax.random.PRNGKey(1)))}
        model = UnifiedPoseModel(backbone=detector.model.backbone,
                                 head88=h88, head96=h96)
        src = FaceDetector(model, params, score_threshold=0.5, device="cpu")
        assert src.head_eval == "survivors"   # 'auto': SE members present

        img = np.asarray(np.load(os.path.join(
            GOLDEN, "e2e_production.npz"))["img"], np.uint8)
        frames = np.stack([img, np.zeros_like(img)])
        path = str(tmp_path / "survivors")
        meta = export_detector(src, path, batch_sizes=(2,),
                               image_shape=img.shape[:2])
        assert meta["config"]["head_eval"] == "survivors"
        got = load_exported(path).detect(frames)
        want = src.detect(frames)
        valid = want.valid.numpy()
        assert int(valid.sum()) > 0
        _assert_bitwise(got, want)
        rmap = FaceDetector(model, params, score_threshold=0.5,
                            head_eval="map", device="cpu").detect(frames)
        dmax = (got.poses - rmap.poses).abs().numpy()[valid].max()
        assert dmax > 1e-3, f"expected map/survivors divergence, got {dmax}"

        jdet = JDetector(JModel(backbone=jmodel.backbone, head88=jh88,
                                head96=jh96),
                         {**jparams, "head88": params["head88"],
                          "head96": params["head96"]}, score_threshold=0.5)
        jwant = jdet.detect(frames)
        np.testing.assert_array_equal(valid, np.asarray(jwant.valid))
        np.testing.assert_allclose(got.boxes.numpy(),
                                   np.asarray(jwant.boxes), atol=1e-4)
        np.testing.assert_allclose(got.scores.numpy(),
                                   np.asarray(jwant.scores), atol=1e-5)
        np.testing.assert_allclose(got.poses.numpy(),
                                   np.asarray(jwant.poses), atol=2e-3)


def test_best_model_exports_and_serves_aot(tmp_path):
    """best_detector() ('unified-best-distilled', per-cell MLP heads: 'auto'
    resolves to 'map') rides the AOT path bit for bit."""
    det = best_detector(device="cpu", score_threshold=0.5)
    path = str(tmp_path / "best")
    meta = export_detector(det, path, batch_sizes=(2,))
    assert meta["config"]["head_eval"] == "map"
    frames = _corpus(2)
    _assert_bitwise(load_exported(path).detect(frames), det.detect(frames))


def test_cli_exports_a_registry_model(tmp_path, capsys):
    """`python -m headpose_tpu_torch.tools.aot` (main): a registry model
    and its options to an artifact that replays the same detector."""
    from headpose_tpu_torch.tools.aot import main

    out = str(tmp_path / "cli")
    main(["--model", "unified-best-distilled", "--out", out, "--batch", "2",
          "--device", "cpu", "--score-threshold", "0.5"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["batch_sizes"] == [2] and printed["platforms"] == ["cpu"]
    aot = load_exported(out)
    assert aot.meta["config"]["score_threshold"] == 0.5
    frames = _corpus(2)
    _assert_bitwise(aot.detect(frames), best_detector(
        device="cpu", score_threshold=0.5).detect(frames))


_LOADER_SCRIPT = """\
import sys

sys.path.insert(0, {repo!r})


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "headpose_tpu", "h5py"):
            raise ImportError(f"{{name}} blocked")
        return None


sys.meta_path.insert(0, _Block())

import numpy as np

import headpose_tpu_torch.tools.aot as aot

slab = aot.load_exported({path!r}).call(np.load({frames!r})).numpy()
np.save({out!r}, slab)
print(" ".join(sorted(m for m in sys.modules
                      if m.startswith("headpose_tpu_torch"))))
"""

# what a replay may load: the package roots, the loader, the op library
# and what it needs
ALLOWED = {"headpose_tpu_torch", "headpose_tpu_torch.tools",
           "headpose_tpu_torch.tools.aot", "headpose_tpu_torch.ops",
           "headpose_tpu_torch.ops.kernels",
           "headpose_tpu_torch.ops.kernels.library",
           "headpose_tpu_torch.ops.detection", "headpose_tpu_torch.runtime",
           "headpose_tpu_torch.runtime.results", "headpose_tpu_torch.utils",
           "headpose_tpu_torch.utils.build"}


def test_loader_imports_no_model_code(detector, artifact, tmp_path):
    """The deployment claim: in a process with jax, headpose_tpu and h5py
    blocked, importing tools.aot and replaying loads none of models, core,
    train, data, parallel, compat, pretrained, runtime.detector,
    runtime.fused or a kernel wrapper, and gives the source detector's
    slab bit for bit."""
    frames = _corpus(3)
    np.save(tmp_path / "frames.npy", frames)
    script = _LOADER_SCRIPT.format(repo=REPO, path=artifact[0],
                                   frames=str(tmp_path / "frames.npy"),
                                   out=str(tmp_path / "slab.npy"))
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(proc.stdout.split())
    assert loaded <= ALLOWED, sorted(loaded - ALLOWED)
    assert "headpose_tpu_torch.ops.kernels.library" in loaded
    np.testing.assert_array_equal(np.load(tmp_path / "slab.npy"),
                                  detector.detect(frames).slab.numpy())


class TestServing:
    def test_dynamic_batcher_over_exported(self, detector, artifact):
        from headpose_tpu_torch.runtime.server import DynamicBatcher

        aot = load_exported(artifact[0])
        frames = _frames(5, seed=42)
        frames[:3] = _corpus(3)
        want = detector.detect(frames).trim()
        with DynamicBatcher(aot, max_batch=4, max_delay=0.05) as srv:
            futs = [srv.submit(f) for f in frames]
            got = [f.result(timeout=120) for f in futs]
        assert srv.frames_served == 5
        assert srv.frame_shape == (128, 128, 3)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.poses, w.poses)
            np.testing.assert_array_equal(g.boxes, w.boxes)

    def test_pose_server_over_exported(self, detector, artifact):
        from headpose_tpu_torch.runtime import PoseServer

        aot = load_exported(artifact[0])
        frames = _corpus(3)
        want = detector.detect(frames).trim()
        with PoseServer(aot, port=0, max_batch=4, max_delay=0.05) as srv:
            for frame, w in zip(frames, want):
                buf = io.BytesIO()
                np.save(buf, frame)
                req = urllib.request.Request(f"{srv.url}/v1/detect",
                                             data=buf.getvalue(),
                                             method="POST")
                with urllib.request.urlopen(req, timeout=120) as resp:
                    got = json.load(resp)
                assert got["count"] == len(w) > 0
                for k, face in enumerate(got["faces"]):
                    np.testing.assert_allclose(face["pose"], w.poses[k],
                                               rtol=1e-5, atol=1e-5)

    def test_http_cli_builder_resolves_aot_artifacts(self, artifact):
        """--model accepts an artifact directory and refuses flags that
        would change its baked config."""
        from headpose_tpu_torch.runtime.http import _build_detector

        det = _build_detector(artifact[0], precision="highest",
                              head_eval="auto")
        assert isinstance(det, ExportedDetector)
        with pytest.raises(ValueError, match="baked in"):
            _build_detector(artifact[0], precision="turbo", head_eval="auto")
        with pytest.raises(ValueError, match="baked in"):
            _build_detector(artifact[0], precision="highest",
                            head_eval="survivors")


class TestValidation:
    def test_rejects_wrong_dtype(self, artifact):
        aot = load_exported(artifact[0])
        with pytest.raises(ValueError, match="uint8"):
            aot.detect(np.zeros((2, 128, 128, 3), np.float32))

    def test_rejects_wrong_resolution(self, artifact):
        aot = load_exported(artifact[0])
        with pytest.raises(ValueError, match="Re-export"):
            aot.detect(_frames(2, size=64))

    def test_mesh_detector_is_not_ported(self, detector):
        """A mesh detector never exists to export: the port's FaceDetector
        refuses it, citing ROADMAP.md §1, item 8."""
        with pytest.raises(NotImplementedError, match="item 8"):
            FaceDetector(detector.model, None, mesh=object(), device="cpu")

    def test_rejects_bad_batch_sizes(self, detector, tmp_path):
        with pytest.raises(ValueError, match="positive"):
            export_detector(detector, str(tmp_path / "x"), batch_sizes=(0,))

    def test_empty_batch_returns_empty_slabs(self, artifact):
        aot = load_exported(artifact[0])
        res = aot.detect(np.zeros((0, 128, 128, 3), np.uint8))
        assert res.boxes.shape == (0, aot.meta["max_faces"], 4)
        assert res.valid.shape[0] == 0 and res.trim() == []

    def test_rejects_bad_rank(self, artifact):
        aot = load_exported(artifact[0])
        with pytest.raises(ValueError, match=r"\(B, H, W, 3\)"):
            aot.detect(np.zeros((128, 128), np.uint8))

    def test_rejects_future_format(self, artifact, tmp_path):
        path = str(tmp_path / "fut")
        shutil.copytree(artifact[0], path)
        meta = json.load(open(os.path.join(path, "aot.json")))
        meta["format_version"] = 99
        json.dump(meta, open(os.path.join(path, "aot.json"), "w"))
        with pytest.raises(ValueError, match="format_version"):
            ExportedDetector(path)

    def test_records_and_pins_producer_versions(self, artifact, tmp_path):
        """The manifest records the producing torch, CUDA and export schema
        versions; another torch fails loudly naming both, and a payload
        that does not load names the producing versions."""
        path, meta = artifact
        ver = meta["versions"]
        assert ver["cuda"] == torch.version.cuda
        assert ver["export_schema"] is None or len(ver["export_schema"]) == 2
        skew = str(tmp_path / "skew")
        shutil.copytree(path, skew)
        m = json.load(open(os.path.join(skew, "aot.json")))
        m["versions"]["torch"] = "99.0.0"
        json.dump(m, open(os.path.join(skew, "aot.json"), "w"))
        here = re.escape(torch.__version__)
        with pytest.raises(ValueError, match=rf"99\.0\.0.*{here}"):
            ExportedDetector(skew)
        bad = str(tmp_path / "bad")
        shutil.copytree(path, bad)
        with open(os.path.join(bad, meta["programs"]["2"]["file"]),
                  "wb") as f:
            f.write(b"not an exported program")
        with pytest.raises(RuntimeError, match="exported by torch"):
            ExportedDetector(bad).detect(_frames(2))

    def test_card_artifact_refused_without_a_card(self, artifact, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        path = str(tmp_path / "card")
        shutil.copytree(artifact[0], path)
        m = json.load(open(os.path.join(path, "aot.json")))
        m["platforms"], m["device"] = ["cuda"], "cuda:0"
        json.dump(m, open(os.path.join(path, "aot.json"), "w"))
        with pytest.raises(ValueError, match="no CUDA device"):
            ExportedDetector(path)
