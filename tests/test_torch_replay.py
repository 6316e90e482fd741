"""`detect`'s CUDA-graph replay (headpose_tpu_torch/runtime/replay.py) on
the CPU: a CPU detector never captures and never replays; the graph's key
changes when any one of its fields changes, and its fields are every
detector attribute `_pipeline` reads; a key's first call, and the first
call after a weight change, run eager, from many threads at once too; the
cache keeps at most `GRAPHS` keys; a replay's launches add to
`library.launches()`; a capture keeps the cached device constants it looked
up.  The capture and the replay themselves run on the card
(tests/test_torch_gpu.py, marked `gpu`)."""
import ast
import inspect
import os
import sys
import textwrap
import threading
import types

import numpy as np
import pytest
import torch

from headpose_tpu_torch.ops.kernels import library
from headpose_tpu_torch.ops import image
from headpose_tpu_torch.pretrained import flagship_detector
from headpose_tpu_torch.runtime import replay
from headpose_tpu_torch.runtime.detector import FaceDetector
from headpose_tpu_torch.utils import constants
from headpose_tpu_torch.utils.profiling import TOTALS

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
COUNTS = ("detect.eager", "detect.capture", "detect.capture_failed",
          "detect.replay")


def _counts() -> dict:
    return {k: TOTALS.counts[k] for k in COUNTS}


def _delta(before: dict) -> dict:
    return {k: TOTALS.counts[k] - n for k, n in before.items()}


def test_cpu_detect_never_captures():
    """Three detects at one shape on a CPU detector: each is eager, none
    captures or replays, and each gives the first one's slab."""
    det = flagship_detector(device="cpu")
    imgs = np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"][:2]
    before = _counts()
    slabs = [det.detect(imgs).slab for _ in range(3)]
    assert _delta(before) == {"detect.eager": 3, "detect.capture": 0,
                              "detect.capture_failed": 0, "detect.replay": 0}
    for slab in slabs[1:]:
        assert torch.equal(slab, slabs[0])


_MODEL, _NET, _ANCHORS = object(), torch.nn.Identity(), torch.zeros(4)


def _options(**changed):
    fields = dict(precision="fast", head_eval="map", channel_order="bgr",
                  turbo_island=None, score_threshold=0.4, iou_threshold=0.3,
                  max_faces=100, postprocess="auto", input_size=128,
                  model=_MODEL, net=_NET, anchors=_ANCHORS)
    assert set(fields) == set(replay.OPTIONS)
    fields.update(changed)
    return types.SimpleNamespace(**fields)


_X = torch.zeros((4, 128, 128, 3), dtype=torch.uint8)
_CHANGES = {
    "shape": lambda: replay.graph_key(_options(), _X[:2], None),
    "dtype": lambda: replay.graph_key(_options(), _X.float(), None),
    "device": lambda: replay.graph_key(_options(), _X.to("meta"), None),
    "fused": lambda: replay.graph_key(_options(), _X, True),
    "precision": lambda: replay.graph_key(_options(precision="turbo"), _X,
                                          None),
    "head_eval": lambda: replay.graph_key(_options(head_eval="survivors"),
                                          _X, None),
    "channel_order": lambda: replay.graph_key(_options(channel_order="rgb"),
                                              _X, None),
    "turbo_island": lambda: replay.graph_key(_options(turbo_island=(14, 15)),
                                             _X, None),
    "score_threshold": lambda: replay.graph_key(
        _options(score_threshold=0.5), _X, None),
    "iou_threshold": lambda: replay.graph_key(_options(iou_threshold=0.25),
                                              _X, None),
    "max_faces": lambda: replay.graph_key(_options(max_faces=32), _X, None),
    "postprocess": lambda: replay.graph_key(_options(postprocess="xla"), _X,
                                            None),
    "input_size": lambda: replay.graph_key(_options(input_size=256), _X,
                                           None),
    "model": lambda: replay.graph_key(_options(model=object()), _X, None),
    "net": lambda: replay.graph_key(_options(net=torch.nn.Identity()), _X,
                                    None),
    "anchors": lambda: replay.graph_key(_options(anchors=_ANCHORS.clone()),
                                        _X, None),
}


@pytest.mark.parametrize("field", sorted(_CHANGES) + ["matmul_tf32",
                                                      "cudnn_tf32"])
def test_graph_key_changes_with_each_field(field, monkeypatch):
    """The key of the same call is equal to itself and hashable; changing
    any one field (the input's shape, dtype or device, `fused`, an
    attribute `_pipeline` reads, by value or, for the model, the network
    and the anchors, by identity; a TF32 switch) gives another key."""
    key = replay.graph_key(_options(), _X, None)
    assert key == replay.graph_key(_options(), _X.clone(), None)
    hash(key)
    if field == "matmul_tf32":
        monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32",
                            not torch.backends.cuda.matmul.allow_tf32)
        other = replay.graph_key(_options(), _X, None)
    elif field == "cudnn_tf32":
        monkeypatch.setattr(torch.backends.cudnn, "allow_tf32",
                            not torch.backends.cudnn.allow_tf32)
        other = replay.graph_key(_options(), _X, None)
    else:
        other = _CHANGES[field]()
    assert other != key
    hash(other)


def test_first_calls_run_eager_and_the_cache_is_bounded():
    """A key's first call runs the pipeline eager (and a first call after a
    weight change too); GRAPHS + 3 keys keep the GRAPHS most recent."""
    graphs = replay.PipelineGraphs()
    x = torch.arange(6.0)
    calls = []

    def pipeline(t):
        calls.append(t)
        return t * 2

    before = _counts()
    for k in range(replay.GRAPHS + 3):
        assert torch.equal(graphs(pipeline, x, ("key", k), ("w", 0)), x * 2)
    assert len(calls) == replay.GRAPHS + 3
    assert list(graphs._graphs) == [("key", k) for k in
                                    range(3, replay.GRAPHS + 3)]
    last = ("key", replay.GRAPHS + 2)
    graphs(pipeline, x, last, ("w", 1))           # the weights changed
    assert graphs._graphs[last].weights == ("w", 1)
    assert graphs._graphs[last].graph is None
    assert _delta(before)["detect.eager"] == replay.GRAPHS + 4
    assert _delta(before)["detect.capture"] == 0


def test_first_calls_from_many_threads():
    """24 threads, 100 first calls each (the weights change every call)
    over 20 keys, with a short switch interval: every call returns its own
    batch's answer, each is counted eager once, and the cache stays within
    GRAPHS keys."""
    graphs = replay.PipelineGraphs()
    before = _counts()
    wrong = []

    def work(t):
        for i in range(100):
            x = torch.full((3,), float(t * 1000 + i))
            out = graphs(lambda v: v + 1, x, ("key", (t + i) % 20), (t, i))
            if not torch.equal(out, x + 1):
                wrong.append((t, i))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(24)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert wrong == []
    assert _delta(before)["detect.eager"] == 2400
    assert len(graphs._graphs) <= replay.GRAPHS


def test_add_launches_counts_a_replay():
    before = library.launches()
    library.add_launches({"postprocess": 1, "backbone2_segment": 8})
    after = library.launches()
    try:
        assert after["postprocess"] == before["postprocess"] + 1
        assert after["backbone2_segment"] == before["backbone2_segment"] + 8
        assert {k: v for k, v in after.items()
                if k not in ("postprocess", "backbone2_segment")} == {
            k: v for k, v in before.items()
            if k not in ("postprocess", "backbone2_segment")}
    finally:
        library.LAUNCHES.update(before)


def _self_reads(cls, name: str, seen: set) -> set:
    """The attributes of `self` that method `name` of `cls` reads, and the
    methods of `cls` it calls read, found in their source; `self` used in
    any other way (passed on whole, `getattr(self, ...)`) fails."""
    seen.add(name)
    tree = ast.parse(textwrap.dedent(inspect.getsource(getattr(cls, name))))
    reads, attrs = set(), set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            attrs.add(id(node.value))
            reads.add(node.attr)
    loose = [node.lineno for node in ast.walk(tree)
             if isinstance(node, ast.Name) and node.id == "self"
             and id(node) not in attrs
             and not isinstance(node.ctx, ast.Param)]
    args = tree.body[0].args.args
    assert args and args[0].arg == "self"
    assert loose == [], f"{name} uses self whole at lines {loose}"
    out = set()
    for attr in reads:
        if callable(getattr(cls, attr, None)):
            if attr not in seen:
                out |= _self_reads(cls, attr, seen)
        else:
            out.add(attr)
    return out


def test_the_key_names_every_attribute_the_pipeline_reads():
    """`replay.OPTIONS` is exactly the set of detector attributes that
    `_pipeline` reads, in its own body or in the detector's methods it
    calls: an attribute it reads and the key leaves out would replay a
    stale graph once changed."""
    assert _self_reads(FaceDetector, "_pipeline", set()) == set(
        replay.OPTIONS)


def test_a_capture_keeps_the_device_constants_it_looked_up():
    """A cached device constant looked up inside `kept()` is kept by the
    list, on this thread alone, after its cache has evicted it; the
    resize matrices are such constants."""
    built = []

    @constants.device_constant(maxsize=2)
    def const(n):
        built.append(torch.full((3,), float(n)))
        return built[-1]

    seen = []
    with constants.kept() as keep:
        first = const(0)
        worker = threading.Thread(target=lambda: seen.append(const(7)))
        worker.start()
        worker.join()
    for n in range(1, 5):                   # evicts 0 (and 7)
        const(n)
    assert const.cache_info().currsize == 2
    assert len(keep) == 1 and keep[0] is first
    assert const(0) is not first            # built again
    assert len(keep) == 1                   # the block has ended
    with constants.kept() as keep:
        rh = image._matrix_on(480, 128, torch.device("cpu"))
    assert len(keep) == 1 and keep[0] is rh
