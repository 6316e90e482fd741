"""A run of the harness, on the CPU at a tiny size, with the timed path
broken underneath, must come out not correct; a sound run correct.  The
faults a serving cell can have: an answer altered where it is produced, an
answer given for another frame, and (the mesh) the exchange between chips
left out.  The control, the program at the single-pass bf16 precision its
configuration's "fast" replaces, fails too."""
import time

import pytest
import torch

from perfbench.harness import cells, check, control
from perfbench.runners import mesh, stream

SEED = 2**31 + 77


def _cell(workload="flagship.fast-b256-128px", **traffic):
    cell = cells.from_files(workload)
    cell.traffic.update(dict(batch=4, ring=2, warmup_batches=1,
                             check_batches=2), **traffic)
    return cell


def _correct(out, cell):
    return check.verdict(out["readings"], cell.limits["limits"])[0]


def _run(cell, **kw):
    return stream.run(cell, SEED, 0.3, False, time.perf_counter(),
                      device="cpu", **kw)


@pytest.fixture
def patched(monkeypatch):
    """Wrap the program's pipeline: `patched(f)` makes every slab f(slab)."""
    from headpose_tpu_torch.runtime.detector import FaceDetector

    orig = FaceDetector._pipeline

    def install(fault):
        monkeypatch.setattr(FaceDetector, "_pipeline",
                            lambda self, *a, **k: fault(orig(self, *a, **k)))
    return install


def test_sound_run_is_correct():
    cell = _cell()
    out = _run(cell)
    assert out["readings"]["pairs"] > 0
    assert _correct(out, cell)


@pytest.mark.parametrize("channel,delta", [(16, 1.0), (0, 0.01)])
def test_altered_answer(patched, channel, delta):
    """A pose angle moved by a degree, or a box edge by 1 % of the frame."""
    def fault(slab):
        slab[..., channel] += delta
        return slab

    patched(fault)
    cell = _cell()
    assert not _correct(_run(cell), cell)


def test_answer_for_another_frame(patched):
    patched(lambda slab: torch.roll(slab, 1, dims=0))
    cell = _cell()
    assert not _correct(_run(cell), cell)


def test_mesh_sound_and_without_its_exchange():
    cell = _cell("flagship.highest-mesh4-b512", sync_every=2)
    sound = mesh.run(cell, SEED, 0.5, False, time.perf_counter(),
                     device="cpu", ranks=2)
    assert _correct(sound, cell)
    broken = mesh.run(cell, SEED, 0.5, False, time.perf_counter(),
                      device="cpu", ranks=2,
                      hook="perfbench.tests.faults:no_exchange")
    assert broken["readings"]["missing_frames"] > 0
    assert not _correct(broken, cell)


@pytest.mark.parametrize("workload", ["flagship.fast-b256-128px",
                                      "back256.fast-b128-256px"])
def test_control_fails(workload):
    """The configuration's control precision in the program's place."""
    cell = _cell(workload, batch=16)
    out, = control.runs(cell, [(SEED, True)], 0.3, device="cpu")
    assert out["readings"]["pairs"] > 0
    assert not _correct(out, cell)
