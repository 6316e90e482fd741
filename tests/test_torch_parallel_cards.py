"""The port's multi-device paths over several cards: one NCCL rank a card.

On the CPU: `parallel.dryrun.failed_checks` refusing NCCL ranks that share
a device (fed rank reports), and `chip_smoke.py`'s plan of the parallel
phase's runs, a pure function of the device count, with the TP meshes the
dryrun takes when none is asked for.  On the card (marked `gpu`): the
`detect` part over `torch.cuda.device_count()` NCCL ranks, which skips
inside the test where the machine has fewer than 2 cards.

The file imports neither jax nor headpose_tpu, so it runs where the port
runs: `python -m pytest tests/test_torch_parallel_cards.py --noconftest`.
"""
import importlib.util
import os

import pytest
import torch

from headpose_tpu_torch.parallel import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def chip_smoke():
    """The repository's chip_smoke.py as a module (nothing runs at
    import)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def report(rank, backend="nccl", cuda_device=None, checks=None):
    """A rank's report as the dryrun writes it, the fields read here."""
    device = rank if cuda_device is None else cuda_device
    return {"rank": rank, "backend": backend, "cuda_device": device,
            "device": f"cuda:{device}",
            "checks": checks or {"detect[flagship]": True},
            "host_staged": []}


# ------------------------------------------------------------ failed_checks
@pytest.mark.parametrize("ranks,want", [
    pytest.param([report(r) for r in range(4)], [], id="four_cards"),
    pytest.param([report(0), report(1, cuda_device=0), report(2),
                  report(3)], ["ranks [0, 1]: one device cuda:0"],
                 id="two_nccl_ranks_one_card"),
    pytest.param([report(0, "gloo", 0), report(1, "gloo", 0)], [],
                 id="gloo_ranks_share_a_card"),
    pytest.param([report(0), report(1, checks={"fit[dp]": False})],
                 ["rank 1: fit[dp]"], id="a_check_missed")])
def test_failed_checks(ranks, want):
    """Every missed check by rank, and one miss for each card that more
    than one NCCL rank reports as its own (gloo ranks may share one)."""
    assert dryrun.failed_checks(ranks) == want


# ---------------------------------------------------- the phase's plan
@pytest.mark.parametrize("n_cards,nccl", [
    (1, dict(nproc=1, backend="nccl", batch=128, parts=("detect", "fit"))),
    (2, dict(nproc=2, backend="nccl", batch=256, parts=dryrun.PARTS)),
    (3, dict(nproc=3, backend="nccl", batch=384, parts=dryrun.PARTS)),
    (4, dict(nproc=4, backend="nccl", batch=512, parts=dryrun.PARTS))])
def test_parallel_plan(n_cards, nccl):
    """One NCCL rank on every card (on one card detect and fit, as before;
    on N >= 2 every part at 128 rows a rank, TP on `train_meshes(N)`),
    then the gloo pair sharing cuda:0, as it was."""
    plan = chip_smoke().parallel_plan(n_cards)
    assert plan == {
        f"nccl_{n_cards}x1": nccl,
        "gloo_2_ranks": dict(nproc=2, backend="gloo", same_device=True,
                             model_parallel=2, parts=dryrun.PARTS,
                             batch=128)}


@pytest.mark.parametrize("n,meshes", [(1, (1,)), (2, (1, 2)), (3, (1, 3)),
                                      (4, (2, 4)), (8, (2, 8))])
def test_train_meshes(n, meshes):
    """The train part's 'model' axis sizes when --model-parallel is unset:
    JAX's dryrun's choice (2 where N is even and >= 4, else 1), then N, so
    (2, 2) and (1, 4) on four ranks."""
    assert dryrun.train_meshes(n) == meshes


# ------------------------------------------------------------ on the cards
@pytest.mark.gpu
def test_detect_over_every_card(tmp_path):
    """The detect part over one NCCL rank a card, 128 corpus frames a rank:
    every rank's checks held (each path against the unsharded detector of
    the whole batch, launches equal), rank r on cuda:r, nothing
    host-staged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 or more cards, the machine has {n}")
    results = dryrun.launch(n, str(tmp_path), backend="nccl",
                            parts=("detect",), frames="corpus",
                            batch=128 * n, timeout=600)
    assert dryrun.failed_checks(results) == []
    assert [r["cuda_device"] for r in results] == list(range(n))
    assert all(r["backend"] == "nccl" and not r["host_staged"]
               for r in results)
    assert all(r["detect"]["flagship"]["detections"] > 0 for r in results)
