"""The port's BatchResults.trim() on the CPU: one batch-wide gather of the
valid rows, then per-image slices.  Held to the per-image boolean-mask split
it replaced (kept here as the oracle) and to the JAX package's trim() on the
same slab, bit for bit; every array its own C-contiguous, writeable float32
memory; from_ragged its inverse.  Each case runs on both of trim()'s paths:
the synchronous copy, and a download started beforehand
(`start_download`), whose buffer the results must not keep; each path's
trims are counted."""
import itertools

import numpy as np
import pytest
import torch

from headpose_tpu.runtime.results import BatchResults as JaxBatchResults
from headpose_tpu_torch.ops.detection import (C_LOGIT, C_POSE, C_VALID,
                                              KEYPOINTS, MAX_FACES, SLAB)
from headpose_tpu_torch.runtime.results import BatchResults, Results
from headpose_tpu_torch.utils.profiling import TOTALS

FIELDS = ("boxes", "keypoints", "scores", "poses")
F = MAX_FACES


def _valid(pattern: str, B: int, rng) -> np.ndarray:
    """(B, F) bool: which rows hold a face."""
    rows = np.arange(F)[None]
    if pattern == "none":
        return np.zeros((B, F), bool)
    if pattern == "one":
        return np.broadcast_to(rows < 1, (B, F)).copy()
    if pattern == "full":
        return np.ones((B, F), bool)
    if pattern == "prefix":      # counts 0, 1, F, then 0-4 a frame
        counts = np.concatenate([[0, 1, F], rng.integers(0, 5, B)])[:B]
        return rows < counts[:, None]
    # "scattered": rows anywhere, each image its own density, 0 and F among
    density = np.concatenate([[0.0, 1.0], rng.uniform(0, 0.3, B)])[:B]
    return rng.uniform(size=(B, F)) < density[:, None]


def _slab(B: int, pattern: str, seed: int) -> np.ndarray:
    """A (B, F, 21) float32 slab whose invalid rows hold junk too, with
    valid-column values at and below the 0.5 threshold."""
    rng = np.random.default_rng(seed)
    valid = _valid(pattern, B, rng)
    slab = rng.standard_normal((B, F, SLAB)).astype(np.float32)
    slab[..., C_VALID] = np.where(
        valid, 1.0, rng.choice(np.float32([0.0, 0.25, 0.5, -1.0]), (B, F)))
    return slab


def _mask_split(host: np.ndarray) -> list[Results]:
    """The per-image boolean-mask split that trim() did before the
    batch-wide gather."""
    B, F = host.shape[:2]
    keypoints = host[..., 4:C_POSE].reshape(B, F, KEYPOINTS, 2)
    valid = host[..., C_VALID] > 0.5
    return [Results(boxes=host[b, valid[b], :4],
                    keypoints=keypoints[b][valid[b]],
                    scores=host[b, valid[b], C_LOGIT],
                    poses=host[b, valid[b], C_POSE:C_LOGIT])
            for b in range(B)]


def _jax_trim(host: np.ndarray) -> list:
    """The JAX package's trim() on the slab's five fields, split in NumPy."""
    B, F = host.shape[:2]
    return JaxBatchResults(
        boxes=host[..., :4],
        keypoints=host[..., 4:C_POSE].reshape(B, F, KEYPOINTS, 2),
        scores=host[..., C_LOGIT], poses=host[..., C_POSE:C_LOGIT],
        valid=host[..., C_VALID] > 0.5).trim()


CASES = [(1, "none"), (1, "one"), (1, "full"), (1, "scattered"),
         (7, "prefix"), (7, "scattered"), (256, "prefix"), (256, "scattered")]


PATHS = ("copy", "download")


def _batch(B: int, pattern: str, path: str) -> tuple:
    """(slab, its BatchResults), the download started on that path."""
    slab = _slab(B, pattern, seed=1000 * B + CASES.index((B, pattern)))
    br = BatchResults(torch.from_numpy(slab))
    if path == "download":
        br.start_download()
    return slab, br


@pytest.fixture(params=[(c, p) for p in PATHS for c in CASES],
                ids=[f"b{b}-{pat}" + ("" if p == "copy" else f"-{p}")
                     for p in PATHS for b, pat in CASES])
def case(request):
    """(slab, trim() of it): the slab stays referenced, so the test can
    check that no result is a view of it."""
    (B, pattern), path = request.param
    slab, br = _batch(B, pattern, path)
    return slab, br.trim()


def _assert_bitwise(got: list, want: list):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        for k in FIELDS:
            a, e = getattr(g, k), getattr(w, k)
            assert a.shape == e.shape and a.dtype == e.dtype, (b, k)
            assert a.flags.c_contiguous == e.flags.c_contiguous, (b, k)
            assert a.tobytes() == e.tobytes(), (b, k)


def test_trim_matches_mask_split(case):
    slab, got = case
    _assert_bitwise(got, _mask_split(slab))


def test_trim_matches_jax_trim(case):
    slab, got = case
    _assert_bitwise(got, _jax_trim(slab))


def test_trim_arrays_are_contiguous_writeable_float32_copies(case):
    slab, got = case
    counts = (slab[..., C_VALID] > 0.5).sum(axis=1)
    for r, n in zip(got, counts):
        assert len(r) == n
        shapes = {"boxes": (n, 4), "keypoints": (n, KEYPOINTS, 2),
                  "scores": (n,), "poses": (n, 3)}
        for k in FIELDS:
            a = getattr(r, k)
            assert a.shape == shapes[k] and a.dtype == np.float32, k
            assert a.flags.c_contiguous and a.flags.writeable, k
            assert not np.shares_memory(a, slab), k


def test_trim_images_share_no_memory(case):
    _, got = case
    arrays = [(b, getattr(r, k)) for b, r in enumerate(got) for k in FIELDS]
    arrays = [(b, a) for b, a in arrays if a.size]
    for (b0, a0), (b1, a1) in itertools.combinations(arrays, 2):
        if b0 != b1:
            assert not np.shares_memory(a0, a1), (b0, b1)


def test_from_ragged_inverts_trim(case):
    slab, got = case
    valid = slab[..., C_VALID] > 0.5
    back = BatchResults.from_ragged(got).slab.numpy()
    assert back.shape == slab.shape
    np.testing.assert_array_equal(back[..., C_VALID] > 0.5, np.sort(
        valid, axis=1)[:, ::-1])
    assert back[back[..., C_VALID] > 0.5].tobytes() == slab[valid].tobytes()


@pytest.mark.parametrize("B,pattern", CASES,
                         ids=[f"b{b}-{p}" for b, p in CASES])
def test_trim_results_keep_nothing_of_the_download(B, pattern):
    """The download's buffer goes back to the allocator for a later batch:
    overwriting it after trim() changes no result."""
    slab, br = _batch(B, pattern, "download")
    got = br.trim()
    br._download[0].fill_(float("nan"))
    _assert_bitwise(got, _mask_split(slab))


def test_trim_counts_each_path():
    """One synchronous trim counts one `trim.copied`, one trim of a
    started download one `trim.downloaded`."""
    def counts():
        return (TOTALS.counts["trim.copied"], TOTALS.counts["trim.downloaded"])

    before = counts()
    _batch(7, "prefix", "copy")[1].trim()
    assert counts() == (before[0] + 1, before[1])
    _batch(7, "prefix", "download")[1].trim()
    assert counts() == (before[0] + 1, before[1] + 1)
