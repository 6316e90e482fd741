"""The port's data layer (headpose_tpu_torch.data) against the JAX
package's on the CPU: the split indices, difficulty weights and canonical
splits exactly, and the native npz loader bit for bit against np.load."""
import os

import numpy as np
import pytest

from headpose_tpu.data import datasets as jdata
from headpose_tpu_torch.data import (Dataset, difficulty_weights,
                                     load_dataset, load_dataset_with_weights,
                                     standard_splits, train_val_split)
from headpose_tpu_torch.data import native

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def rows(n, c=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, c)).astype(np.float32),
            rng.uniform(-90, 90, size=(n, 3)).astype(np.float32))


@pytest.mark.parametrize("n,fraction,seed", [(321, 0.2, 42), (16384, 0.2, 42),
                                             (7, 0.5, 0), (100, 0.15, 3)])
def test_train_val_split_is_jaxs(n, fraction, seed):
    """The same rows in the same order as JAX's sklearn-matching split, with
    the weights carried along."""
    x, y = rows(n)
    w = difficulty_weights(y)
    tr, va = train_val_split(Dataset(x, y, w), fraction, seed)
    jtr, jva = jdata.train_val_split(jdata.Dataset(x, y, w), fraction, seed)
    for mine, want in ((tr, jtr), (va, jva)):
        np.testing.assert_array_equal(mine.features, want.features)
        np.testing.assert_array_equal(mine.poses, want.poses)
        np.testing.assert_array_equal(mine.weights, want.weights)


def test_difficulty_weights_are_jaxs():
    _, y = rows(4096, seed=1)
    y[:8] = [[0, 0, 0], [45, 0, 12], [65, 0, 0], [0, 70, 5], [90, 90, 0],
             [-120, 10, 0], [180, -180, 3], [60, 0, 0]]
    got = difficulty_weights(y)
    np.testing.assert_array_equal(got, jdata.difficulty_weights(y))
    assert got.dtype == np.float32 and got[0] == 1.0
    np.testing.assert_allclose(got[2], 0.5, rtol=1e-5)


def test_concat_keeps_weights():
    a = Dataset(np.zeros((3, 8), np.float32), np.zeros((3, 3), np.float32),
                np.full((3,), 0.5, np.float32))
    b = Dataset(np.ones((2, 8), np.float32), np.ones((2, 3), np.float32))
    np.testing.assert_array_equal(a.concat(b).weights,
                                  [0.5, 0.5, 0.5, 1.0, 1.0])
    assert b.concat(b).weights is None and len(a.concat(b)) == 5


def _archives(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {
        "features": rng.normal(size=(100, 96)).astype(np.float32),
        "poses": rng.normal(size=(100, 3)).astype(np.float32),
        "ints": rng.integers(0, 100, size=(7,)).astype(np.int64),
        "f64": rng.normal(size=(3, 4, 5)),
        "fortran": np.asfortranarray(np.arange(24, dtype=np.float32)
                                     .reshape(4, 6)),
        "scalar": np.float32(3.5),
        "empty": np.zeros((0, 88), np.float32),
    }
    paths = []
    for name, saver in (("c.npz", np.savez_compressed), ("u.npz", np.savez)):
        path = str(tmp_path / name)
        saver(path, **arrays)
        paths.append(path)
    return paths + [os.path.join(GOLDEN, "heads.npz"),
                    os.path.join(GOLDEN, "keras_train_traj.npz")]


def test_native_loader_builds_here():
    assert native.native_available(), native.LIBRARY.build_log


def test_native_loader_is_bitwise_np_load(tmp_path):
    for path in _archives(tmp_path):
        got = native.load_npz_native(path)
        with np.load(path) as want:
            assert sorted(got) == sorted(want.files), path
            for k in want.files:
                assert got[k].dtype == want[k].dtype, (path, k)
                assert got[k].shape == want[k].shape, (path, k)
                assert got[k].tobytes() == want[k].tobytes(), (path, k)
                assert (got[k].flags.f_contiguous
                        == want[k].flags.f_contiguous), (path, k)


def test_load_many_and_errors(tmp_path):
    paths = []
    for i in range(4):
        p = str(tmp_path / f"d{i}.npz")
        np.savez_compressed(p, x=np.full((10,), i, np.float32))
        paths.append(p)
    out = native.load_many(paths)
    assert [out[p]["x"][0] for p in paths] == [0, 1, 2, 3]
    with pytest.raises(OSError):
        native.load_npz_native(str(tmp_path / "missing.npz"))
    p = tmp_path / "ok.npz"
    np.savez(p, a=np.arange(4, dtype=np.float32))
    blob = bytearray(p.read_bytes())
    i = blob.find(b"'shape': (4,)")
    blob[i:i + 13] = b"'shape': (9,)"          # header disagrees with payload
    (tmp_path / "bad.npz").write_bytes(bytes(blob))
    with pytest.raises(OSError):
        native.load_npz_native(str(tmp_path / "bad.npz"))


def test_load_dataset_and_standard_splits_are_jaxs(tmp_path):
    """The canonical 96-feature file names in a directory: load_dataset,
    load_dataset_with_weights and standard_splits give JAX's datasets."""
    for i, names in enumerate(jdata.SPLIT_FILES_96.values()):
        for j, name in enumerate(names):
            x, y = rows(50 + 10 * i + j, c=96, seed=i * 10 + j)
            np.savez_compressed(tmp_path / name, features=x, poses=y)
    one = str(tmp_path / jdata.SPLIT_FILES_96["train"][0])
    for mine, want in ((load_dataset(one), jdata.load_dataset(one)),
                       (load_dataset_with_weights(one),
                        jdata.load_dataset_with_weights(one))):
        np.testing.assert_array_equal(mine.features, want.features)
        np.testing.assert_array_equal(mine.poses, want.poses)
        if want.weights is not None:
            np.testing.assert_array_equal(mine.weights, want.weights)
    for weights in (False, True):
        mine = standard_splits(str(tmp_path), 96, with_weights=weights)
        want = jdata.standard_splits(str(tmp_path), 96, with_weights=weights)
        assert sorted(mine) == sorted(want) == ["test_aflw2000", "test_biwi",
                                                "train"]
        for role in want:
            np.testing.assert_array_equal(mine[role].features,
                                          want[role].features)
            np.testing.assert_array_equal(mine[role].poses, want[role].poses)
    assert standard_splits(str(tmp_path), 88) == {}
