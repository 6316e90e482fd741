"""Feature-map datasets, PyTorch edition (numpy code).

Port of headpose_tpu/data/datasets.py.

Datasets are ``.npz`` files with ``features (N, 88|96) float32`` and
``poses (N, 3) float32`` ([yaw, pitch, roll] degrees) — the per-face backbone
feature vectors exported by the reference's sibling extraction repo
(SURVEY.md §2.15).  Loaders mirror Model-88/utilities.py:35-38 and
Model-96/utilities.py:31-34,43-77.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

__all__ = [
    "Dataset", "load_dataset", "load_dataset_with_weights",
    "difficulty_weights", "train_val_split", "standard_splits",
]


@dataclasses.dataclass
class Dataset:
    """An in-memory feature/pose dataset, optionally with per-sample weights."""

    features: np.ndarray  # (N, C)
    poses: np.ndarray     # (N, 3)
    weights: np.ndarray | None = None  # (N,)

    def __len__(self) -> int:
        return self.features.shape[0]

    @property
    def num_features(self) -> int:
        return self.features.shape[1]

    def concat(self, other: "Dataset") -> "Dataset":
        w = None
        if self.weights is not None or other.weights is not None:
            # mixing a weighted and an unweighted dataset must not silently
            # drop the weights — the unweighted side gets the neutral 1.0
            def _w(d: "Dataset"):
                return (d.weights if d.weights is not None
                        else np.ones(len(d.poses), np.float32))
            w = np.concatenate([_w(self), _w(other)])
        return Dataset(np.concatenate([self.features, other.features]),
                       np.concatenate([self.poses, other.poses]), w)


def _read_npz(path: str) -> dict:
    """Read an npz via the native C++ loader when built (bit-identical to
    np.load, GIL-free for threaded multi-file loads), else numpy."""
    from .native import native_available, load_npz_native

    if native_available():
        return load_npz_native(path)
    return _np_load(path)


def _np_load(path: str) -> dict:
    with np.load(path) as data:
        return dict(data)


def load_dataset(path: str) -> Dataset:
    data = _read_npz(path)
    return Dataset(np.asarray(data["features"], np.float32),
                   np.asarray(data["poses"], np.float32))


def difficulty_weights(poses: np.ndarray) -> np.ndarray:
    """Per-sample difficulty weights from head-off-axis angle.

    δ = arccos(cos(pitch)·cos(yaw));  w = 1 for δ ≤ 60°, else 0.5^((δ−60)/5)
    (Eq. 12-13 as used in Model-96/utilities.py:43-77)."""
    yaw = np.deg2rad(poses[:, 0])
    pitch = np.deg2rad(poses[:, 1])
    cos_prod = np.clip(np.cos(pitch) * np.cos(yaw), -1.0, 1.0)
    delta = np.rad2deg(np.arccos(cos_prod))
    w = np.ones_like(delta)
    hard = delta > 60.0
    w[hard] = 0.5 ** ((delta[hard] - 60.0) / 5.0)
    return w.astype(np.float32)


def load_dataset_with_weights(path: str) -> Dataset:
    ds = load_dataset(path)
    ds.weights = difficulty_weights(ds.poses)
    return ds


def train_val_split(ds: Dataset, val_fraction: float = 0.2,
                    seed: int = 42) -> tuple[Dataset, Dataset]:
    """Shuffled split with sklearn.model_selection.train_test_split semantics
    (permutation by RandomState(seed); first ceil(n·frac) rows are validation)
    so splits reproduce the reference's exactly (train_96.py:142-146)."""
    n = len(ds)
    n_val = int(math.ceil(n * val_fraction))
    perm = np.random.RandomState(seed).permutation(n)
    val_idx, train_idx = perm[:n_val], perm[n_val:]

    def take(idx):
        return Dataset(ds.features[idx], ds.poses[idx],
                       None if ds.weights is None else ds.weights[idx])

    return take(train_idx), take(val_idx)


# Canonical dataset roles of the two training pipelines
# (train_88.py:270-279, train_96.py:124-130)
SPLIT_FILES_88 = {
    "train": ["BIWI_Train_Enlarged_features_88_0.7_1.npz",
              "BIWI_NoTrack_Enlarged_features_88_0.7_1.npz"],
    "test_biwi": ["BIWI_Test_Enlarged_features_88_0.7_1.npz"],
    "test_aflw2000": ["AFLW2000_Enlarged_features_88_0.7_1.npz"],
}
SPLIT_FILES_96 = {
    "train": ["BIWI_Train_Enlarged_features_96_0.7_1.npz"],
    "test_biwi": ["BIWI_Test_Enlarged_features_96_0.7_1.npz"],
    "test_aflw2000": ["AFLW2000_features_96_0.7_1.npz"],
}


def standard_splits(root: str, channels: int = 96,
                    with_weights: bool = False) -> dict[str, Dataset]:
    """Load the canonical train/test datasets for one head family from a
    directory of the reference .npz files."""
    from .native import load_many, native_available

    files = SPLIT_FILES_88 if channels == 88 else SPLIT_FILES_96
    present = {role: [os.path.join(root, n) for n in names
                      if os.path.exists(os.path.join(root, n))]
               for role, names in files.items()}
    all_paths = [p for paths in present.values() for p in paths]
    if native_available():
        # the GIL-free C++ loader parallelizes across real threads: the
        # whole directory loads in roughly one file's time
        raw = load_many(all_paths)
    else:
        raw = {p: _np_load(p) for p in all_paths}

    def to_dataset(path: str) -> Dataset:
        d = raw[path]
        ds = Dataset(np.asarray(d["features"], np.float32),
                     np.asarray(d["poses"], np.float32))
        if with_weights:
            ds.weights = difficulty_weights(ds.poses)
        return ds

    out: dict[str, Dataset] = {}
    for role, paths in present.items():
        parts = [to_dataset(p) for p in paths]
        if not parts:
            continue
        ds = parts[0]
        for p in parts[1:]:
            ds = ds.concat(p)
        out[role] = ds
    return out
