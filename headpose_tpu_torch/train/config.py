"""Training configuration, PyTorch edition.

Port of headpose_tpu/train/config.py (same fields, same recipes).  Mirrors the reference's layered config system (SURVEY.md §5.6): a typed config
dataclass (the module-level config dicts of train_88.py:45-64 and
train_96.py:42-59), CLI overrides (train_96.py:217-235), and sweep files
driving those same fields (Model-96/sweep.yaml).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any

__all__ = ["TrainConfig", "config_88", "config_96", "parse_cli"]


@dataclasses.dataclass
class TrainConfig:
    # model
    head: str = "mlp"              # train.loop.HEAD_REGISTRY key
    in_features: int = 96
    num_filters: int = 32
    activation: str = "tanh"
    dropout_rate: float = 0.0
    regularizer_rate: float = 0.0
    # optimization (reference defaults: train_96.py:42-59)
    optimizer: str = "adam"        # adam | sgd | adamax
    learning_rate: float = 2.8e-4
    batch_size: int = 128
    total_epochs: int = 10_000
    # early stopping (train_96.py:159-164)
    early_stopping_patience: int = 40
    early_stopping_min_delta: float = 1e-3
    monitor_metric: str = "val_loss"
    restore_best_weights: bool = True
    # plateau LR schedule (the ReduceLROnPlateau both reference trainers
    # carry commented out — train_88.py:346-351, train_96.py:166-171)
    reduce_lr_on_plateau: bool = False
    reduce_lr_factor: float = 0.5
    reduce_lr_patience: int = 10
    min_lr: float = 1e-6
    # data
    val_fraction: float = 0.2
    split_seed: int = 42
    use_sample_weights: bool = False  # Eq. 12-13 difficulty weighting
    # infra
    seed: int = 42
    checkpoint_dir: str = "checkpoints"
    run_name: str | None = None
    data_dim: str = "data"         # mesh axis name (multi-device: not ported)
    # >1 runs k epochs with the early-stop/NaN/plateau bookkeeping kept in
    # device tensors — same semantics, one host read per k epochs.
    # On-disk checkpoints then land at sync granularity; in-memory
    # best-restore stays exact.
    epochs_per_sync: int = 1

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def replace(self, **kwargs) -> "TrainConfig":
        return dataclasses.replace(self, **kwargs)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "TrainConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in fields})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)


def config_96(**overrides) -> TrainConfig:
    """The Model-96 training recipe (train_96.py): Adam 2.8e-4, batch 128,
    96→num_filters tanh→3 head with SpatialDropout + L2 on kernel+bias."""
    return TrainConfig(head="mlp", in_features=96, activation="tanh",
                       optimizer="adam").replace(**overrides)


def config_88(**overrides) -> TrainConfig:
    """The Model-88 training recipe (train_88.py): SGD 2.8e-4, batch 128,
    residual softsign head (create_model_complex) with dropout 1e-4, L2 1e-6."""
    return TrainConfig(head="residual_mlp", in_features=88,
                       activation="softsign", optimizer="sgd",
                       dropout_rate=1e-4, regularizer_rate=1e-6,
                       total_epochs=1_000_000).replace(**overrides)


def parse_cli(base: TrainConfig, argv: list[str] | None = None) -> TrainConfig:
    """CLI overrides for the sweep-driven hyperparameters, same flags as the
    reference's argparse block (train_96.py:217-235) plus the rest of the
    config surface."""
    parser = argparse.ArgumentParser(description="headpose_tpu_torch trainer")
    parser.add_argument("--dropout_rate", type=float, default=base.dropout_rate)
    parser.add_argument("--regularizer_rate", type=float, default=base.regularizer_rate)
    parser.add_argument("--num_filters", type=int, default=base.num_filters)
    parser.add_argument("--learning_rate", type=float, default=base.learning_rate)
    parser.add_argument("--batch_size", type=int, default=base.batch_size)
    parser.add_argument("--optimizer", type=str, default=base.optimizer)
    parser.add_argument("--head", type=str, default=base.head)
    parser.add_argument("--total_epochs", type=int, default=base.total_epochs)
    parser.add_argument("--epochs_per_sync", type=int,
                        default=base.epochs_per_sync,
                        help="epochs per host read (k>1: the early-stop "
                        "bookkeeping stays on the device for k epochs)")
    parser.add_argument("--run_name", type=str, default=base.run_name)
    parser.add_argument("--checkpoint_dir", type=str, default=base.checkpoint_dir)
    args = parser.parse_args(argv)
    return base.replace(**vars(args))
