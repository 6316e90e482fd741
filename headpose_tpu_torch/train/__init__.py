"""Training stack, PyTorch edition: config, the Keras-exact loop,
checkpoints, logging, sweeps (port of headpose_tpu/train)."""
from .checkpoints import (latest_step, restore_checkpoint, restore_pytree,
                          save_checkpoint, save_pytree)
from .config import TrainConfig, config_88, config_96, parse_cli
from .logging import (JsonlLogger, MultiLogger, WandbLogger,
                      angle_distribution_summary, learning_curve_summary,
                      make_logger, new_run_id, plot_angle_distributions,
                      plot_learning_curves, to_jsonable)
from .loop import (HeadOptimizer, TrainResult, build_head, evaluate, fit,
                   make_optimizer)
from .sweep import SweepConfig, SweepResult, load_sweep_file, run_sweep

__all__ = [
    "TrainConfig", "config_88", "config_96", "parse_cli",
    "build_head", "make_optimizer", "HeadOptimizer", "fit", "TrainResult",
    "evaluate",
    "save_checkpoint", "restore_checkpoint", "latest_step",
    "save_pytree", "restore_pytree",
    "JsonlLogger", "WandbLogger", "MultiLogger", "make_logger",
    "new_run_id", "angle_distribution_summary", "learning_curve_summary",
    "plot_learning_curves", "plot_angle_distributions", "to_jsonable",
    "SweepConfig", "load_sweep_file", "run_sweep", "SweepResult",
]
