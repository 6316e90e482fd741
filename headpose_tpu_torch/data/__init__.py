"""Data layer: feature-map datasets, difficulty weights, canonical splits."""
from .datasets import (Dataset, difficulty_weights, load_dataset,
                       load_dataset_with_weights, standard_splits,
                       train_val_split)

__all__ = ["Dataset", "load_dataset", "load_dataset_with_weights",
           "difficulty_weights", "train_val_split", "standard_splits"]
