"""SSD anchor generation, vectorized (numpy only).

The MediaPipe-style anchor table in closed form.  For the front-camera
config this yields 896 anchors: 512 on the 16x16 stride-8 grid (2 per cell)
+ 384 on the 8x8 grid (6 per cell, three merged stride-16 layers), all with
w = h = 1.0 (fixed_anchor_size).  The back-camera config (256 input) lands
on the same 16x16 / 8x8 grids, so it also has 896 anchors.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["AnchorConfig", "FRONT_CONFIG", "BACK_CONFIG", "generate_anchors"]


@dataclasses.dataclass(frozen=True)
class AnchorConfig:
    """Anchor-generation options (a subset sufficient for the BlazeFace family)."""

    input_width: int = 128
    input_height: int = 128
    min_scale: float = 0.1484375
    max_scale: float = 0.75
    strides: tuple[int, ...] = (8, 16, 16, 16)
    aspect_ratios: tuple[float, ...] = (1.0,)
    anchor_offset_x: float = 0.5
    anchor_offset_y: float = 0.5
    interpolated_scale_aspect_ratio: float = 1.0
    fixed_anchor_size: bool = True
    reduce_boxes_in_lowest_layer: bool = False


FRONT_CONFIG = AnchorConfig()
BACK_CONFIG = AnchorConfig(input_width=256, input_height=256,
                           min_scale=0.15625, max_scale=0.75,
                           strides=(16, 32, 32, 32))


def _layer_scale(cfg: AnchorConfig, layer: int) -> float:
    n = len(cfg.strides)
    if n == 1:
        return (cfg.min_scale + cfg.max_scale) * 0.5
    return cfg.min_scale + (cfg.max_scale - cfg.min_scale) * layer / (n - 1.0)


def generate_anchors(cfg: AnchorConfig = FRONT_CONFIG) -> np.ndarray:
    """Return the anchor table as float64 (N, 4) = [x_center, y_center, w, h],
    centers normalized to [0, 1]."""
    n_layers = len(cfg.strides)
    rows = []
    layer = 0
    while layer < n_layers:
        stride = cfg.strides[layer]
        # merge consecutive layers with equal stride: their anchors stack per cell
        sizes: list[tuple[float, float]] = []
        same = layer
        while same < n_layers and cfg.strides[same] == stride:
            scale = _layer_scale(cfg, same)
            if same == 0 and cfg.reduce_boxes_in_lowest_layer:
                sizes += [(0.1, 1.0), (scale, 2.0), (scale, 0.5)]
            else:
                sizes += [(scale, ar) for ar in cfg.aspect_ratios]
                if cfg.interpolated_scale_aspect_ratio > 0.0:
                    nxt = 1.0 if same == n_layers - 1 else _layer_scale(cfg, same + 1)
                    sizes.append((math.sqrt(scale * nxt),
                                  cfg.interpolated_scale_aspect_ratio))
            same += 1

        fm_h = math.ceil(cfg.input_height / stride)
        fm_w = math.ceil(cfg.input_width / stride)
        per_cell = len(sizes)

        ys, xs = np.meshgrid(np.arange(fm_h), np.arange(fm_w), indexing="ij")
        cx = (xs.reshape(-1, 1) + cfg.anchor_offset_x) / fm_w
        cy = (ys.reshape(-1, 1) + cfg.anchor_offset_y) / fm_h
        cx = np.repeat(cx, per_cell, axis=0).reshape(-1)
        cy = np.repeat(cy, per_cell, axis=0).reshape(-1)

        if cfg.fixed_anchor_size:
            w = np.ones_like(cx)
            h = np.ones_like(cy)
        else:
            wh = np.array([(s * math.sqrt(ar), s / math.sqrt(ar)) for s, ar in sizes])
            w = np.tile(wh[:, 0], fm_h * fm_w)
            h = np.tile(wh[:, 1], fm_h * fm_w)

        rows.append(np.stack([cx, cy, w, h], axis=1))
        layer = same
    return np.concatenate(rows, axis=0)
