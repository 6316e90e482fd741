"""Temporal smoothing of detection signals.

Port of headpose_tpu/runtime/smoothing.py.  The reference smooths
pose/box/keypoint signals with per-signal EMA filters in its webcam loop,
but keeps ONE shared filter bank for all faces in frame, cross-contaminating
multi-face streams.  Here smoothing is a pure function over an explicit
state, keyed per face slot, so multi-face streams smooth correctly, and a
timeline smooths in chunks with the same result as in one pass.

Signals are trees: nested dicts, lists and tuples whose leaves are tensors
(or arrays, taken with `torch.as_tensor`), walked by `tree_map`.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

__all__ = ["EmaState", "ema_init", "ema_update", "smooth_sequence",
           "TrackSmoother", "tree_map", "tree_leaves"]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest` (trees
    of the same structure); dicts, lists and tuples (NamedTuples too) are
    nodes, anything else a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest))
                 for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):        # a NamedTuple
            return type(tree)(*items)
        return type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of `tree`, in `tree_map`'s order."""
    out: list = []
    tree_map(out.append, tree)
    return out


class EmaState(NamedTuple):
    """State for exponential smoothing of a tree of tensors."""

    value: Any          # tree of tensors — last smoothed values
    initialized: Any    # matching tree of bool tensors (per element)


def ema_init(example: Any) -> EmaState:
    example = tree_map(torch.as_tensor, example)
    return EmaState(
        value=tree_map(torch.zeros_like, example),
        initialized=tree_map(
            lambda a: torch.zeros(a.shape, dtype=torch.bool, device=a.device),
            example))


def ema_update(state: EmaState, measurement: Any, alpha: float,
               valid: Any = None) -> tuple[EmaState, Any]:
    """One smoothing step: y = α·x + (1-α)·y_prev, seeding on first valid sample.

    valid (optional): ONE bool tensor whose shape prefixes every measurement
    leaf (it is right-padded with singleton axes and broadcast per leaf) —
    invalid slots keep their state, so padded face slots don't pollute the
    filters.  Per-leaf validity trees are not supported.
    """
    measurement = tree_map(torch.as_tensor, measurement)
    if valid is not None:
        valid = torch.as_tensor(valid)

    def ok(x):
        if valid is None:
            return torch.ones(x.shape, dtype=torch.bool, device=x.device)
        return valid.reshape(valid.shape + (1,) * (x.ndim - valid.ndim)
                             ).expand(x.shape)

    def step(v_prev, init, x):
        seeded = torch.where(init, alpha * x + (1.0 - alpha) * v_prev, x)
        return torch.where(ok(x), seeded, v_prev)

    new_state = EmaState(
        value=tree_map(step, state.value, state.initialized, measurement),
        initialized=tree_map(lambda init, x: init | ok(x),
                             state.initialized, measurement))
    return new_state, new_state.value


def smooth_sequence(measurements: Any, alpha: float, valid: Any = None,
                    state: EmaState | None = None,
                    return_state: bool = False) -> Any:
    """Smooth a time-major tree (T, ...) frame by frame.

    Pass the returned state back in (with return_state=True) to smooth a long
    timeline chunk by chunk with results identical to one pass."""
    measurements = tree_map(torch.as_tensor, measurements)
    if valid is not None:
        valid = torch.as_tensor(valid)
    if state is None:
        state = ema_init(tree_map(lambda a: a[0], measurements))
    steps = tree_leaves(measurements)[0].shape[0]
    smoothed = []
    for t in range(steps):
        state, out = ema_update(state, tree_map(lambda a: a[t], measurements),
                                alpha, None if valid is None else valid[t])
        smoothed.append(out)
    stacked = tree_map(lambda *frames: torch.stack(frames), *smoothed)
    return (stacked, state) if return_state else stacked


class TrackSmoother:
    """Stateful convenience wrapper for live streams.

    Smooths BatchResults-shaped signals (poses, boxes, keypoints) with one
    filter bank per (image, face-slot) — the multi-face-correct version of the
    reference's single shared bank.
    """

    def __init__(self, alpha: float = 0.15):
        self.alpha = float(alpha)
        self._state: EmaState | None = None

    def reset(self) -> None:
        self._state = None

    def __call__(self, signals: Any, valid=None) -> Any:
        if self._state is None:
            self._state = ema_init(signals)
        self._state, smoothed = ema_update(self._state, signals, self.alpha,
                                           valid=valid)
        return smoothed
