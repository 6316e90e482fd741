"""Identity-matched multi-face smoothing: IoU track association + per-track EMA.

Port of headpose_tpu/runtime/tracking.py, slot for slot.  runtime.smoothing
keys filters per NMS output slot, but a slot is a score rank, not an
identity: two faces that swap score order between frames swap filter
states.  Here detections are greedily matched to persistent TRACKS by box
IoU before the EMA update, so filters follow faces, not ranks.

Everything is a pure function over an explicit TrackState of fixed-size
tensors (fixed slot count, validity masks) on one device, CPU or CUDA.  The
greedy matching is a loop of tensor steps under `torch.where`, one step per
valid detection at most (`min(F, T)` below an IoU threshold of -1, as the
reference runs): each step decided on the device, the number of valid
detections read once per frame (on the card, one synchronisation a frame,
never one a step).  Detections move to tracks and back as sums of one-hot
products, elementwise (no matrix product, so no TF32): exact in fp32 for
finite values, and a NaN or an inf in any row spreads through its 0-weight
products as it does through the reference's one-hot matmuls.

    tracker = IoUTrackSmoother(alpha=0.15)
    smoothed = tracker(results.boxes, results.valid,
                       {"poses": results.poses, "boxes": results.boxes})
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .smoothing import (EmaState, ema_init, ema_update, tree_leaves,
                        tree_map)

__all__ = ["TrackState", "tracks_init", "associate", "tracks_update",
           "track_sequence", "IoUTrackSmoother"]

_FREE_PRIORITY = 1 << 20   # free slots always beat stealing a stale track


class TrackState(NamedTuple):
    """Persistent per-slot track state (all tensors fixed-size over T slots)."""

    boxes: torch.Tensor   # (T, 4) last matched box per track
    active: torch.Tensor  # (T,) bool — slot holds a live track
    age: torch.Tensor     # (T,) int32 — frames since this track last matched
    ema: EmaState         # per-slot filters over the smoothed signal tree


def tracks_init(example_signals: Any, num_slots: int) -> TrackState:
    """Fresh state. example_signals: tree of (F, ...) per-detection tensors —
    only shapes, dtypes and the device are read; filters are allocated per
    track slot."""
    example_signals = tree_map(torch.as_tensor, example_signals)
    per_track = tree_map(
        lambda a: torch.zeros((num_slots,) + tuple(a.shape[1:]),
                              dtype=a.dtype, device=a.device),
        example_signals)
    dev = tree_leaves(example_signals)[0].device
    return TrackState(
        boxes=torch.zeros((num_slots, 4), dtype=torch.float32, device=dev),
        active=torch.zeros((num_slots,), dtype=torch.bool, device=dev),
        age=torch.zeros((num_slots,), dtype=torch.int32, device=dev),
        ema=ema_init(per_track))


def associate(track_boxes: torch.Tensor, track_active: torch.Tensor,
              track_age: torch.Tensor, boxes: torch.Tensor,
              valid: torch.Tensor, iou_threshold: float = 0.3):
    """Greedy IoU assignment of detections to track slots.

    Highest-IoU (detection, active track) pairs match first (each side used
    once, matches require IoU > iou_threshold; of equal IoUs the first in
    row-major (detection, track) order wins, as `argmax` takes the first
    maximum); remaining valid detections open new tracks on free slots (or
    steal the stalest unmatched slot if none are free; with sustained track
    churn — more than T distinct faces inside a max_missed window — the
    stolen slot can hold a recently-missed track, whose filter then re-seeds
    on reappearance instead of resuming.  Raise num_slots or lower
    max_missed if that matters).  If fresh detections outnumber the
    assignable slots, the overflow gets slot -1 (callers pass the raw
    measurement through unsmoothed).

    Returns (slot (F,) int64 — track slot per detection, -1 for unassigned
    and for invalid detections (below an IoU threshold of -1, junk for
    invalid detections, as in the reference); new_track (F,) bool —
    detection actually opened a fresh track)."""
    F, T = boxes.shape[0], track_boxes.shape[0]
    dev = boxes.device
    # IoU matrix detections x tracks
    x1 = torch.maximum(boxes[:, None, 0], track_boxes[None, :, 0])
    y1 = torch.maximum(boxes[:, None, 1], track_boxes[None, :, 1])
    x2 = torch.minimum(boxes[:, None, 2], track_boxes[None, :, 2])
    y2 = torch.minimum(boxes[:, None, 3], track_boxes[None, :, 3])
    inter = (torch.clamp(x2 - x1, min=0.0)
             * torch.clamp(y2 - y1, min=0.0))
    area_d = (torch.clamp(boxes[:, 2] - boxes[:, 0], min=0.0)
              * torch.clamp(boxes[:, 3] - boxes[:, 1], min=0.0))
    area_t = (torch.clamp(track_boxes[:, 2] - track_boxes[:, 0], min=0.0)
              * torch.clamp(track_boxes[:, 3] - track_boxes[:, 1], min=0.0))
    union = area_d[:, None] + area_t[None, :] - inter
    iou = torch.where(union > 0.0, inter / union, torch.zeros_like(inter))

    eligible = valid[:, None] & track_active[None, :]
    m = torch.where(eligible, iou, torch.full_like(iou, -1.0))
    rows = torch.arange(F, device=dev)
    cols = torch.arange(T, device=dev)
    slot = torch.full((F,), -1, dtype=torch.int64, device=dev)
    # greedy steps, each decided on the device: the best pair is taken when
    # it clears the threshold, and its row and column retire.  A step that
    # takes a pair retires a valid row, and once a step takes none no later
    # step does, so the valid detections bound the steps the reference's
    # min(F, T) would run to the same end.  Below -1 that bound fails (a
    # retired or ineligible pair, -1, clears the threshold), so the
    # reference's min(F, T) steps run
    steps = min(F, T) if iou_threshold < -1.0 else min(int(valid.sum()), T)
    for _ in range(steps):
        flat = torch.argmax(m.reshape(-1))
        i, j = flat // T, flat % T
        ok = m.reshape(-1)[flat] > iou_threshold
        slot = torch.where(ok & (rows == i), j, slot)
        retire = ok & ((rows[:, None] == i) | (cols[None, :] == j))
        m = torch.where(retire, -1.0, m)

    matched = slot >= 0
    taken = torch.any((slot[:, None] == cols[None, :]) & matched[:, None],
                      dim=0)                                        # (T,)
    new_track = valid & ~matched
    # free slots first (low index first), then stalest unmatched tracks
    # (older age = higher priority); slots matched this frame are never taken
    priority = torch.where(
        taken, -1,
        torch.where(~track_active, _FREE_PRIORITY - cols,
                    track_age.to(torch.int64)))
    order = torch.argsort(-priority, stable=True)                   # (T,)
    rank = torch.cumsum(new_track.to(torch.int64), 0) - 1           # (F,)
    # more fresh detections than assignable slots (free + stealable): the
    # overflow gets NO slot (-1) rather than colliding on a clipped index —
    # a collision would sum two faces into one track measurement, and
    # clipping could also land on a slot matched this very frame
    n_avail = torch.sum(priority >= 0)
    overflow = new_track & (rank >= n_avail)
    slot = torch.where(new_track & ~overflow,
                       order[torch.clamp(rank, 0, T - 1)], slot)
    return slot, new_track & ~overflow


def tracks_update(state: TrackState, boxes: torch.Tensor,
                  valid: torch.Tensor, signals: Any, alpha: float,
                  iou_threshold: float = 0.3, max_missed: int = 10):
    """One tracking + smoothing step (pure).

    boxes (F, 4) / valid (F,): this frame's detections.  signals: tree of
    (F, ...) per-detection tensors to smooth.  Returns (new_state, smoothed
    signals in DETECTION order)."""
    boxes = torch.as_tensor(boxes)
    valid = torch.as_tensor(valid)
    signals = tree_map(torch.as_tensor, signals)
    T = state.boxes.shape[0]
    F = boxes.shape[0]
    slot, new_track = associate(state.boxes, state.active, state.age,
                                boxes, valid, iou_threshold)

    # detection -> track as the reference's one-hot product (T, F) @ (F, C),
    # written as elementwise products summed over F: one weight of 1 at
    # most per sum, so finite rows copy exactly, and 0 * NaN (or 0 * inf)
    # spreads a non-finite value of any row, valid or not, as it does there
    cols = torch.arange(T, device=boxes.device)
    onehot = ((slot[None, :] == cols[:, None])
              & valid[None, :]).to(torch.float32)                  # (T, F)

    def to_tracks(a):
        flat = a.reshape(F, -1).to(torch.float32)
        out = (onehot[:, :, None] * flat[None]).sum(1)
        return out.reshape((T,) + tuple(a.shape[1:]))

    track_meas = tree_map(to_tracks, signals)
    got = onehot.sum(1) > 0                                         # (T,)
    opened = (onehot * new_track.to(torch.float32)[None, :]).sum(1) > 0

    # fresh tracks must seed, not blend with the slot's previous occupant
    ema = EmaState(
        value=state.ema.value,
        initialized=tree_map(
            lambda init: init & ~opened.reshape(
                opened.shape + (1,) * (init.ndim - 1)),
            state.ema.initialized))
    ema, smoothed_tracks = ema_update(ema, track_meas, alpha, valid=got)

    # smoothed values back to detection order: the transposed product, so a
    # detection with no slot reads zero, and a non-finite track value
    # spreads as it does there
    def to_dets(a):
        flat = a.reshape(T, -1).to(torch.float32)
        out = (onehot.t()[:, :, None] * flat[None]).sum(1)
        return out.reshape((F,) + tuple(a.shape[1:]))

    smoothed = tree_map(to_dets, smoothed_tracks)
    # valid detections that received no slot (slot overflow — more fresh
    # faces than free+stealable slots) pass through UNSMOOTHED rather than
    # as zeros
    unassigned = valid & (slot < 0)

    def _fallback(s, raw):
        m = unassigned.reshape(unassigned.shape + (1,) * (s.ndim - 1))
        return torch.where(m, raw.to(s.dtype), s)

    smoothed = tree_map(_fallback, smoothed, signals)

    track_boxes = torch.where(got[:, None], to_tracks(boxes), state.boxes)
    age = torch.where(got, 0, state.age + 1)
    active = (state.active | got) & (age <= max_missed)
    return TrackState(track_boxes, active, age, ema), smoothed


def track_sequence(boxes, valid, signals: Any, alpha: float,
                   iou_threshold: float = 0.3, max_missed: int = 10,
                   num_slots: int | None = None,
                   state: TrackState | None = None,
                   return_state: bool = False) -> Any:
    """Identity-matched smoothing over a whole timeline, frame by frame.

    boxes (N, F, 4) / valid (N, F) / signals tree of (N, F, ...) in frame
    order → smoothed signals, same shapes.  The loop carries TrackState, so
    filters follow faces (IoU association) across the video — the timeline
    analogue of IoUTrackSmoother, used by runtime.offline.

    state/return_state mirror smoothing.smooth_sequence: pass the returned
    state into the next call to process a long video in chunks with results
    identical to one pass."""
    boxes = torch.as_tensor(boxes)
    valid = torch.as_tensor(valid)
    signals = tree_map(torch.as_tensor, signals)
    if state is None:
        slots = num_slots or 2 * boxes.shape[1]
        state = tracks_init(tree_map(lambda a: a[0], signals), slots)
    smoothed = []
    for t in range(boxes.shape[0]):
        state, out = tracks_update(state, boxes[t], valid[t],
                                   tree_map(lambda a: a[t], signals), alpha,
                                   iou_threshold, max_missed)
        smoothed.append(out)
    stacked = tree_map(lambda *frames: torch.stack(frames), *smoothed)
    return (stacked, state) if return_state else stacked


class IoUTrackSmoother:
    """Stateful wrapper for live streams — the identity-matched upgrade of
    smoothing.TrackSmoother.  Call once per frame with this frame's boxes,
    validity mask, and the signal tree to smooth."""

    def __init__(self, alpha: float = 0.15, iou_threshold: float = 0.3,
                 max_missed: int = 10, num_slots: int | None = None):
        self.alpha = float(alpha)
        self.iou_threshold = float(iou_threshold)
        self.max_missed = int(max_missed)
        self.num_slots = num_slots
        self._state: TrackState | None = None

    def reset(self) -> None:
        self._state = None

    def __call__(self, boxes, valid, signals: Any) -> Any:
        boxes = torch.as_tensor(boxes)
        valid = torch.as_tensor(valid)
        signals = tree_map(torch.as_tensor, signals)
        if self._state is None:
            slots = self.num_slots or 2 * boxes.shape[0]
            self._state = tracks_init(signals, slots)
        self._state, smoothed = tracks_update(
            self._state, boxes, valid, signals, self.alpha,
            self.iou_threshold, self.max_missed)
        return smoothed
