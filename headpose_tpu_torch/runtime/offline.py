"""Offline video processing: batched detection over whole files.

Port of headpose_tpu/runtime/offline.py.  The reference can only process
video frame by frame through its batch-1 model.  This pipeline runs
detection over a clip in large batches through `detect_stream` (uploads
overlap compute on the card), applies identity-matched EMA smoothing over
the whole timeline on the detector's device (runtime.tracking.
track_sequence — filters follow faces via IoU association, not NMS score
ranks; pass tracking=False for the reference-like per-slot filters),
optionally writes the annotated video (runtime.viz), and returns the slabs
on the host.

    python -m headpose_tpu_torch.runtime.offline in.mp4 --model unified-best-distilled --out annotated.mp4

Reading and writing a video file needs OpenCV (`cv2`).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from .results import BatchResults
from .smoothing import smooth_sequence
from .streaming import detect_stream
from .tracking import track_sequence

__all__ = ["VideoResults", "process_video", "process_frames"]


@dataclasses.dataclass
class VideoResults:
    """Per-frame detection slabs for a whole clip (T frames), on the host."""

    boxes: np.ndarray      # (T, F, 4)
    keypoints: np.ndarray  # (T, F, 6, 2)
    scores: np.ndarray     # (T, F)
    poses: np.ndarray      # (T, F, 3)
    valid: np.ndarray      # (T, F)


def _smooth_timeline(res: VideoResults, alpha: float, tracking: bool,
                     state=None, return_state: bool = False,
                     device: str | torch.device = "cpu"):
    """One smoothing pass shared by process_frames and process_video's
    chunked loop, on `device`: identity-matched (track_sequence) or
    slot-keyed (smooth_sequence), with optional state carry across chunks.
    Returns tensors on `device`."""
    def on(a):
        return torch.as_tensor(a).to(device)

    signals = {"poses": on(res.poses), "boxes": on(res.boxes),
               "keypoints": on(res.keypoints)}
    if tracking:
        return track_sequence(on(res.boxes), on(res.valid), signals, alpha,
                              state=state, return_state=return_state)
    return smooth_sequence(signals, alpha, valid=on(res.valid),
                           state=state, return_state=return_state)


def _host(smoothed: dict) -> dict:
    return {k: v.cpu().numpy() for k, v in smoothed.items()}


def process_frames(detector, frames: np.ndarray, batch_size: int = 64,
                   smooth_alpha: float | None = 0.15,
                   tracking: bool = True) -> VideoResults:
    """frames (T, H, W, 3) BGR → VideoResults: detection in batches of
    `batch_size` through detect_stream (the last batch padded with zero
    frames, so every dispatch has one shape), smoothing over the timeline in
    one pass on the detector's device (identity-matched IoU tracking by
    default; tracking=False keys filters by NMS slot instead)."""
    starts = range(0, len(frames), batch_size)
    counts = [len(frames[s:s + batch_size]) for s in starts]

    def padded():
        for start, n in zip(starts, counts):
            chunk = frames[start:start + n]
            if n < batch_size:
                chunk = np.concatenate(
                    [chunk, np.zeros_like(chunk[:1]).repeat(batch_size - n,
                                                            0)])
            yield chunk

    slabs = [batch.slab[:n] for batch, n in
             zip(detect_stream(detector, padded()), counts)]
    host = BatchResults(torch.cat(slabs).cpu())   # one copy to the host
    out = VideoResults(**{f: getattr(host, f).numpy()
                          for f in ("boxes", "keypoints", "scores", "poses",
                                    "valid")})
    if smooth_alpha is not None:
        smoothed = _host(_smooth_timeline(out, smooth_alpha, tracking,
                                          device=detector.device))
        out.poses = smoothed["poses"]
        out.boxes = smoothed["boxes"]
        out.keypoints = smoothed["keypoints"]
    return out


def process_video(detector, path: str, out_path: str | None = None,
                  batch_size: int = 64, smooth_alpha: float | None = 0.15,
                  max_frames: int | None = None,
                  tracking: bool = True) -> VideoResults:
    """Read a video file chunk by chunk (bounded host memory — an hour of
    1080p would not fit RAM whole), detect per chunk, and with `out_path`
    write the annotated copy as it goes (mp4v, the source's frame rate);
    smoothing state carries across chunks, so the result equals one pass
    over the whole timeline.  Needs cv2."""
    import cv2

    from .results import Results
    from .viz import draw_detections

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open video {path!r}")
    fps = cap.get(cv2.CAP_PROP_FPS) or 20.0

    writer = None
    chunks: list[VideoResults] = []
    ema_state = None
    total = 0
    try:
        while max_frames is None or total < max_frames:
            frames = []
            budget = batch_size if max_frames is None else min(
                batch_size, max_frames - total)
            while len(frames) < budget:
                ok, frame = cap.read()
                if not ok:
                    break
                frames.append(frame)
            if not frames:
                break
            chunk = np.stack(frames)
            total += len(frames)
            res = process_frames(detector, chunk, batch_size,
                                 smooth_alpha=None)
            if smooth_alpha is not None:
                smoothed, ema_state = _smooth_timeline(
                    res, smooth_alpha, tracking, state=ema_state,
                    return_state=True, device=detector.device)
                smoothed = _host(smoothed)
                res = VideoResults(boxes=smoothed["boxes"],
                                   keypoints=smoothed["keypoints"],
                                   scores=res.scores,
                                   poses=smoothed["poses"],
                                   valid=res.valid)
            chunks.append(res)

            if out_path:
                if writer is None:
                    writer = cv2.VideoWriter(
                        out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        (chunk.shape[2], chunk.shape[1]))
                for t in range(len(frames)):
                    m = res.valid[t]
                    writer.write(draw_detections(chunk[t], Results(
                        boxes=res.boxes[t][m], keypoints=res.keypoints[t][m],
                        scores=res.scores[t][m], poses=res.poses[t][m])))
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    if not chunks:
        raise RuntimeError(f"no frames in {path!r}")

    return VideoResults(**{f: np.concatenate([getattr(c, f) for c in chunks])
                           for f in ("boxes", "keypoints", "scores", "poses",
                                     "valid")})


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("video")
    p.add_argument("--model", default=None,
                   help="H5, native model dir or pretrained registry name; "
                        "default: shipped flagship")
    p.add_argument("--out", default=None, help="annotated copy (mp4)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--no_smooth", action="store_true")
    p.add_argument("--no_tracking", action="store_true",
                   help="key filters by NMS slot instead of IoU identity")
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--head_eval", default="auto",
                   choices=["auto", "map", "survivors"],
                   help="pose heads over every map cell ('map', the "
                        "reference semantics) or on the detected faces' "
                        "feature vectors ('survivors'); 'auto' picks "
                        "survivors exactly when a head declares spatial "
                        "context (e.g. unified-best)")
    args = p.parse_args(argv)
    from .http import _build_detector

    det = _build_detector(args.model, head_eval=args.head_eval)
    res = process_video(det, args.video, args.out, args.batch_size,
                        None if args.no_smooth else 0.15, args.max_frames,
                        tracking=not args.no_tracking)
    counts = res.valid.sum(axis=1)
    print(f"{len(counts)} frames, faces/frame min {counts.min()} "
          f"max {counts.max()} mean {counts.mean():.2f}")


if __name__ == "__main__":
    main()
