"""Live demo: camera/video → detect → smooth → draw → display/record.

Port of headpose_tpu/runtime/demo.py, the reference webcam loop:
center-square crop, per-frame detection, EMA smoothing (alpha 0.15, per
tracked face), axis/box/keypoint overlay, optional MP4 recording, 'q' to
quit; --video for a file and --frames N for a headless run.  Detection runs
on the card (or the CPU with --device cpu), on a remote PoseServer
(--server URL), or through the edge pipeline (--tflite: a tools.tflite
unified artifact + the native C++ postprocess, runtime.edge, on the host);
smoothing and drawing run on the host.

    python -m headpose_tpu_torch.runtime.demo --video clip.mp4 --headless --frames 100

Capturing and drawing need OpenCV (`cv2`); --tflite needs a TFLite
interpreter (tensorflow).
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..ops.detection import C_LOGIT, C_POSE
from ..pretrained import resolve_model_path
from ..utils.profiling import FpsCounter
from .results import BatchResults, Results
from .viz import draw_detections

__all__ = ["run_demo"]


def _center_square(frame: np.ndarray) -> np.ndarray:
    h, w = frame.shape[:2]
    side = min(h, w)
    y, x = (h - side) // 2, (w - side) // 2
    return frame[y:y + side, x:x + side]


class _RemoteDetector:
    """A detector-shaped adapter over a PoseClient: the loop runs unchanged
    while inference happens on a remote PoseServer.  Ragged wire results
    re-enter the slab pipeline through BatchResults.from_ragged."""

    def __init__(self, url: str):
        from .client import PoseClient

        self.client = PoseClient(url)

    def detect(self, frame) -> BatchResults:
        return BatchResults.from_ragged([self.client.detect(frame)])

    def close(self) -> None:
        self.client.close()


class _EdgeAdapter:
    """A detector-shaped adapter over EdgeDetector.  Camera-resolution
    frames pass straight through: EdgeDetector owns the resize with the
    TF-exact bicubic kernel (ops/bicubic.py, the matrices the torch path
    applies).  Results are normalized coordinates, so overlays draw on the
    full-resolution frame unchanged."""

    def __init__(self, tflite_path: str):
        from .edge import EdgeDetector

        self.detector = EdgeDetector(tflite_path)

    def detect(self, frame) -> BatchResults:
        return self.detector.detect(frame)


def _smoothed(batch: BatchResults, smoother, tracking: bool) -> BatchResults:
    """One frame's slab (on the host) with its boxes, keypoints and poses
    smoothed: identity-matched tracks, or one filter per NMS slot."""
    signals = {"poses": batch.poses, "boxes": batch.boxes,
               "keypoints": batch.keypoints}
    if tracking:
        out = smoother(batch.boxes[0], batch.valid[0],
                       {k: v[0] for k, v in signals.items()})
        out = {k: v[None] for k, v in out.items()}
    else:
        out = smoother(signals, valid=batch.valid)
    slab = batch.slab.clone()
    B, F = slab.shape[:2]
    slab[..., :4] = out["boxes"]
    slab[..., 4:C_POSE] = out["keypoints"].reshape(B, F, -1)
    slab[..., C_POSE:C_LOGIT] = out["poses"]
    return BatchResults(slab)


def run_demo(model_path: str | None = None, source: int | str = 0,
             record: bool = False, use_ema: bool = True, alpha: float = 0.15,
             max_frames: int | None = None, display: bool = True,
             precision: str = "highest", tracking: bool = True,
             head_eval: str = "auto", server: str | None = None,
             tflite: str | None = None,
             device: str | torch.device | None = None) -> int:
    """Run the live loop; returns the number of frames processed.

    model_path: H5 file, native model dir, a pretrained registry name, or
    None for the shipped flagship.  precision, head_eval: as FaceDetector.
    tracking: match detections to persistent tracks by IoU before smoothing
    (runtime.tracking); False keys the filters by NMS slot.  server: a
    PoseServer URL, where inference runs; the model and serving config live
    there, so model_path/precision/head_eval stay at their defaults.
    tflite: a tools.tflite unified artifact, run through the edge pipeline
    (runtime.edge.EdgeDetector: TFLite + the native C++ postprocess); its
    config is baked in at export, so model_path/precision/head_eval stay at
    their defaults.  device: None (the card) or "cpu" for the local
    detector."""
    import cv2

    if server is not None or tflite is not None:
        if (model_path is not None or precision != "highest"
                or head_eval != "auto"):
            where = ("on the server" if server is not None
                     else "baked into the artifact at export")
            raise ValueError(
                "the model and serving config live " + where + " — drop "
                "--model/--precision/--head_eval (configure them there)")
        if server is not None and tflite is not None:
            raise ValueError("--server and --tflite are exclusive: pick "
                             "remote inference or the local edge pipeline")
        detector = (_RemoteDetector(server) if server is not None
                    else _EdgeAdapter(tflite))
    else:
        from .detector import FaceDetector

        model_path = resolve_model_path(model_path)
        kw = dict(precision=precision, head_eval=head_eval, device=device)
        if model_path is None:
            from ..pretrained import flagship_detector

            detector = flagship_detector(**kw)
        elif os.path.isdir(model_path):
            detector = FaceDetector.from_native(model_path, **kw)
        else:
            detector = FaceDetector.from_h5(model_path, **kw)
    if use_ema:
        from .smoothing import TrackSmoother
        from .tracking import IoUTrackSmoother

        smoother = (IoUTrackSmoother(alpha) if tracking
                    else TrackSmoother(alpha))
    fps = FpsCounter()

    cap = cv2.VideoCapture(source)
    if not cap.isOpened():
        raise RuntimeError(f"cannot open capture source {source!r}")

    writer = None
    frames = 0
    try:
        while max_frames is None or frames < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            frame = _center_square(frame)

            # one device → host copy; smoothing and drawing run on the host
            batch = BatchResults(detector.detect(frame).slab.cpu())
            if use_ema:
                batch = _smoothed(batch, smoother, tracking)
            results: Results = batch.trim()[0]

            out = draw_detections(np.ascontiguousarray(frame), results,
                                  fps=fps.tick())
            if record:
                if writer is None:
                    stamp = time.strftime("%Y%m%d-%H%M%S")
                    writer = cv2.VideoWriter(
                        f"{stamp}.mp4", cv2.VideoWriter_fourcc(*"mp4v"),
                        20.0, (out.shape[1], out.shape[0]))
                writer.write(out)
            if display:
                cv2.imshow("headpose_tpu_torch", out)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break
            frames += 1
    finally:
        cap.release()
        if writer is not None:
            writer.release()
        if display:
            cv2.destroyAllWindows()
        if server is not None:
            detector.close()  # the PoseClient's kept-alive socket
    return frames


def main(argv=None) -> None:
    from .fused import PRECISIONS

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", default=None,
                   help="H5, native model dir, or pretrained name (e.g. "
                        "unified-best); default: shipped flagship")
    p.add_argument("--server", default=None,
                   help="PoseServer URL (e.g. http://gpu-host:8000) — run "
                        "inference remotely; excludes --model/--precision/"
                        "--head_eval (they live server-side)")
    p.add_argument("--tflite", default=None,
                   help="unified .tflite artifact (tools.tflite): run the "
                        "edge pipeline (TFLite + C++ postprocess); excludes "
                        "--server/--model/--precision/--head_eval")
    p.add_argument("--camera", type=int, default=0)
    p.add_argument("--video", default=None,
                   help="video file instead of camera")
    p.add_argument("--record", action="store_true")
    p.add_argument("--no_ema", action="store_true")
    p.add_argument("--no_tracking", action="store_true",
                   help="slot-keyed smoothing instead of IoU track "
                        "association")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--headless", action="store_true")
    p.add_argument("--precision", default="highest", choices=PRECISIONS)
    p.add_argument("--head_eval", default="auto",
                   choices=["auto", "map", "survivors"],
                   help="pose heads over every map cell ('map', the "
                        "reference semantics) or on the detected faces' "
                        "feature vectors ('survivors'); 'auto' picks "
                        "survivors exactly when a head declares spatial "
                        "context (e.g. unified-best)")
    p.add_argument("--device", default=None,
                   help="'cpu' for the local detector on the CPU; default: "
                        "the card")
    args = p.parse_args(argv)
    n = run_demo(model_path=args.model,
                 source=args.video if args.video else args.camera,
                 record=args.record, use_ema=not args.no_ema,
                 max_frames=args.frames, display=not args.headless,
                 precision=args.precision, tracking=not args.no_tracking,
                 head_eval=args.head_eval, server=args.server,
                 tflite=args.tflite, device=args.device)
    print(f"processed {n} frames")


if __name__ == "__main__":
    main()
