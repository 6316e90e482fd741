"""AOT serving artifacts: ship the traced pipeline, not the model.

Port of headpose_tpu/tools/aot.py.  `export_detector` captures a
FaceDetector's end-to-end serving function (`FaceDetector._pipeline`:
preprocess -> network -> postprocess -> survivors' heads, the weights and
the kernels' weight packs embedded as program constants) as one
`torch.export` program per serving batch width, and `load_exported` replays
them with none of `models`, `core`, `train` or the kernels' wrappers on the
import path: only this module, `runtime.results`, and the op library
`ops.kernels.library` (whose `headpose_tpu_torch::` ops are the program's
kernel nodes; it imports `ops.detection` and `utils.build`).

Artifact layout (a directory, like tools.export's native format):
    aot.json            format version, toolchain versions, serving config,
                        batch table
    serve_b{N}.pt2      torch.export.save of the program for batch width N

Notes
-----
- Exported programs pin EVERYTHING static: input height/width/dtype, batch
  width, thresholds, `max_faces`, precision, `head_eval` ("auto" resolved),
  `turbo_island`, `channel_order`, the device (`platforms`: "cuda" or
  "cpu"), and the weights.  Serving config changes are a re-export, not a
  runtime flag.
- A program traced on a CUDA device holds the port's kernels as op nodes
  (kernel #1 in every program; #3, #4, the island kernels and #5 as the
  precision and heads launch them); a program traced on the CPU holds the
  postprocess op, whose CPU implementation is the plain chain, and plain
  tensor ops for the rest.  The kernels build with nvcc on first use, as
  everywhere in the port.
- `ExportedDetector.detect` serves arbitrary batch sizes over the exported
  widths (greedy chunking + zero-padding the tail chunk, then slicing the
  padding back off), so exporting `batch_sizes=(1, 128)` covers any load.
- A replay on CUDA turns TF32 off for the process first, as the
  FaceDetector does: cuDNN would otherwise run the fp32 convs in TF32.
- Multi-device detectors are not ported (FaceDetector(mesh=...) raises,
  ROADMAP.md §1, item 8), so there is nothing of a mesh to refuse here.
"""
from __future__ import annotations

import json
import os
from typing import Any, Sequence

import numpy as np
import torch

from ..ops.detection import SLAB
from ..ops.kernels import library
from ..runtime.results import BatchResults

__all__ = ["export_detector", "load_exported", "ExportedDetector"]

_FORMAT_VERSION = 1
_META_FILE = "aot.json"


def _schema_version() -> list[int] | None:
    """torch.export's serialization schema (major, minor), where this torch
    exposes it."""
    try:
        from torch._export.serde.schema import SCHEMA_VERSION
    except ImportError:
        return None
    return [int(v) for v in SCHEMA_VERSION]


def _versions() -> dict:
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "export_schema": _schema_version()}


def _release(version: str) -> str:
    return version.split("+")[0]


class _Serve(torch.nn.Module):
    """The exported function: a detector's `_pipeline` at detect's choice.
    The detector is no Module, so its weights and packs enter the program
    as lifted constants, not parameters."""

    def __init__(self, det):
        super().__init__()
        self.det = det

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.det._pipeline(images)


def _op_nodes(program) -> list[str]:
    """The port's op nodes of a program's graph, by name, in graph order."""
    prefix = f"{library.NAMESPACE}."
    return [str(node.target).split(".")[1] for node in program.graph.nodes
            if node.op == "call_function"
            and str(node.target).startswith(prefix)]


def export_detector(det, path: str, batch_sizes: Sequence[int] = (1, 128),
                    image_shape: tuple[int, int] | None = None) -> dict:
    """Serialize `det`'s serving pipeline for the given batch widths.

    det: a runtime.FaceDetector (any loader).  Its full serving config —
        thresholds, max_faces, precision, head_eval profile, turbo island,
        channel order, device — and its weights are baked into the
        programs.
    path: output directory (created).
    batch_sizes: program per width; ExportedDetector chunks arbitrary
        batches over these.
    image_shape: (H, W) of the raw frames the programs accept; defaults to
        the model's native input resolution (128 front / 256 back), which
        skips nothing — other sizes just add the bicubic resize in-program.

    The detector runs once on zero frames first, on its device: that makes
    the weight packs (and on the card builds the kernels), which the trace
    then takes as constants.  Returns the metadata dict written to aot.json.
    """
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes or batch_sizes[0] < 1:
        raise ValueError(f"batch_sizes must be positive ints, got {batch_sizes}")
    h, w = image_shape if image_shape is not None else (det.input_size,) * 2
    device = det.device
    backend = "pallas" if device.type == "cuda" else "xla"

    os.makedirs(path, exist_ok=True)
    det.detect(np.zeros((batch_sizes[0], h, w, 3), np.uint8))
    serve = _Serve(det)
    programs = {}
    for b in batch_sizes:
        example = torch.zeros((b, h, w, 3), dtype=torch.uint8, device=device)
        with torch.no_grad():
            program = torch.export.export(serve, (example,))
        program.example_inputs = None    # the trace's zeros: not the program
        fname = f"serve_b{b}.pt2"
        torch.export.save(program, os.path.join(path, fname))
        programs[str(b)] = {"file": fname, "postprocess": backend,
                            "ops": _op_nodes(program)}

    meta = {
        "format_version": _FORMAT_VERSION,
        # deployment-artifact contract: record the producing toolchain so a
        # serving host with another torch fails LOUDLY with both versions in
        # the message instead of a raw deserializer error
        "versions": _versions(),
        "platforms": [device.type],
        "device": str(device),
        "image_shape": [int(h), int(w)],
        "dtype": "uint8",
        "batch_sizes": batch_sizes,
        "programs": programs,
        "max_faces": det.max_faces,
        "config": {
            "score_threshold": det.score_threshold,
            "iou_threshold": det.iou_threshold,
            "precision": det.precision,
            "head_eval": det.head_eval,
            "channel_order": det.channel_order,
            "input_size": det.input_size,
            "turbo_island": (None if det.turbo_island is None
                             else list(det.turbo_island)),
        },
    }
    with open(os.path.join(path, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


class ExportedDetector:
    """Serve a directory written by export_detector.

    detect() accepts any batch size: the batch is chunked greedily over the
    exported widths (largest first), the tail chunk zero-padded up to the
    smallest covering width, and the padding sliced back off — so results
    are identical to calling the source FaceDetector row for row."""

    def __init__(self, path: str):
        with open(os.path.join(path, _META_FILE)) as f:
            self.meta = json.load(f)
        if self.meta.get("format_version") != _FORMAT_VERSION:
            raise ValueError(
                f"AOT artifact {path} has format_version "
                f"{self.meta.get('format_version')}; this reader supports "
                f"{_FORMAT_VERSION}")
        ver, here = self.meta.get("versions", {}), _versions()
        schema, host_schema = ver.get("export_schema"), here["export_schema"]
        if (_release(str(ver.get("torch"))) != _release(here["torch"])
                or (schema and host_schema and schema[0] != host_schema[0])):
            raise ValueError(
                f"AOT artifact {path} was exported by torch "
                f"{ver.get('torch', '?')} (export schema {schema}), but this "
                f"host's torch is {here['torch']} (export schema "
                f"{host_schema}) — re-export the artifact with "
                "tools.aot.export_detector on this host's torch (or match "
                "the producing version)")
        self.platforms = tuple(self.meta["platforms"])
        self.device = torch.device(self.meta.get("device", self.platforms[0]))
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise ValueError(
                    f"AOT artifact {path} was exported for {self.device}, "
                    "and this host has no CUDA device — re-export on the "
                    "CPU for a CPU host")
            # as FaceDetector does: cuDNN runs fp32 convs in TF32 otherwise
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.path = path
        self.batch_sizes = list(self.meta["batch_sizes"])
        h, w = self.meta["image_shape"]
        self._shape_hw = (int(h), int(w))
        self._loaded: dict[int, Any] = {}

    @property
    def frame_shape(self) -> tuple[int, int, int]:
        """The exact (H, W, 3) the exported programs accept — serving front
        ends (runtime.PoseServer) pin their accepted shape from this."""
        return self._shape_hw + (3,)

    @property
    def max_faces(self) -> int:
        return int(self.meta["max_faces"])

    def program(self, batch: int):
        """The loaded program of exported width `batch` (an
        `ExportedProgram`, loaded once)."""
        if batch not in self._loaded:
            fname = self.meta["programs"][str(batch)]["file"]
            try:
                program = torch.export.load(os.path.join(self.path, fname))
            except Exception as e:
                ver = self.meta.get("versions", {})
                raise RuntimeError(
                    f"AOT program {fname} failed to load on torch "
                    f"{torch.__version__} (artifact exported by torch "
                    f"{ver.get('torch', '?')}, export schema "
                    f"{ver.get('export_schema', '?')}): {e} — if the "
                    "versions differ, re-export with "
                    "tools.aot.export_detector on this host's torch") from e
            self._loaded[batch] = (program, program.module())
        return self._loaded[batch][0]

    def _module(self, batch: int):
        self.program(batch)
        return self._loaded[batch][1]

    def _chunks(self, b: int) -> list[int]:
        """Greedy cover of b rows by exported widths (largest first; the
        remainder takes the smallest width that still covers it)."""
        sizes = self.batch_sizes
        out, rest = [], b
        while rest > 0:
            if rest >= sizes[-1]:
                out.append(sizes[-1])
                rest -= sizes[-1]
            else:
                cover = next(s for s in sizes if s >= rest)
                out.append(cover)
                rest = 0
        return out

    def call(self, images) -> torch.Tensor:
        """The finished (B, max_faces, 21) slab (`FaceDetector._pipeline`'s
        contract) on the program's device, without synchronising.

        Batch sizes that match an exported width dispatch with zero extra
        work — size your serving widths (e.g. the DynamicBatcher ladder) to
        the exported batch_sizes.  Other sizes chunk greedily: only the tail
        chunk is zero-padded, and the chunks' slabs are concatenated."""
        if not isinstance(images, torch.Tensor):
            images = torch.from_numpy(np.ascontiguousarray(images))
        if images.ndim == 3:
            images = images[None]
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(
                f"expected (B, H, W, 3) or (H, W, 3) frames, got shape "
                f"{tuple(images.shape)}")
        b, h, w = images.shape[:3]
        if (h, w) != self._shape_hw:
            raise ValueError(
                f"exported programs accept (B, {self._shape_hw[0]}, "
                f"{self._shape_hw[1]}, 3) frames; got {tuple(images.shape)}. "
                "Re-export with image_shape=... for other resolutions.")
        if images.dtype != torch.uint8:
            raise ValueError(
                f"exported programs accept uint8 frames, got {images.dtype} "
                "(float inputs are a tracing-time choice; re-export from a "
                "detector traced on your dtype, or quantize to uint8).")
        if b == 0:
            return torch.zeros((0, self.max_faces, SLAB), dtype=torch.float32,
                               device=self.device)
        images = images.to(self.device)
        parts, row = [], 0
        with torch.inference_mode():
            for width in self._chunks(b):
                take = min(width, b - row)
                chunk = images[row:row + take]
                if take < width:
                    # greedy cover: only the TAIL chunk is ever padded
                    chunk = torch.cat([chunk, chunk.new_zeros(
                        (width - take, h, w, 3))])
                slab = self._module(width)(chunk.contiguous())
                parts.append(slab[:take] if take < width else slab)
                row += take
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def detect(self, images) -> BatchResults:
        """(B, H, W, 3) uint8 frames → BatchResults, identical row for row
        to the source FaceDetector.detect."""
        return BatchResults(self.call(images))


def load_exported(path: str) -> ExportedDetector:
    return ExportedDetector(path)


def main(argv: Sequence[str] | None = None) -> None:
    """CLI: export a model's serving pipeline to an AOT artifact directory.

    python -m headpose_tpu_torch.tools.aot --model unified-best-distilled
        --out aot/ [--batch 1,128] [--precision fast] [--device cpu] ...
    """
    import argparse

    from ..pretrained import resolve_model_path
    from ..runtime.detector import FaceDetector
    from ..runtime.fused import PRECISIONS

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--model", default=None,
                   help="H5 path, native model dir, or pretrained registry "
                        "name (default: the flagship unified model)")
    p.add_argument("--out", required=True, help="output artifact directory")
    p.add_argument("--batch", default="1,128",
                   help="comma-separated batch widths to export")
    p.add_argument("--device", default=None,
                   help="the device the programs run on (default: the card)")
    p.add_argument("--image-size", type=int, default=None,
                   help="square raw-frame size the programs accept "
                        "(default: the model's native input resolution)")
    p.add_argument("--precision", default="highest", choices=PRECISIONS)
    p.add_argument("--score-threshold", type=float, default=0.4)
    p.add_argument("--iou-threshold", type=float, default=0.3)
    p.add_argument("--head-eval", default="auto",
                   choices=["auto", "map", "survivors"])
    args = p.parse_args(argv)

    kw = dict(precision=args.precision, head_eval=args.head_eval,
              score_threshold=args.score_threshold,
              iou_threshold=args.iou_threshold, device=args.device)
    model_path = resolve_model_path(args.model)
    if model_path is None:
        from ..pretrained import flagship_detector

        det = flagship_detector(**kw)
    elif os.path.isdir(model_path):
        det = FaceDetector.from_native(model_path, **kw)
    else:
        det = FaceDetector.from_h5(model_path, **kw)

    shape = (args.image_size,) * 2 if args.image_size else None
    meta = export_detector(
        det, args.out, batch_sizes=[int(b) for b in args.batch.split(",")],
        image_shape=shape)
    sizes = {k: os.path.getsize(os.path.join(args.out, v["file"]))
             for k, v in meta["programs"].items()}
    print(json.dumps({"out": args.out, "batch_sizes": meta["batch_sizes"],
                      "platforms": meta["platforms"],
                      "program_bytes": sizes}))


if __name__ == "__main__":
    main()
