"""FaceDetector: the end-to-end detection + pose runtime, PyTorch edition.

Port of headpose_tpu/runtime/detector.py.  A batch of frames goes through

  preprocess (bicubic resize + normalize, two fp32 matmuls)
  → backbone + SSD heads (cuDNN convs) → pose heads over every map cell
  → postprocess: on a CUDA device the hand-written kernel
    (ops.kernels.postprocess), on the CPU its plain twin
  → BatchResults slabs, `trim()` to ragged per-image Results.
Under head_eval="survivors" the pose heads run after the postprocess, on
the feature vectors at the survivors' cells (`_survivor_poses`).

Use:
    det = flagship_detector()           # on the card; device="cpu" to ask
    batch = det.detect(images)          # (B, H, W, 3) BGR uint8 → BatchResults
    results = batch.trim()              # ragged per-image, reference contract
    res = det.detect_single(image)      # one image → Results
    batch = det.detect_fused(images)    # the network through the fused
                                        # backbone and pose-head kernels
    fast = flagship_detector(precision="fast")   # split-bf16 backbone
                                        # segments; detect runs the kernels
    turbo = flagship_detector(precision="turbo")  # and a single-pass bf16
                                        # island of the trailing blocks
    one = flagship_detector(precision="default")  # every conv and product
                                        # at single-pass bf16
    det = FaceDetector.from_h5("joined.h5")         # a reference unified H5,
                                        # imported into the native model
    det = FaceDetector.from_h5_compat("joined.h5")  # the same file through
                                        # the graph compiler (core.graph)
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from torch import nn

from ..models.anchors import (BACK_CONFIG, FRONT_CONFIG, AnchorConfig,
                              generate_anchors)
from ..models.params import load_native, params_from_jax
from ..models.unified import UnifiedPoseModel, UnifiedPoseNet, unified_from_h5
from ..ops.detection import (C_LOGIT, C_POSE, C_VALID, MAX_FACES,
                             cell_index_maps, gather_survivor_features)
from ..ops.image import preprocess
from ..ops.kernels.backbone2 import island_blocks
from ..ops.kernels.postprocess import postprocess_slab
from ..parallel.distributed import all_gather_rows
from ..parallel.mesh import axis_index, axis_size, mesh_device
from ..utils.device import resolve_device
from ..utils.profiling import TOTALS, span
from ..utils.weights import stamp
from .fused import SERVED_PRECISIONS, fused_network, head_forward, island_of
from .replay import PipelineGraphs, graph_key
from .results import BatchResults, Results

__all__ = ["FaceDetector"]


class FaceDetector:
    """Batched BlazeFace + head-pose detector.

    `model` is a `UnifiedPoseModel` spec with both pose heads and `params`
    its parameters in JAX layout (nested dicts/lists of arrays, as
    `models.params.load_npz` returns them).

    `device=None` means the CUDA device, and raises when there is none; pass
    `device="cpu"` for the plain PyTorch path.  On a CUDA device the
    constructor turns TF32 off for the whole process
    (`torch.backends.cuda.matmul.allow_tf32 = False` and
    `torch.backends.cudnn.allow_tf32 = False`): cuDNN runs fp32 convs in
    TF32 by default, which breaks the 0.1-degree pose parity budget.

    `score_threshold`, `iou_threshold` and `max_faces` are read on every
    call and may be changed between calls.  `channel_order` is fixed at
    construction; the input size is the backbone's, and it chooses the
    anchor table (128 front, 256 back).

    `head_eval` is the head evaluation profile, as in the JAX detector:
      'map'        the pose heads run over every cell of both feature maps
                   before NMS, and each survivor takes its cell's pose (the
                   reference's grafted-graph semantics);
      'survivors'  the heads run after NMS on the feature vectors at the
                   survivors' cells, each face's vector on its own (the
                   training semantics).  Per-cell heads give the 'map'
                   poses; heads that couple a map's cells (SE gating, the
                   SE-Transformer's attention) give another function;
      'auto'       (default) 'survivors' when a head declares
                   `spatial_context` (SE-MLP and SE-Transformer heads, and
                   ensembles with such members, e.g. 'unified-best'),
                   'map' otherwise (the flagship, 'unified-best-distilled').
    The resolved profile is `self.head_eval`.

    `precision` is one of `runtime.fused.SERVED_PRECISIONS`:
      'highest'  exact fp32: `detect` runs the cuDNN network, `detect_fused`
                 the fp32 fused kernels.
      'fast'     the JAX detector's certified fast mode at its precision
                 (3-pass split-bf16, the TPU's 'high'): `detect` and
                 `detect_fused` both run `fused_network(..., "fast")`, whose
                 backbone segments take a split-bf16 pointwise
                 (`ops.kernels.backbone2.apply_fused`); everything else is
                 fp32.  On the CPU it runs the plain split-bf16 version, so
                 the CPU shows the mode's own rounding.
      'high'     JAX's pass-through string for the TPU's 3-pass split-bf16
                 (`jax.default_matmul_precision("high")`): the 'fast'
                 network, slab for slab (JAX's 'fast' differs from its
                 'high' only by the dense composition, exact algebra, which
                 the port's 'fast' never did).  Within the 0.1-degree
                 budget: on the card (NVIDIA H100 80GB HBM3, 700.00 W) set
                 agreement 1.0 and pose p99 6.7e-4 / max 1.28e-3 degrees
                 on the parity corpus, 'fast''s figures, and the stress
                 corpus's contract (JAX recorded 0.0024 degrees for 'high'
                 on the TPU, docs/BENCH.md).
      'default'  JAX's pass-through string for one bf16 pass: every conv
                 and product JAX evaluates inside its
                 `default_matmul_precision` block takes bf16-rounded
                 operands (to nearest even), exact products and fp32 sums,
                 the bias unrounded (`core.single_pass`): the bicubic
                 resize GEMMs when frames are resized, the stem, each
                 block's depthwise and pointwise convs, the four SSD heads
                 and every pose-head product (the survivors' rows too).
                 `detect` runs it through cuDNN and cuBLAS with TF32 off
                 on the rounded operands, and the postprocess (kernel #1)
                 in fp32; no kernel computes the single-pass separable
                 network, so `detect_fused` raises.  OUTSIDE the parity
                 budget: on the card (NVIDIA H100 80GB HBM3, 700.00 W)
                 110 of 112 images keep their detection sets, pose p99
                 0.85 / max 1.50 degrees on the parity corpus, and the
                 stress corpus's contract fails (docs/certification_torch.
                 json); on the CPU 109 of 112, p99 1.05 / max 20.3
                 degrees (two detections past 2 degrees: 4.5 and 20.3),
                 near JAX's own note of "~20 degrees" on pose maps at the
                 TPU's single pass.
      'turbo'    'fast' with an island of blocks at single-pass bf16 (the
                 TPU's Precision.DEFAULT: bf16 operands, exact products,
                 fp32 sums), dense-composed (one 3x3 conv per block, through
                 `ops.kernels.dense_bf16`: the small-map blocks as one chain
                 launch, the others a launch each), and the four SSD
                 heads so too; the island is `turbo_island`, by default
                 `models.blazeface.turbo_fast_blocks(spec)` (the front
                 model's blocks 10-15, the back model's 11-16).
      'max'      every block and the SSD heads at single-pass bf16; the
                 stem stays fp32.
    'turbo' and 'max' lie OUTSIDE the 0.1-degree parity budget, as the JAX
    detector's do (headpose_tpu/runtime/detector.py): on the TPU JAX
    certified pose error p99 0.22 / max 4.2 degrees for 'turbo' with
    identical detection sets on the parity corpus, and p99 0.68 / max 4.9
    degrees for 'max' with 4 of 112 images changing their detection sets;
    neither holds the stress corpus's contract
    (docs/certification.json).  The port's own figures on the card are in
    docs/certification_torch.json (tools/certify_modes.py).  The pose heads
    and the postprocess stay fp32 in every mode.  On the CPU these modes run
    the kernels' plain versions; their island arithmetic is the JAX
    function's at `simulate_fast=True`.

    `turbo_island` (None, or block indices of the spec; () serves the
    'fast' function) overrides the 'turbo' island.  Like `precision`, it is
    read on every call; both are checked at construction.

    The options follow the JAX detector's positional order, so
    `FaceDetector(model, params, 0.5)` sets the score threshold.  Beside
    those above:
      input_size     None, or the backbone's input size (128 front, 256
                     back); any other value raises ValueError: the port
                     serves a model at its own resolution;
      anchor_config  None, or the anchor table of that input size
                     (`models.anchors.FRONT_CONFIG` / `BACK_CONFIG`); any
                     other raises ValueError;
      postprocess    'auto' (the default) or 'pallas': the hand-written
                     kernel (ops.kernels.postprocess, the TPU kernel
                     postprocess_pallas) on a CUDA device, its plain version
                     on the CPU; 'xla': the plain chain of ops.detection
                     (JAX's XLA postprocess), on the CPU only: on a CUDA
                     device it raises ValueError, since the kernel gives
                     the same slab bit for bit.  Read on every call;
      mesh, data_axis  data-parallel serving: a (data, model) DeviceMesh
                     (parallel.create_mesh) and the name of its batch axis.
                     `detect` is then a collective that every rank of the
                     mesh calls with the same global batch, or with a
                     DTensor sharded on dim 0 over the axis
                     (parallel.host_local_batch).  Each rank runs the whole
                     pipeline on its contiguous rows, on its own device,
                     through the same kernels; the slabs are gathered, and
                     every rank returns the whole BatchResults.  The batch
                     must divide by the axis size (`batch_granularity`);
                     fixed at construction.  The device defaults to the
                     mesh's (the rank's card, or the CPU).

    `model` may also be a graph-compiled unified model (`from_h5_compat`;
    `params` None keeps the module's own weights, a JAX-layout dict loads
    into it): it serves `detect` at precision 'highest', 'high' (fp32,
    bitwise 'highest') and 'default' (every product of the graph rounded)
    under the 'map' profile; 'fast', 'turbo', 'max', head_eval='survivors'
    and `detect_fused` need a native backbone spec and raise.
    """

    def __init__(self, model: UnifiedPoseModel, params: Any,
                 score_threshold: float = 0.4, iou_threshold: float = 0.3,
                 max_faces: int = MAX_FACES, input_size: int | None = None,
                 channel_order: str = "bgr", precision: str = "highest",
                 anchor_config: AnchorConfig | None = None,
                 turbo_island=None, postprocess: str = "auto",
                 head_eval: str = "auto", mesh: Any | None = None,
                 data_axis: str = "data", *,
                 device: str | torch.device | None = None):
        if mesh is not None:
            if data_axis not in (mesh.mesh_dim_names or ()):
                raise ValueError(f"data_axis={data_axis!r} is not an axis "
                                 f"of the mesh {mesh.mesh_dim_names}")
            if device is None:
                device = mesh_device(mesh)
            elif torch.device(device).type != mesh.device_type:
                raise ValueError(f"device {device} is not on the mesh's "
                                 f"device type {mesh.device_type!r}")
        self.mesh = mesh
        self.data_axis = data_axis
        self.device = resolve_device(device)
        graph = isinstance(model, GraphUnifiedModel)
        _check_precision(precision, graph)
        if postprocess not in ("xla", "pallas", "auto"):
            raise ValueError(f"postprocess must be 'xla', 'pallas' or "
                             f"'auto', got {postprocess!r}")
        if postprocess == "xla" and self.device.type == "cuda":
            raise ValueError(_XLA_ON_CARD)
        if head_eval not in ("map", "survivors", "auto"):
            raise ValueError(f"head_eval must be 'map', 'survivors' or "
                             f"'auto', got {head_eval!r}")
        if channel_order not in ("bgr", "rgb"):
            raise ValueError(f"channel_order must be 'bgr' or 'rgb', "
                             f"got {channel_order!r}")
        if graph:
            if head_eval == "survivors":
                raise ValueError(
                    "head_eval='survivors' needs a native UnifiedPoseModel "
                    "with both pose heads attached (graph-compiled models "
                    "expose neither the heads nor the feature-map taps) — "
                    "load through from_h5/from_native, or use "
                    "head_eval='map'")
            head_eval = "map"
            own_size = model.input_size
            self.turbo_island = None
        else:
            if model.head88 is None or model.head96 is None:
                raise ValueError("FaceDetector needs a UnifiedPoseModel with "
                                 "both pose heads")
            own_size = model.backbone.input_size
            self.turbo_island = (island_blocks(model.backbone, turbo_island)
                                 if turbo_island is not None else None)
            if head_eval == "auto":
                head_eval = ("survivors" if any(
                    getattr(h, "spatial_context", False)
                    for h in (model.head88, model.head96)) else "map")
        if input_size is not None and int(input_size) != own_size:
            raise ValueError(
                f"input_size={input_size} differs from the model's own input "
                f"size {own_size}; the port serves a model at its own "
                "resolution")
        config = BACK_CONFIG if own_size == 256 else FRONT_CONFIG
        if anchor_config is not None and anchor_config != config:
            raise ValueError(
                f"anchor_config differs from the anchor table of the model's "
                f"input size {own_size} ({config}); the port serves that "
                "table only")
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.head_eval = head_eval
        self.model = model
        if graph:               # params None: the module's own weights
            self.net = model.to(self.device).eval()
            if params is not None:
                model.graph.load_params(params)
        else:
            self.net = UnifiedPoseNet(model, device=self.device).eval()
            self.net.load_state_dict(params_from_jax(model, params))
        self.score_threshold = float(score_threshold)
        self.iou_threshold = float(iou_threshold)
        self.max_faces = int(max_faces)
        self.input_size = own_size
        self.channel_order = channel_order
        self.precision = precision
        self.postprocess = postprocess
        self.anchors = torch.tensor(
            generate_anchors(config).astype(np.float32), device=self.device)
        self._graphs = PipelineGraphs()

    @classmethod
    def from_h5(cls, path, **kwargs) -> "FaceDetector":
        """A reference unified H5 (the JoinModels format: the two pose
        heads nested as submodels), imported into the native model
        (`models.unified_from_h5`); `path` may be a ModelDef parsed
        already.  Reading a file needs h5py."""
        model, params = unified_from_h5(path)
        return cls(model, params, **kwargs)

    @classmethod
    def from_h5_compat(cls, path, **kwargs) -> "FaceDetector":
        """Any reference-format unified H5 (or a ModelDef parsed already)
        through the graph compiler (`core.graph`), on the detector's device:
        it serves graphs the native import cannot (heads that are not
        1x1-conv chains, a flat graph), at precision 'highest', 'high' or
        'default'."""
        from ..core.graph import load_graph_model

        device = resolve_device(kwargs.pop("device", None))
        gm = load_graph_model(path, device=device)
        return cls(GraphUnifiedModel(gm), None, device=device, **kwargs)

    @classmethod
    def from_native(cls, path: str, **kwargs) -> "FaceDetector":
        """Load a native model directory of the port: spec.json (the JAX
        package's spec format) and params.npz (JAX-layout leaves), as
        `tools.export.save_model` writes them."""
        model, params = load_native(path)
        return cls(model, params, **kwargs)

    @property
    def batch_granularity(self) -> int:
        """Every detect() batch must be a multiple of this (1 without a
        mesh; the data-axis size with one — dp serving shards the batch
        evenly).  Batching front ends (runtime.server.DynamicBatcher) build
        their pad ladder on it so every dispatch width is servable."""
        return (axis_size(self.mesh, self.data_axis)
                if self.mesh is not None else 1)

    def detect(self, images) -> BatchResults:
        """images: (B, H, W, 3) or (H, W, 3), uint8/float 0-255, BGR by
        default; a numpy array or a tensor.  Returns the slabs on the
        detector's device without synchronising.  At precision 'high',
        'fast', 'turbo' and 'max' a native model's detect is
        `detect_fused`."""
        return self._detect(images, fused=None)

    def detect_fused(self, images) -> BatchResults:
        """`detect` with the network computed through the fused backbone
        and pose-head kernels (`runtime.fused.fused_network`, at the
        detector's precision) instead of the cuDNN modules; the same
        preprocess and postprocess.  Under the survivors profile the heads
        run through their kernels on the survivors' rows.  A
        graph-compiled model has no native spec for the kernels, and no
        kernel computes precision 'default': both raise."""
        _check_precision(self.precision,
                         isinstance(self.model, GraphUnifiedModel))
        if isinstance(self.model, GraphUnifiedModel):
            raise ValueError(
                "detect_fused runs the fused kernels of a native backbone "
                "spec; this model was graph-compiled (from_h5_compat) and "
                "exposes none.  Use detect, or load through "
                "from_h5/from_native.")
        if self.precision == "default":
            raise ValueError(
                "detect_fused has no kernel for precision 'default' (every "
                "conv and product at single-pass bf16, the separable "
                "network): use detect, which runs it through cuDNN and "
                "cuBLAS on the rounded operands")
        return self._detect(images, fused=True)

    def _detect(self, images, fused: bool) -> BatchResults:
        """A batch's dispatch, the span `detect`: the checks and the upload
        (`detect.checks`), then `_pipeline`: on one CUDA device through
        `runtime.replay.PipelineGraphs` (eager at a key's first call,
        captured at its second, a CUDA graph replayed from then on), on the
        CPU and over a mesh eager."""
        with span("detect"):
            if self.mesh is not None:
                return self._detect_sharded(images, fused)
            with torch.inference_mode():
                with span("detect.checks"):
                    x = host_tensor(images)
                    if x.ndim == 3:
                        x = x[None]
                    if x.ndim != 4 or x.shape[-1] != 3:
                        raise ValueError(f"images must be (B, H, W, 3) or "
                                         f"(H, W, 3), got {tuple(x.shape)}")
                    x = x.to(self.device)
                if self.device.type == "cuda" and x.shape[0]:
                    return BatchResults(self._graphs(
                        lambda t: self._pipeline(t, fused), x,
                        graph_key(self, x, fused), stamp(self.net)))
                TOTALS.count("detect.eager")
                return BatchResults(self._pipeline(x, fused))

    def _detect_sharded(self, images, fused: bool) -> BatchResults:
        """`detect` over the mesh, a collective of every rank: this rank's
        contiguous rows through `_pipeline`, then the slabs gathered over
        the data axis.  Every check that can fail runs before the gather,
        on every rank alike."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        n = self.batch_granularity
        if isinstance(images, DTensor):
            want = [Shard(0) if name == self.data_axis else Replicate()
                    for name in self.mesh.mesh_dim_names]
            if list(images.placements) != want:
                raise ValueError(
                    f"a DTensor batch must be sharded on dim 0 over "
                    f"{self.data_axis!r} (placements {want}), got "
                    f"{images.placements}")
            shape = tuple(images.shape)
        else:
            x = host_tensor(images)
            if x.ndim == 3:
                x = x[None]
            shape = tuple(x.shape)
        if len(shape) != 4 or shape[-1] != 3:
            raise ValueError(f"images must be (B, H, W, 3) or (H, W, 3), "
                             f"got {shape}")
        if shape[0] % n:
            raise ValueError(
                f"batch {shape[0]} does not divide over the {n}-way "
                f"'{self.data_axis}' mesh axis — dp serving shards the "
                "batch evenly (pad the batch or drop the mesh)")
        if isinstance(images, DTensor):
            local = images.to_local()
        else:
            rows = shape[0] // n
            start = axis_index(self.mesh, self.data_axis) * rows
            local = x[start:start + rows]
        with torch.inference_mode():
            slab = self._pipeline(local.to(self.device), fused)
            with span("detect.all_gather"):
                return BatchResults(all_gather_rows(
                    slab, self.mesh.get_group(self.data_axis)))

    def _pipeline(self, x: torch.Tensor,
                  fused: bool | None = None) -> torch.Tensor:
        """The finished (B, F, 21) slab of frames x (B, H, W, 3) on the
        detector's device: preprocess, the network, the postprocess and,
        under the survivors profile, the survivors' gather and heads.
        `fused` None is `detect`'s choice (a native model's fused network
        at 'high', 'fast', 'turbo' and 'max'), True `detect_fused`'s.  At
        'default' the modules run with `single_pass`, the resize too.

        A plain tensor function with no host sync: `detect` calls it under
        inference mode and, on one CUDA device, captures it as a CUDA
        graph (`runtime.replay`); tools/aot.py traces it with
        `torch.export` (after one call has made the weight packs, which
        the trace takes as constants).  Every kernel it reaches launches
        through an op of ops/kernels/library.py on the current stream."""
        precision = self.precision
        graph = isinstance(self.model, GraphUnifiedModel)
        _check_precision(precision, graph)
        if fused is None:
            fused = precision in ("high", "fast", "turbo", "max") and not graph
        single_pass = precision == "default"
        if fused:
            island = (island_of(self.model.backbone, "turbo",
                                self.turbo_island)
                      if precision == "turbo" else None)
            network = functools.partial(fused_network, self.net,
                                        precision=precision, island=island)
            heads = head_forward
        else:
            network = functools.partial(self.net, single_pass=single_pass)
            heads = functools.partial(_module_forward,
                                      single_pass=single_pass)
        with span("detect.preprocess"):
            x = preprocess(x, self.input_size, self.channel_order,
                           single_pass)
        survivors = self.head_eval == "survivors"
        with span("detect.network"):
            out = network(x, heads=not survivors)
        if survivors:
            # the postprocess copies pose values exactly, so cell-index maps
            # bring back each survivor's cell in pose channel 0
            pose_front, pose_back = cell_index_maps(out["feat88"],
                                                    out["feat96"])
        else:
            pose_front, pose_back = out["pose_front"], out["pose_back"]
        with span("detect.postprocess"):
            slab = self._postprocess(out["scores"], out["loc"], pose_front,
                                     pose_back)
            if survivors:
                slab[..., C_POSE:C_LOGIT] = self._survivor_poses(out, slab,
                                                                 heads)
        return slab

    def _postprocess(self, scores, loc, pose_front, pose_back):
        """The finished slab through kernel #1's op (the kernel on a CUDA
        device, its plain version, the plain chain of ops.detection, on the
        CPU); postprocess='xla' names that plain chain, on the CPU only."""
        if self.postprocess == "xla" and scores.is_cuda:
            raise ValueError(_XLA_ON_CARD)
        return postprocess_slab(scores, loc, pose_front, pose_back,
                                self.anchors, max_faces=self.max_faces,
                                score_threshold=self.score_threshold,
                                iou_threshold=self.iou_threshold,
                                input_size=self.input_size)

    def _survivor_poses(self, out, slab, heads) -> torch.Tensor:
        """head_eval='survivors': both pose heads on the feature vectors
        gathered at the survivors' cells, each (B·F, C) row on its own; a
        survivor takes its map's pose, an invalid slot 0."""
        cells = torch.round(slab[..., C_POSE]).to(torch.int64)      # (B, F)
        valid = slab[..., C_VALID] > 0.5
        vf, vb, is_front = gather_survivor_features(
            cells, valid, out["feat88"], out["feat96"])
        B, F = cells.shape
        pf = heads(self.net.head88, vf.reshape(B * F, -1)).reshape(B, F, -1)
        pb = heads(self.net.head96, vb.reshape(B * F, -1)).reshape(B, F, -1)
        z = valid[..., None]
        return torch.where(is_front[..., None] & z, pf,
                           torch.where(z, pb, 0.0))

    def detect_single(self, image) -> Results:
        return self.detect(image).trim()[0]

    def warmup(self, shape: tuple[int, ...] = (1, 480, 480, 3)) -> None:
        """Run one batch of the given shape (cuDNN picks its algorithms and
        the kernel is built on the first call)."""
        self.detect(np.zeros(shape, np.uint8))


_NEEDS_SPEC = (          # JAX's message, word for word
    "precision={precision!r} needs a native backbone spec (dense composition "
    "+ bf16 precision islands); this model was graph-compiled "
    "(from_h5_compat) and exposes none. Use precision='highest', or load "
    "through from_h5/from_native for the accelerated modes.")
_XLA_ON_CARD = (
    "postprocess='xla' (the plain chain of ops.detection) runs on the CPU "
    "only; on a CUDA device use 'auto' or 'pallas': kernel #1 gives the same "
    "slab bit for bit")


def _check_precision(precision: str, graph: bool) -> None:
    """Raise unless a detector serves `precision` (a graph-compiled one:
    not 'fast', 'turbo' or 'max'); checked at construction and on every
    call, since `precision` may change between calls."""
    if precision not in SERVED_PRECISIONS:
        raise ValueError(f"precision={precision!r} is not served by the "
                         f"port; the served strings are {SERVED_PRECISIONS}")
    if graph and precision in ("fast", "turbo", "max"):
        raise ValueError(_NEEDS_SPEC.format(precision=precision))


class GraphUnifiedModel(nn.Module):
    """A compiled 6-output unified GraphModel (core.graph) as the network of
    a FaceDetector: forward(x) → {scores, loc, pose_front, pose_back}, the
    contract of `UnifiedPoseNet.forward` (JAX's _GraphUnifiedAdapter)."""

    def __init__(self, graph_model):
        super().__init__()
        self.graph = graph_model
        name = graph_model.definition.inputs[0][0]
        inp = graph_model.definition.layers[name].config
        shape = inp.get("batch_input_shape") or inp.get("batch_shape")
        if not (shape and len(shape) == 4 and shape[1]):
            raise ValueError(f"the graph's input layer {name!r} has no "
                             f"spatial shape ({shape}); a unified model "
                             "takes (B, H, W, 3) frames of a fixed size")
        self.input_size = int(shape[1])

    def forward(self, x: torch.Tensor, heads: bool = True, *,
                single_pass: bool = False) -> dict[str, torch.Tensor]:
        """`single_pass` (the detector's 'default') rounds every product of
        the graph.  JAX's adapter runs the graph under the GraphModel's own
        `jax.default_matmul_precision` ('highest' as from_h5_compat loads
        it), which overrides the detector's string; the port applies the
        detector's string to the whole network."""
        del heads                      # the graph always computes the maps
        cls_f, cls_b, loc_f, loc_b, pose_f, pose_b = self.graph(
            x, single_pass=single_pass)
        B = x.shape[0]
        return {"scores": torch.cat([cls_f.reshape(B, -1),
                                     cls_b.reshape(B, -1)], 1),
                "loc": torch.cat([loc_f.reshape(B, -1, 16),
                                  loc_b.reshape(B, -1, 16)], 1),
                "pose_front": pose_f, "pose_back": pose_b}


def host_tensor(images) -> torch.Tensor:
    """A tensor as it is, a numpy array (or anything np.asarray takes) as a
    CPU tensor sharing its memory where torch can."""
    if isinstance(images, torch.Tensor):
        return images
    arr = np.asarray(images)
    # torch takes neither read-only buffers (np.broadcast_to) nor negative
    # strides (a channel flip img[..., ::-1])
    if not (arr.flags.writeable and arr.flags.c_contiguous):
        arr = np.array(arr, order="C")
    return torch.from_numpy(arr)


def _module_forward(head: torch.nn.Module, x: torch.Tensor,
                    single_pass: bool = False) -> torch.Tensor:
    return head(x, single_pass=single_pass)
