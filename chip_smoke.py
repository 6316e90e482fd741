#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (headpose_tpu_torch) on one GPU.

Usage, from the root of the repository:  python3 chip_smoke.py

It drives the port's paths on the card: FaceDetector.detect (cuDNN
network + the postprocess kernel), FaceDetector.detect_fused (the fused
backbone and pose-head kernels + the postprocess kernel),
FaceDetector(precision="fast").detect (the split-bf16 segment backbone +
the pose-head and postprocess kernels), the SE-Transformer model (the
flagship's backbone with two seeded SE-Transformer heads) through the
SE-Transformer kernel in both head profiles, 'unified-best' (99 ensemble
members) under the survivors profile, the back-camera model
'unified-back-distilled' (input 256) at "highest" and "fast", the HTTP
serving runtime (PoseServer, DynamicBatcher, PoseClient), the offline
timeline (detect_stream, IoU tracking, process_frames) and
precision="turbo" and "max" (the split-bf16 segments cut around a
single-pass bf16 island whose blocks run through the island kernel,
csrc/dense_bf16.cu), the AOT artifacts of tools/aot.py replayed with no
model code, the edge pipeline's native postprocess, and the matmul probe
(tools/probe_matmul.py: the tiled bf16 GEMM of csrc/tiled_matmul.cu against
cuBLAS) with the speed-of-light accounting that reads it; it exits non-zero
on any failure (no phase catches its own failure).  It imports torch, numpy
and the port: never jax, nor the headpose_tpu package.  Every line it prints
is one JSON object, except the nvidia-smi line:

  device   the card (name, power limit), torch and CUDA versions;
  build    every kernel library built from csrc/ with nvcc, one nvcc per
           source, all started together; ptxas's registers and smem; the
           warp-level tensor-core (HMMA) instructions in the SASS of the
           split-bf16, SE-Transformer, island and tiled-GEMM libraries (the
           SE-Transformer and island ones must have some) and the
           warpgroup ones (HGMMA, wgmma) of the tiled-GEMM library, which
           must have some and no HMMA;
  head_routes  how runtime.fused.head_forward runs each served model's
           heads ("kernel" or "module", from the head's spec);
  kernels  per kernel: holds it against its plain PyTorch version on the
           card over a set of cases (postprocess bit for bit, from the
           raw network outputs: non-finite inputs,
           thresholds 0 and 1, max_faces 0, 1, 100 and 256, the back
           model's 256 anchors; backbone_forward at rtol 1e-4 / atol 1e-5;
           mlp_head at rtol = atol = 1e-5 (both shipped MLP-head
           models, ragged N, padded widths under every activation, the
           32- and 16-row tiles, 8 layers, unaligned rows); apply_fused at
           SPLIT_TOL
           (ops/kernels/backbone2.py) on the flagship and the back model,
           and at atol 5e-4 against the fp32 backbone_forward kernel, or for
           the back model its cuDNN taps;
           se_transformer at rtol 1e-4 / atol 1e-5; dense_block,
           the island kernel of a block alone, block by block on the same
           input at 1e-5 of the map's largest value, every block of both
           models at B=128 and a spec widening to 128 channels;
           dense_chain, the island kernel of a run of small-map blocks, on
           every chain of the "turbo" and "max" plans of both models at
           B=128, 1 and 3 and of the wide spec: each block through the
           chain's prefixes at 1e-5 of the map, the whole chain within one
           bf16 step, 2^-7, of the map) and times it
           (CUDA events) at the main path's shapes beside its plain version
           and a library yardstick, with each grid's device time
           (backbone_forward's 17 beside each one's byte floor;
           apply_fused's launches; se_transformer's by kernel;
           mlp_head's per head, for the flagship's heads and for
           best_detector()'s);
  kernel_matmul  tiled_matmul, the GEMM of the matmul probe (csrc/
           tiled_matmul.cu, the port of scripts/probe_mosaic_matmul.py's
           Pallas kernel): tools/probe_matmul.probe at 2048^3 and 4096^3 on
           the JAX probe's seed-0 bf16 operands, and every tile once at
           (M, N, K) = (768, 1280, 384), in one launch window (every
           tile's launches counted: 2 + iters each in the probe, 1 at the
           non-square shape); each of the five tiles against its plain
           version at the same tile (and in the probe against the plain
           float32 product) within 1e-5 of the largest |plain|; ms and
           TFLOP/s a tile beside the bound (2 n^3 / 989 TFLOP/s) and one
           cuBLAS call (torch.mm with a float32 result), and each tile's
           ratio to that call's TFLOP/s;
  parity   flagship_detector().detect on the 112 parity-corpus images
           against the reference detections (set agreement 1.0, pose p99
           and max < 0.1 deg) and on e2e_production.npz; every launch count
           is reset just before these detect calls and read just after;
  stress   the 108-image stress corpus per axis (set agreement 1.0, pose
           max < 0.1 deg), the reference's truncation order at the 100-face
           cap, and its uncapped >100-survivor sets at max_faces=256;
  best     best_detector() on 8 corpus images: the flagship's detections;
  fused    detect_fused through the same parity and stress gates, and
           best_detector().detect_fused against its own detect on 8 corpus
           images; every launch count is reset just before and read just
           after, and each of the three kernels must have launched; then
           the B=128 network stage of both paths, and best_detector()'s
           fused and cuDNN networks (CUDA events);
  fast     flagship_detector(precision="fast").detect through the same
           parity and stress gates, and best_detector(precision="fast")
           against its own "highest" detect on 8 corpus images; launch
           counts reset just before and read just after (apply_fused,
           mlp_head and postprocess must have launched); the
           B=128 network stage of the three networks and the "fast" detect
           wall time at B=1 and B=128 (best_detector()'s "fast" network
           too);
  se       the SE-Transformer model on the 112 parity-corpus frames
           through detect_fused at head_eval "map" and "survivors" and
           through the "fast" detect (map): set agreement 1.0 against the
           reference detections; poses against the same model's module
           path (detect) within rtol 1e-4 / atol 1e-4, and against the
           port's CPU path on 8 frames; "fast" poses within the 0.1 deg
           budget of its "highest" detect; launch counts reset just before
           and read just after each of the three, and se_transformer
           must have launched in each; detect_fused wall time at B=1 and
           B=128 in both profiles;
  unified_best  'unified-best' (head_eval "auto" = "survivors") through
           detect and detect_fused on 16 corpus frames: the flagship's
           detection sets, poses within 1e-3 deg of the port's CPU
           detector; detect wall time at B=1 and B=128;
  back     'unified-back-distilled' on the 112 corpus frames resized to
           256: the "fast" detect in its own launch window (apply_fused,
           mlp_head and postprocess must launch) against the
           "highest" one (one detection set, poses within 0.1 deg), each
           against the port's CPU detector on 16 frames; the B=128
           network stage and the "fast" detect wall times;
  flops_accounting  tools/flops_accounting.account: the flagship's
           dense-composed FLOPs a frame, the turbo phase's B=128 network
           medians of "fast" and "max" as GFLOP a dispatch and effective
           TFLOP/s, beside the kernel_matmul phase's cuBLAS and fastest-tile
           rates;
  timing   detect wall time at B=1 and B=128 (host clock around a
           synchronised call) and the per-stage split at B=128;
  serve    the serving path: PoseClient → PoseServer(max_batch=128) →
           DynamicBatcher → FaceDetector.detect, its kernels launched from
           the dispatcher thread → trim() → JSON, for the flagship at
           "highest" and best_detector() at "fast"; the 112 corpus frames
           through detect_many at concurrency 32 and as one detect_batch:
           every answer against the detector's direct detect (sets
           identical, boxes and scores within 1e-5, poses within 1e-3 deg),
           the flagship's against the corpus reference (set agreement 1.0,
           pose p99 < 0.1 deg), 224 frames served, no error, fewer
           dispatches than frames; launch counts reset just before and read
           just after: postprocess once a dispatch, and at "fast"
           apply_fused once and mlp_head twice; frames per
           dispatch, request latency p50/p99 (/v1/stats), frames/s; then
           the CLI (python -m headpose_tpu_torch.runtime.http --model
           unified-best-distilled --precision fast) in a process of its
           own, 16 frames against direct detect;
  turbo    flagship_detector(precision="turbo") and "max" through the
           parity corpus against JAX's certificate (turbo: set agreement
           1.0, pose p99 <= 0.43 deg; max: >= 108/112 images, pose p99 <=
           1.35 deg), the stress corpus per axis printed beside it; the
           launches of one detect by count and by kernel name, as the
           plans give them (segment_plan, island_chains; turbo: kernel #3
           over A, B, C 6-9, one island chain launch for blocks 10-15, #4
           twice, #1 once; max: blocks 0-5 an island launch each, one chain
           launch for 6-15, no #3); turbo_island=() bitwise "fast";
           best_detector() and the back model at both modes against their
           "highest"; the network stage at B=128 and B=1 and the detect
           walls of "fast", "turbo" and "max";
  stream   detect_stream over the corpus in batches of 16 (pinned staging,
           a side copy stream), each slab against that batch's detect
           (within 1e-6), in its own launch window; process_frames
           (detect_stream → IoU tracking → EMA) on the card against the
           same call on the port's CPU detector: valid identical, final
           track states identical, smoothed poses within 1e-3 deg and boxes
           within 1e-5; wall times;
  train    head training (the feature extractor, fit, the Keras golden
           trajectory, the trained head served, the 14 heads evaluated);
  detector_train  detector training at full width, each trainer's first
           10 steps also on the CPU on the same data, init and batch
           draws, every loss term within TRAIN_LOSS_RTOL and finite
           (calibration's, on images synthesized once and given to both,
           within twice its own noise floor: the CPU's gap when every
           input pixel moves one ulp up or down; its exact fp32 targets
           within TRAIN_LOSS_RTOL):
           (a) fit_detector(BLAZEFACE_FRONT) on 1024 seeded 128x128
           squares with keypoints, batch 64, until the mean loss of the
           last 20 steps is under half the first 20's; (b) front->back
           distillation: warmstart_params, distill_prefix (student tap 0,
           teacher tap -1; the frozen leaves bitwise) and distill_detector
           (feat_cell_eps 0.2) on 512 seeded blob frames; (c)
           calibrate_fast_params of the flagship's "turbo" island, batch
           64, lr 1e-5; steps/s on card and CPU, the card's peak memory;
           each trained detector joined to the flagship's heads and served
           on 16 corpus frames against the port's CPU detector (sets
           identical; at "highest" boxes and scores within 1e-5 and poses
           within 1e-3 deg, at "fast" poses within 0.02 deg), (a) and (b)
           at "highest" and "fast", (c) at "turbo" on the parity corpus by
           the turbo phase's rule (faces matched at IoU > 0.5, pose p99
           within 0.43 deg; a face one side alone reports passes when its
           score lies within the score noise of the threshold), each in its
           own launch window (#1 once; #3 once and #4
           twice at "fast"; the island chain once, #3, #4 twice and #1 at
           "turbo"); the corpus pose p99 of the calibrated and the
           uncalibrated "turbo" flagship, a reading;
  h5       the Keras-H5 graph compiler and loaders on the card: h5py's
           version (or null); the flagship fixture (tests/golden_torch) from
           its h5py-free twin through core.h5io._model_from_parts and, where
           h5py imports, from the .h5 file through read_model (the two
           ModelDefs equal, weights bitwise); FaceDetector.from_h5 through
           detect at "highest" and "fast" and detect_fused on the 112 corpus
           frames, each slab bitwise the flagship's on the same path, with
           its launches by name (#1 once; #3 once and #4 twice at "fast";
           #2 once and #4 twice under detect_fused); from_h5_compat (the
           GraphModel on the card): its 6 outputs against the flagship's
           reference_outputs on the 128 main-path frames (BACKBONE_TOL),
           detect against the flagship's (sets identical, scores within
           1e-5, poses within 1e-3 deg) and the corpus reference (pose p99
           < 0.1 deg), #1 once, "fast" refused; the SE-Transformer fixture
           head (se_transformer_from_h5) joined to the flagship's backbone
           and head96 through detect_fused "map" (#5 launched) against the
           same model on the port's CPU path (SE_POSE_TOL);
           validate_conversion of head96 on the card (max err <= 1e-5);
           join_and_save twice on the card (the H5 files where h5py
           imports, else the twin's ModelDef and head96 as a native
           directory; identical, and serving bitwise like the flagship);
           postprocess="xla" refused on the card (the plain chain is the
           CPU's); compat.blazeFaceDetector().detectFaces
           against flagship.detect_single on 16 frames; the sustained
           seconds per dispatch of the "fast" detect at B=128 (500
           dispatches over 8 staged buffers, a reading, not a claim);
  aot      the AOT artifacts (tools/aot.py: torch.export programs whose
           kernels are the torch.library ops of ops/kernels/library.py):
           the flagship at "highest", "fast", "turbo" and "max" (widths 1
           and 128), best_detector() and the SE-Transformer model at
           "fast" (128); each program's op nodes against the source
           detect's launches, its replay of the 128 main-path frames in
           its own launch window (every count as the source's) and by
           profiler kernel name (the port's kernels over frames staged on
           the card, a second call's in each of 3 windows, up to 13 while
           they differ, as the source's), its
           slab bit for bit the source's, again after a load in a fresh process that imports no model
           code (jax, headpose_tpu and h5py blocked), B=1 and B=7 through
           the "highest" artifact (B=7 padded to width 128: bitwise the
           source's rows of that batch, its own B=7 detect at the serve
           bounds, the network's gap between the two printed), the "fast" replay through the parity gate and the
           http CLI over that artifact (16 frames against direct detect);
           export and load seconds, program bytes, source and replay
           walls;
  edge     the native postprocess (runtime/edge.py, native/
           postprocess.cpp, g++ on the card's host) against kernel #1's
           slab on the flagship's outputs and the kernels phase's fuzz:
           boxes, keypoints and poses bitwise, scores within 2e-7; the
           versions of h5py and tensorflow; where tensorflow imports, the
           flagship's .tflite through EdgeDetector against detect;
  parallel the multi-device paths (headpose_tpu_torch.parallel.dryrun, its
           ranks spawned as processes; `parallel_plan` of the device
           count): (a) one NCCL rank on every card, rank r on cuda:r (the
           ranks' devices distinct, none host-staged).  On one card, mesh
           1x1, the flagship at "highest" and "fast" (and the survivors
           profile, detect_fused, best_detector()'s model and the back
           model) on the 128 main-path frames, each slab bitwise the
           unmeshed detector's and each launch window equal to its,
           fit(mesh=) on the train phase's rows within rtol 1e-5 of fit
           (bitwise or not, printed).  On N >= 2 cards every part at 128
           rows a rank (batch 128 N): the same six paths on an (N, 1)
           mesh against the unsharded detector of the whole batch on each
           rank (valid identical, poses and boxes within 1e-5, each
           window's launches the unsharded path's), the DynamicBatcher on
           rank 0 over the mesh detector, dp fit, block mode, resume and
           fit on the rows, the TP step on (N/2, 2) and (1, N); readings:
           the sharded, unsharded and own-rows walls of each path, the
           slab's all-gather (CUDA events), the warm TP steps, fit's
           epochs, the batcher's frames per dispatch, and `nvidia-smi
           topo -m`; (b) two gloo ranks on cuda:0, mesh 2x1, the same
           batch at 64 rows a rank against the unsharded detect (valid
           identical, poses and boxes within 1e-5), every rank's launch
           windows the unmeshed path's, the DynamicBatcher over the mesh
           detector (widths (2, 4, 8, 12), 3 frames at the serve bounds,
           rank 1 following); (c) the same two ranks: dp fit within rtol
           1e-4 of one rank, block mode within 1e-5 of per-epoch, a run
           saved and resumed against one that was not, the TP step (mesh
           1x2) of the mlp, se_transformer and ensemble families against
           the unsharded step (loss and updated parameters); the
           collectives that went through host memory; per-rank walls of
           the sharded and unsharded detect (readings: the ranks share
           one card);
  matmul_precision  the two strings JAX passes to
           jax.default_matmul_precision (PR 16): (a) "high", the "fast"
           network: the flagship, best_detector(), the back model and the
           SE-Transformer model at "high", each slab (the 128 main-path
           frames) bitwise its "fast" detector's in its own launch window
           (#3 once, #4 twice or #5 twice, #1 once: fast's counts), the
           flagship through the parity and stress gates and its detect
           walls; (b) from_h5_compat of the flagship fixture at "highest",
           "high" and "default", #1 alone in each window, "high" bitwise
           "highest"; (c) the flagship at "default" (every conv and product
           of bf16-rounded operands): #1 alone in its window, the parity
           corpus by certify_parity (at least MP_DEFAULT_AGREE_MIN images,
           pose p99 <= MP_DEFAULT_POSE_P99_DEG) and the stress corpus
           reported; each single-pass stage (the resize of the production
           frame, the stem, every block's depthwise and pointwise, the SSD
           heads, each head layer) on the card against the port's CPU on
           the CPU's input of that stage within MP_STAGE_FRAC of the
           output's largest value (the resize within MP_RESIZE_FRAC); the
           card against the CPU detector on 16 frames, from_h5_compat's
           "default" against the native one, the detect walls beside
           "highest"'s (readings); (d) both flagships exported at width
           128: op nodes the source's launches, the replay's window the
           source's, its slab bitwise; (e) fit_detector(BLAZEFACE_FRONT)
           on seeded squares: at "high" MP_HIGH_STEPS steps bitwise
           "highest" (cuDNN deterministic for both), at "default"
           MP_TRAIN_STEPS steps whose first 10 loss terms lie within twice
           the CPU's one-ulp noise floor (the CPU again from the init moved
           one ulp up and down) or TRAIN_LOSS_RTOL, and whose loss falls;
  total    the script's seconds;
  then the {"kernels": [...]} summary (launches from the fused phase;
  apply_fused's from the fast phase, and its back window's beside them;
  se_transformer's from the se phase's map window; dense_chain's
  from the turbo phase's "turbo" window and dense_block's from its "max"
  window, the other window beside each;
  the serve phase's beside them, the detector_train phase's windows
  of #1, #3, #4 and dense_chain, the aot phase's replay windows, the
  parallel phase's windows of #1, #3 and #4, and the matmul_precision
  phase's windows; tiled_matmul's from the kernel_matmul phase's probe
  window), the nvidia-smi line, and last
  {"ok": true, "device": {...}}.
"""
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from headpose_tpu_torch.ops.kernels import library

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
H100_BF16_FLOPS = 989e12     # bf16 on the tensor cores, dense
H100_TF32_FLOPS = 495e12     # TF32 on the tensor cores, dense
PARITY_BUDGET_DEG = 0.1
IOU_MATCH = 0.5
FIELDS = ("boxes", "keypoints", "scores", "poses", "valid")
BACKBONE_TOL = dict(rtol=1e-4, atol=1e-5)   # tests/test_pallas.py:83-86
HEAD_TOL = dict(rtol=1e-5, atol=1e-5)       # degrees, another sum order
# apply_fused against the fp32 backbone: tests/test_pallas.py:111-114
SPLIT_VS_FP32_TOL = dict(rtol=0.0, atol=5e-4)
SE_TOL = dict(rtol=1e-4, atol=1e-5)         # tests/test_pallas.py:52
SE_POSE_TOL = dict(rtol=1e-4, atol=1e-4)    # kernel path vs module path
UNIFIED_BEST_POSE_TOL_DEG = 1e-3            # card vs the port's CPU path


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_cards() -> list:
    """Each card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()


def nvidia_smi() -> str:
    return nvidia_smi_cards()[0]


# ------------------------------------------------------------ fuzz inputs
def fuzz_inputs(b, seed, loc_std=8.0, bias=0.0, quantize=False,
                nonfinite=False):
    """The fuzz inputs of the repository's postprocess tests (numpy, from a
    seed): random logits/loc/pose maps, optionally exact score ties and
    NaN / +-inf logits and non-finite loc."""
    rng = np.random.default_rng(seed)
    logits = (rng.normal(0.0, 2.0, (b, 896)) + bias).astype(np.float32)
    if quantize:
        logits = np.round(logits).astype(np.float32)
    loc = rng.normal(0.0, loc_std, (b, 896, 16)).astype(np.float32)
    pf = rng.normal(0, 0.5, (b, 16, 16, 3)).astype(np.float32)
    pb = rng.normal(0, 0.5, (b, 8, 8, 3)).astype(np.float32)
    if nonfinite:
        logits[0, 5] = np.nan
        logits[-1, 7] = -np.inf
        logits[0, 700] = np.inf
        logits[-1, 9] = 1e30                 # finite, above the largest kept
        loc[0, 3, :] = np.nan
        loc[-1, 11, 2] = np.inf
        loc[0, 12, 5] = -np.inf
    return logits, loc, pf, pb


FUZZ = [
    dict(name="random_b128", b=128, thr=0.4, iou=0.3, mf=100, seed=1),
    dict(name="odd_batch", b=3, thr=0.4, iou=0.3, mf=100, seed=3),
    dict(name="all_empty", b=3, thr=0.99, iou=0.3, mf=16, seed=5, bias=-8.0),
    dict(name="threshold_0", b=1, thr=0.0, iou=0.3, mf=100, seed=6),
    dict(name="threshold_1", b=3, thr=1.0, iou=0.3, mf=16, seed=2),
    dict(name="heavy_nms", b=3, thr=0.4, iou=0.01, mf=32, seed=8),
    dict(name="all_admitted_b128", b=128, thr=0.0, iou=0.01, mf=100,
         seed=99),
    dict(name="clusters_b128", b=128, thr=0.4, iou=0.3, mf=16, seed=9,
         loc_std=0.5),
    dict(name="ties_b128", b=128, thr=0.4, iou=0.3, mf=32, seed=11,
         quantize=True),
    dict(name="ties_clustered", b=3, thr=0.0, iou=0.01, mf=100, seed=12,
         quantize=True, loc_std=0.5),
    dict(name="nonfinite", b=3, thr=0.4, iou=0.3, mf=16, seed=13,
         nonfinite=True),
    dict(name="nonfinite_slab256", b=1, thr=0.0, iou=0.3, mf=256, seed=14,
         nonfinite=True),
    dict(name="max_faces_0", b=3, thr=0.4, iou=0.3, mf=0, seed=3),
    dict(name="max_faces_1", b=3, thr=0.4, iou=0.3, mf=1, seed=3),
    dict(name="back256_b8", b=8, thr=0.4, iou=0.3, mf=100, seed=21,
         input_size=256),
    dict(name="back256_nonfinite_threshold_0", b=3, thr=0.0, iou=0.3, mf=256,
         seed=22, input_size=256, nonfinite=True),
]


def max_abs_err(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max())
               if a[k].numel() else 0.0 for k in FIELDS)


def assert_bitwise(got: dict, want: dict, what: str) -> None:
    for k in FIELDS:
        if got[k].shape != want[k].shape or not torch.equal(got[k], want[k]):
            raise AssertionError(f"{what}: field {k} differs from the twin "
                                 f"(max abs err {max_abs_err(got, want)})")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events, warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def close(got: torch.Tensor, want: torch.Tensor, rtol: float,
          atol: float) -> tuple[float, float]:
    """(max abs err, max of |got - want| / (atol + rtol |want|)): the second
    is <= 1 where torch.testing.assert_close would pass."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = (got - want).abs()
    ratio = err / (atol + rtol * want.abs())
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("non-finite kernel output")
    return float(err.max()), float(ratio.max())


PROFILE_TRIES = 3


def cuda_events(fn, reps: int) -> list:
    """The CUDA kernel events of reps warm fn() calls (torch.profiler).  The
    profiler now and then records no kernel at all in a window where the
    wrappers counted their launches (PERF.md §7): such a window is profiled
    again, up to PROFILE_TRIES times.  Every fn given here launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        if ev:
            return ev
    raise AssertionError(f"the profiler recorded no CUDA kernel in "
                         f"{PROFILE_TRIES} windows")


def grid_ms(fn, reps: int) -> dict:
    """Device time per kernel name of one fn() (torch.profiler over reps
    warm calls, mean per call), in ms."""
    out: dict[str, float] = {}
    for e in cuda_events(fn, reps):
        name = e.name.replace("(anonymous namespace)::", "").split(
            "(")[0][:60]
        out[name] = out.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) / reps / 1e3
    return out


def grids_in_order(fn, reps: int, per_call: int) -> list:
    """Device time of each of the per_call kernel launches of one fn(), in
    launch order (torch.profiler over reps warm calls, mean per launch over
    the calls whose launches it recorded whole), in ms."""
    ev = sorted(cuda_events(fn, reps), key=lambda e: e.time_range.start)
    calls = [ev[i:i + per_call] for i in range(len(ev) - per_call, -1,
                                               -per_call)]
    names = [e.name for e in calls[0]] if calls else []
    whole = [c for c in calls if [e.name for e in c] == names]
    if len(names) != per_call or not whole:
        raise AssertionError(f"the profiler recorded no whole call of "
                             f"{per_call} launches ({len(ev)} events)")
    return [sum(c[i].time_range.end - c[i].time_range.start for c in whole)
            / len(whole) / 1e3 for i in range(per_call)]


def sass_count(lib, opcode: str) -> int:
    """Instructions of `opcode` in a built library's SASS (cuobjdump)."""
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME

    tool = shutil.which("cuobjdump") or os.path.join(CUDA_HOME or "", "bin",
                                                     "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib.path()], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return sum(opcode in line for line in sass.splitlines())


def median_ms(fn, reps: int) -> float:
    """Median device time of one fn() over reps calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------- phases
def phase_build() -> dict:
    """Every kernel library, one nvcc per source, all started together."""
    from headpose_tpu_torch.ops.kernels import (backbone, backbone2,
                                                dense_bf16, head_mlp,
                                                postprocess, se_attention,
                                                tiled_matmul)

    mods = {"postprocess": postprocess, "backbone_forward": backbone,
            "mlp_head": head_mlp, "apply_fused": backbone2,
            "se_transformer": se_attention,
            "dense_block": dense_bf16, "tiled_matmul": tiled_matmul}

    def build(mod):
        t0 = time.perf_counter()
        mod.LIBRARY.load()                 # nvcc from csrc/ (first use)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(mods)) as pool:
        seconds = dict(zip(mods, pool.map(build, mods.values())))
    built = {name: {"build_s": seconds[name],
                    "ptxas": [ln.strip() for ln in
                              mod.LIBRARY.build_log.splitlines()
                              if "registers" in ln or "smem" in ln]}
             for name, mod in mods.items()}
    # the tensor-core kernels' mma instructions in their SASS: warp-level
    # HMMA (mma.sync), and tiled_matmul's warpgroup HGMMA (wgmma), which
    # must have replaced every HMMA there
    for name in ("apply_fused", "se_transformer", "dense_block",
                 "tiled_matmul"):
        built[name]["sass_hmma"] = sass_count(mods[name].LIBRARY, "HMMA")
    built["tiled_matmul"]["sass_hgmma"] = sass_count(
        mods["tiled_matmul"].LIBRARY, "HGMMA")
    for name in ("se_transformer", "dense_block"):
        if built[name]["sass_hmma"] == 0:
            raise AssertionError(f"{name}'s library has no tensor-core "
                                 "instruction (HMMA) in its SASS")
    tm = built["tiled_matmul"]
    if tm["sass_hgmma"] == 0 or tm["sass_hmma"] != 0:
        raise AssertionError(f"tiled_matmul's SASS has {tm['sass_hgmma']} "
                             f"HGMMA and {tm['sass_hmma']} HMMA: wgmma only "
                             "was expected")
    emit({"phase": "build", **built})
    return built


def launches_per_call(fn, reps: int = 10) -> float:
    """CUDA kernels launched by one fn() (torch.profiler over reps warm
    calls): the most of PROFILE_TRIES windows.  The profiler drops an event
    now and then, once every second kernel of a window (PERF.md §7), and
    never adds one, so a launch that really is missing stays missing."""
    return max(len(cuda_events(fn, reps)) / reps
               for _ in range(PROFILE_TRIES))


def phase_kernels(dev, anchors, back_anchors, main_inputs, built):
    """postprocess: the kernel against the plain chain on the card, bit
    for bit."""
    from headpose_tpu_torch.ops import detection as det
    from headpose_tpu_torch.ops.kernels import postprocess as kern

    build_s = built["postprocess"]["build_s"]
    ptxas = built["postprocess"]["ptxas"]
    kw = dict(score_threshold=0.4, iou_threshold=0.3, max_faces=100)
    cases = []
    for case in FUZZ:
        case = dict(case)
        name, thr, iou, mf = (case.pop(k) for k in ("name", "thr", "iou",
                                                    "mf"))
        size = case.pop("input_size", 128)
        arrays = fuzz_inputs(**case)
        cuda_in = [torch.from_numpy(x).to(dev) for x in arrays]
        ckw = dict(score_threshold=thr, iou_threshold=iou, max_faces=mf,
                   input_size=size)
        anc = back_anchors if size == 256 else anchors
        got = kern.postprocess_kernel(*cuda_in, anc, **ckw)
        want = det.postprocess(*cuda_in, anc, **ckw)
        torch.cuda.synchronize()
        assert_bitwise(got, want, name)
        cases.append({"case": name, "b": case["b"], "max_faces": mf,
                      "input_size": size,
                      "survivors": int(want["valid"].sum()),
                      "max_abs_err": max_abs_err(got, want)})
    # the main path's own inputs: flagship outputs for 128 frames
    got = kern.postprocess_kernel(*main_inputs, anchors, **kw)
    want = det.postprocess(*main_inputs, anchors, **kw)
    torch.cuda.synchronize()
    assert_bitwise(got, want, "main_path_b128")
    survivors = int(want["valid"].sum())
    cases.append({"case": "main_path_b128", "b": 128, "max_faces": 100,
                  "survivors": survivors,
                  "max_abs_err": max_abs_err(got, want)})
    # the CPU chain (held to JAX bit for bit by the CPU tests): scores may
    # differ by an ulp of sigmoid between the two devices
    cpu = det.postprocess(*(t.cpu() for t in main_inputs), anchors.cpu(),
                          **kw)
    got = kern.postprocess_kernel(*main_inputs, anchors, **kw)
    for k in FIELDS:
        g, w = got[k].cpu(), cpu[k]
        if k == "scores":
            if float((g - w).abs().max()) > 1e-6:
                raise AssertionError("main_path_b128: scores vs CPU chain")
        elif not torch.equal(g, w):
            raise AssertionError(f"main_path_b128: {k} differs from the "
                                 "CPU chain")

    # timing at the main path's shapes, B=128, F=100: the wrapper (host
    # checks + one launch), the kernel alone (device time), the worst case
    # (all 896 anchors admitted, suppression defeated: 100 trips an image)
    B, F = 128, 100
    worst = [torch.from_numpy(x).to(dev) for x in fuzz_inputs(B, 99)]
    wkw = dict(score_threshold=0.0, iou_threshold=0.01, max_faces=F)

    # postprocess_kernel is the drop-in wrapper (it also splits the slab: one
    # comparison kernel for `valid`); postprocess_slab is what FaceDetector
    # calls
    def main_call():
        return kern.postprocess_kernel(*main_inputs, anchors, **kw)

    def slab_call():
        return kern.postprocess_slab(*main_inputs, anchors, **kw)

    def worst_call():
        return kern.postprocess_slab(*worst, anchors, **wkw)

    mine = {"ms": cuda_ms(main_call, 200),
            "slab_ms": cuda_ms(slab_call, 200),
            "kernel_only_ms": sum(grid_ms(slab_call, 20).values()),
            "worst_case_ms": cuda_ms(worst_call, 50),
            "kernel_only_worst_case_ms": sum(grid_ms(worst_call, 10).values()),
            "launches_per_call": launches_per_call(slab_call)}
    plain_ms = cuda_ms(lambda: det.postprocess(*main_inputs, anchors, **kw),
                       3)
    bytes_moved = (B * 896 * 4 + B * 896 * 16 * 4 + B * 320 * 3 * 4
                   + 896 * 4 * 4                     # inputs, read once
                   + B * F * 21 * 4)                 # the slab, written once
    # sanitize and threshold (3), the box decode (12) and area (5) of every
    # anchor; per survivor its slot (16 decodes of 2, a sigmoid of 3) and a
    # trip: an argmax and an IoU test against each anchor (13 at most)
    operations = (B * 896 * (3 + 12 + 5)
                  + survivors * (16 * 2 + 3 + 896 * (1 + 13)))
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = operations / H100_FP32_FLOPS * 1e3
    entry = {
        "name": "postprocess", "route": "cuda",
        "source": "headpose_tpu_torch/csrc/postprocess.cu",
        "replaces": "headpose_tpu/ops/pallas/postprocess.py:67",
        "launches": None,                     # filled by the parity phase
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "tolerance": 0.0,
        "ms": mine["ms"], "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,      # no PyTorch call computes greedy NMS
        "slab_ms": mine["slab_ms"],
        "kernel_only_ms": mine["kernel_only_ms"],
        "kernel_only_worst_case_ms": mine["kernel_only_worst_case_ms"],
        "worst_case_ms": mine["worst_case_ms"],
        "launches_per_call": mine["launches_per_call"],
        "bytes": bytes_moved, "operations": operations,
        "shape": {"B": B, "F": F, "survivors": survivors},
        "build_s": build_s, "ptxas": ptxas,
    }
    emit({"phase": "kernels", "kernel": "postprocess", "cases": cases,
          **mine, "plain_ms": plain_ms,
          "bound_ms": entry["bound_ms"], "build_s": build_s,
          "ptxas": ptxas})
    if mine["launches_per_call"] != 1.0:
        raise AssertionError(f"a postprocess call launched "
                             f"{mine['launches_per_call']} kernels, not 1")
    return entry


NARROW = dict(input_size=32, stem_features=8, block_channels=(8, 12, 16, 16, 20),
              downsample_blocks=(0, 1, 3), tap88_block=2)


def random_init(net, seed):
    """Glorot-uniform weights and small normal biases, made with numpy."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in net.parameters():
            if p.ndim == 1:
                v = rng.normal(0, 0.05, tuple(p.shape))
            else:
                fan = p.shape[1] * (p.shape[2] * p.shape[3] if p.ndim == 4
                                    else 1)
                lim = np.sqrt(6.0 / (fan + p.shape[0]))
                v = rng.uniform(-lim, lim, tuple(p.shape))
            p.copy_(torch.from_numpy(v.astype(np.float32)))
    return net


def backbone_work(spec, B):
    """(operations, bytes) that the backbone must do and move for B images:
    every multiply-add as 2, the biases, skip adds and ReLUs as 1; the
    frames read once and the two taps written once (weights once)."""
    S = spec.input_size
    h, cin = S // 2, spec.stem_features
    ops = 2 * h * h * 75 * cin + 2 * h * h * cin
    params = 75 * cin + cin
    for i, cout in enumerate(spec.block_channels):
        h //= 2 if i in spec.downsample_blocks else 1
        ops += (2 * h * h * 9 * cin + h * h * cin
                + 2 * h * h * cin * cout + 3 * h * h * cout)
        params += 10 * cin + cin * cout + cout
        cin = cout
    c88 = spec.block_channels[spec.tap88_block]
    out = (S // 8) ** 2 * c88 + (S // 16) ** 2 * spec.block_channels[-1]
    return B * ops, 4 * (B * (S * S * 3 + out) + params)


def backbone_grids(spec, B):
    """The 17 grids of backbone_forward in launch order: each one's map
    sizes and the bytes a layer-per-launch design must move for it at B
    images (its input map read once, its output map written once, its
    weights once) over 3.35 TB/s: the per-layer byte floor."""
    S = spec.input_size
    layers = [("stem", S, 3, spec.stem_features, 2, 75 * spec.stem_features
               + spec.stem_features)]
    h, cin = S // 2, spec.stem_features
    for i, cout in enumerate(spec.block_channels):
        st = 2 if i in spec.downsample_blocks else 1
        layers.append((f"block{i}", h, cin, cout, st,
                       10 * cin + cin * cout + cout))
        h, cin = h // st, cout
    out = []
    for name, hi, ci, co, st, params in layers:
        ho = hi // st
        nbytes = 4 * (B * (hi * hi * ci + ho * ho * co) + params)
        out.append({"grid": name, "in": [hi, hi, ci], "out": [ho, ho, co],
                    "bytes": nbytes,
                    "floor_ms": nbytes / H100_BYTES_PER_S * 1e3})
    return out


def cudnn_taps(net, x):
    """The port's cuDNN BlazeFaceNet from the frames to the taps (a
    sequence of calls: stem, 16 blocks, two NHWC copies)."""
    from headpose_tpu_torch.models.blazeface import _pad_same

    y = torch.relu(net.stem(_pad_same(x.permute(0, 3, 1, 2), 5, 2)))
    for i, block in enumerate(net.blocks):
        y = block(y)
        if i == net.spec.tap88_block:
            f88 = y
    return (f88.permute(0, 2, 3, 1).contiguous(),
            y.permute(0, 2, 3, 1).contiguous())


def bound(ops, nbytes):
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = ops / H100_FP32_FLOPS * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def phase_kernel_backbone(dev, flagship, frames128, built):
    """backbone_forward: the kernels against the plain version on the card,
    flagship at B in {1, 3, 128} on corpus frames and a narrow random-init
    spec at B=4; then timed at B=128."""
    from headpose_tpu_torch.models import BlazeFace, BlazeFaceNet
    from headpose_tpu_torch.ops.kernels import backbone as kbb

    net = flagship.net.backbone
    narrow = random_init(BlazeFaceNet(BlazeFace(**NARROW), device=dev), 5)
    xn = torch.from_numpy(np.random.default_rng(0).uniform(
        -1, 1, (4, 32, 32, 3)).astype(np.float32)).to(dev)
    cases, worst = [], (0.0, 0.0)
    with torch.inference_mode():
        for name, m, x in (("flagship_b1", net, frames128[:1]),
                           ("flagship_b3", net, frames128[:3]),
                           ("flagship_b128", net, frames128),
                           ("narrow_b4", narrow, xn)):
            got = kbb.backbone_forward_cuda(m, x)
            want = kbb.backbone_forward_plain(m, x)
            torch.cuda.synchronize()
            errs = [close(g, w, **BACKBONE_TOL) for g, w in zip(got, want)]
            err = max(e for e, _ in errs)
            ratio = max(r for _, r in errs)
            cases.append({"case": name, "b": int(x.shape[0]),
                          "max_abs_err": err, "tolerance_ratio": ratio})
            worst = (max(worst[0], err), max(worst[1], ratio))
        # the library yardstick agrees too (another sum order: report only)
        lib88, lib96 = cudnn_taps(net, frames128)
        got88, got96 = kbb.backbone_forward_cuda(net, frames128)
        vs_library = max(float((lib88 - got88).abs().max()),
                         float((lib96 - got96).abs().max()))
        ms = cuda_ms(lambda: kbb.backbone_forward_cuda(net, frames128), 50)
        plain_ms = cuda_ms(lambda: kbb.backbone_forward_plain(net,
                                                              frames128), 3)
        library_ms = cuda_ms(lambda: cudnn_taps(net, frames128), 50)
        per_grid = grids_in_order(
            lambda: kbb.backbone_forward_cuda(net, frames128), 10,
            1 + len(net.spec.block_channels))
    B = int(frames128.shape[0])
    ops, nbytes = backbone_work(net.spec, B)
    bound_ms, bound_by = bound(ops, nbytes)
    grids = backbone_grids(net.spec, B)
    for row, t in zip(grids, per_grid):
        row["ms"] = t
    layer_floor_ms = sum(row["floor_ms"] for row in grids)
    emit({"phase": "kernels", "kernel": "backbone_forward", "cases": cases,
          "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
          "bound_ms": bound_ms, "layer_byte_floor_ms": layer_floor_ms,
          "grid_ms": grids, "max_abs_err_vs_library": vs_library})
    if worst[1] > 1.0:
        raise AssertionError(f"backbone_forward disagrees with its plain "
                             f"version beyond {BACKBONE_TOL}: {cases}")
    return {
        "name": "backbone_forward", "route": "cuda",
        "source": "headpose_tpu_torch/csrc/backbone.cu",
        "replaces": "headpose_tpu/ops/pallas/backbone.py:117",
        "launches": None,                     # filled by the fused phase
        "max_abs_err": worst[0], "tolerance": BACKBONE_TOL,
        "tolerance_ratio": worst[1],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "library": "sequence of calls, not one: the port's cuDNN "
                   "BlazeFaceNet stem + 16 blocks to the two NHWC taps",
        "grids_per_launch": 1 + len(net.spec.block_channels),
        "grid_ms": {row["grid"]: row["ms"] for row in grids},
        "layer_byte_floor_ms": layer_floor_ms,
        "operations": ops, "bytes": nbytes,
        "shape": {"B": B, "S": net.spec.input_size},
        "build_s": built["backbone_forward"]["build_s"],
        "ptxas": built["backbone_forward"]["ptxas"],
    }


def head_work(heads, rows):
    """(operations, bytes) of pose heads over their rows: every
    multiply-add as 2, bias and activation as 1 each; rows read once, the
    outputs written once, weights once."""
    ops = nbytes = 0
    for net, n in zip(heads, rows):
        cin = net.spec.in_features
        nbytes += 4 * n * (cin + net.spec.layers[-1][0])
        for cout, _ in net.spec.layers:
            ops += n * (2 * cin * cout + 2 * cout)
            nbytes += 4 * (cin * cout + cout)
            cin = cout
    return ops, nbytes


# the head kernel's edges: (name, layers, C, N) of random heads; ragged N on
# unified-best-distilled's head88 and the 88 -> 37 -> 5 -> 3 widths under
# every activation are added in phase_kernel_head
HEAD_EDGES = [
    ("tile32_512x640", ((640, "relu"), (3, "linear")), 512, 100),
    ("tile16_896x896", ((896, "gelu"), (8, "tanh"), (3, "linear")), 896, 70),
    ("eight_layers", ((40, "elu"), (24, "swish"), (13, "sigmoid"),
                      (30, "softplus"), (9, "selu"), (17, "leaky_relu"),
                      (6, "softsign"), (3, "linear")), 96, 130),
    ("c37", ((16, "tanh"), (3, "linear")), 37, 65),
]
HEAD_RAGGED = (1, 15, 63, 64, 65, 513)


def time_heads(heads, rows):
    """The pair of heads over their rows: the wrapper calls (CUDA events),
    each launch's device time (profiler), the plain version, the library
    yardstick (the modules), the bound and the kernels per call."""
    from headpose_tpu_torch.ops.kernels import head_mlp as khead

    def pair():
        return [khead.mlp_head_forward_cuda(h, x) for h, x in zip(heads, rows)]

    before = library.launches()["mlp_head"]
    pair()
    wrapper_launches = library.launches()["mlp_head"] - before
    per_launch = grids_in_order(pair, 20, len(heads))
    ops, nbytes = head_work(heads, [x.shape[0] for x in rows])
    bound_ms, bound_by = bound(ops, nbytes)
    return {"ms": cuda_ms(pair, 200),
            "kernel_ms": sum(per_launch),
            "kernel_ms_per_head": dict(zip(("head88", "head96"), per_launch)),
            "plain_ms": cuda_ms(lambda: [khead.mlp_head_forward_plain(h, x)
                                         for h, x in zip(heads, rows)], 20),
            "library_ms": cuda_ms(lambda: [h(x) for h, x in zip(heads, rows)],
                                  200),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "operations": ops, "bytes": nbytes,
            "wrapper_launches_per_call": wrapper_launches,
            "launches_per_call": launches_per_call(pair),
            "shape": {"rows88": int(rows[0].shape[0]),
                      "rows96": int(rows[1].shape[0]),
                      "head88": [heads[0].spec.in_features,
                                 *(w for w, _ in heads[0].spec.layers)],
                      "head96": [heads[1].spec.in_features,
                                 *(w for w, _ in heads[1].spec.layers)]}}


def phase_kernel_head(dev, flagship, best, frames128, built):
    """mlp_head: the kernel against the plain version on the card:
    both shipped models' heads on the flagship's B=128 feature maps; ragged
    N (HEAD_RAGGED) on best's head88; every activation id on a 16-wide
    hidden layer and on the padded widths 88 -> 37 -> 5 -> 3; the 32- and
    16-row tiles of wide layers, 8 layers, C = 37 and rows that do not start
    16-byte aligned.  Then timed at B=128 for the flagship's heads and for
    best_detector()'s (unified-best-distilled's)."""
    from headpose_tpu_torch.core.activations import ACTIVATION_IDS
    from headpose_tpu_torch.models.heads import MLPHead, MLPHeadNet
    from headpose_tpu_torch.ops.kernels import head_mlp as khead

    with torch.inference_mode():
        out = flagship.net(frames128)
    rows = {88: out["feat88"].reshape(-1, 88).contiguous(),
            96: out["feat96"].reshape(-1, 96).contiguous()}
    rng = np.random.default_rng(7)

    def rand_rows(n, c, offset=0):
        flat = torch.from_numpy(rng.normal(0, 2, n * c + offset).astype(
            np.float32)).to(dev)
        return flat[offset:].view(n, c)

    def rand_head(c, layers, seed):
        return random_init(MLPHeadNet(MLPHead(c, layers), device=dev), seed)

    cases = [(f"{model}.{h}", getattr(d.net, h), rows[k])
             for model, d in (("flagship", flagship), ("best", best))
             for h, k in (("head88", 88), ("head96", 96))]
    cases += [(f"best.head88_n{n}", best.net.head88, rows[88][:n])
              for n in HEAD_RAGGED]
    for i, act in enumerate(ACTIVATION_IDS):
        n = 513 + 32 * i                 # ragged: never a multiple of 32
        cases.append((f"act_{act}_n{n}",
                      rand_head(88, ((16, act), (3, "linear")), 10 + i),
                      rand_rows(n, 88)))
        cases.append((f"padded_{act}_n{n}",
                      rand_head(88, ((37, act), (5, act), (3, "linear")),
                                30 + i), rand_rows(n, 88)))
    for i, (name, layers, c, n) in enumerate(HEAD_EDGES):
        cases.append((name, rand_head(c, layers, 50 + i), rand_rows(n, c)))
    cases.append(("unaligned_rows", flagship.net.head88,
                  rand_rows(65, 88, offset=1)))
    report, worst = [], (0.0, 0.0)
    with torch.inference_mode():
        for name, net, x in cases:
            got = khead.mlp_head_forward_cuda(net, x)
            want = khead.mlp_head_forward_plain(net, x)
            torch.cuda.synchronize()
            err, ratio = close(got, want, **HEAD_TOL)
            report.append({"case": name, "n": int(x.shape[0]),
                           "max_abs_err": err, "tolerance_ratio": ratio})
            worst = (max(worst[0], err), max(worst[1], ratio))
        both = (rows[88], rows[96])
        models = {name: time_heads((d.net.head88, d.net.head96), both)
                  for name, d in (("flagship", flagship), ("best", best))}
    emit({"phase": "kernels", "kernel": "mlp_head", "cases": report,
          "models": models})
    if worst[1] > 1.0:
        raise AssertionError(f"mlp_head_forward disagrees with its plain "
                             f"version beyond {HEAD_TOL}: {report}")
    for name, m in models.items():
        # the profiler's count is a mean over 10 calls, and it drops an
        # event now and then
        if (m["wrapper_launches_per_call"] != 2
                or round(m["launches_per_call"]) != 2):
            raise AssertionError(f"{name}'s two heads launched "
                                 f"{m['wrapper_launches_per_call']} kernels "
                                 f"(CUDA kernels per call: "
                                 f"{m['launches_per_call']}), not 2")
    main = models["flagship"]
    return {
        "name": "mlp_head", "route": "cuda",
        "source": "headpose_tpu_torch/csrc/head_mlp.cu",
        "replaces": "headpose_tpu/ops/pallas/head_mlp.py:29",
        "launches": None,                     # filled by the fused phase
        "max_abs_err": worst[0], "tolerance": HEAD_TOL,
        "tolerance_ratio": worst[1],
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library": "sequence of calls, not one: the MLPHeadNet modules' "
                   "Linear + activation chain",
        "timed": "head88 over B*256 rows + head96 over B*64 rows, B=128, "
                 "the flagship's maps; per model under 'models'",
        "kernel_ms": main["kernel_ms"],
        "operations": main["operations"], "bytes": main["bytes"],
        "shape": main["shape"], "models": models,
        "build_s": built["mlp_head"]["build_s"],
        "ptxas": built["mlp_head"]["ptxas"],
    }


def box_iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0.0) * max(y2 - y1, 0.0)
    ua = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
    ub = max(b[2] - b[0], 0) * max(b[3] - b[1], 0)
    return inter / (ua + ub - inter) if ua + ub - inter > 0 else 0.0


def match_image(ref, ours):
    """Greedy one-to-one match of reference detections to ours by IoU > 0.5
    (the rule of the repository's certification scripts)."""
    used, pairs = set(), []
    for ri in range(len(ref["scores"])):
        best, best_iou = None, IOU_MATCH
        for oi in range(len(ours.scores)):
            if oi in used:
                continue
            iou = box_iou(ref["boxes"][ri], ours.boxes[oi])
            if iou > best_iou:
                best, best_iou = oi, iou
        if best is not None:
            used.add(best)
            pairs.append((ri, best))
    full = (len(pairs) == len(ref["scores"])
            and len(ours.scores) == len(ref["scores"]))
    return pairs, full


def dist(errs) -> dict:
    errs = np.asarray(errs, np.float64)
    return {"n": int(len(errs)), "p50": float(np.percentile(errs, 50)),
            "p99": float(np.percentile(errs, 99)), "max": float(errs.max())}


PRODUCTION_TOL = {"scores": 1e-4, "boxes": 1e-4, "poses": 5e-4}


def check_parity(detect, corpus, production, phase, production_tol=None):
    """The parity corpus and e2e_production.npz through `detect`, the
    latter at `production_tol` (default PRODUCTION_TOL, the fp32 path's)."""
    report = corpus_parity(detect(corpus["imgs"]).trim(), corpus, phase)
    res = detect(production["img"]).trim()[0]

    # e2e_production.npz at the tolerances of tests/test_detection.py:280-282
    if len(res) != len(production["scores"]):
        raise AssertionError("e2e_production: detection count differs")
    for k, tol in (production_tol or PRODUCTION_TOL).items():
        err = float(np.abs(getattr(res, k) - production[k]).max())
        report[f"e2e_production_{k}_err"] = err
        if not err <= tol:
            raise AssertionError(f"e2e_production: {k} err {err} > {tol}")
    report["e2e_production_detections"] = len(res)
    return report


def corpus_parity(per, corpus, phase):
    """Ragged Results of the parity corpus against its reference detections:
    set agreement 1.0, pose p99 and max within the budget."""
    agree, pose, box, score = 0, [], [], []
    for i, ours in enumerate(per):
        c = int(corpus["counts"][i])
        ref = {k: corpus[k][i, :c] for k in ("boxes", "scores", "poses")}
        pairs, full = match_image(ref, ours)
        agree += full
        for ri, oi in pairs:
            pose.append(np.abs(ref["poses"][ri] - ours.poses[oi]).max())
            box.append(np.abs(ref["boxes"][ri] - ours.boxes[oi]).max())
            score.append(abs(float(ref["scores"][ri]) - float(ours.scores[oi])))
    n = len(per)
    report = {"phase": phase, "images": n,
              "reference_detections": int(corpus["counts"].sum()),
              "set_agreement": agree / n, "pose_deg": dist(pose),
              "box_norm": dist(box), "score": dist(score)}
    if agree != n:
        raise AssertionError(f"detection sets differ on {n - agree} images")
    if not (report["pose_deg"]["p99"] < PARITY_BUDGET_DEG
            and report["pose_deg"]["max"] < PARITY_BUDGET_DEG):
        raise AssertionError(f"pose error over budget: {report['pose_deg']}")
    return report


def phase_parity(flagship, corpus, production):
    library.reset_launches()                 # the main path's window opens
    report = check_parity(flagship.detect, corpus, production, "parity")
    launches = library.launches()            # ... and closes
    if launches["postprocess"] < 2:
        raise AssertionError(f"detect did not launch the kernel ({launches})")
    report["launches"] = launches
    emit(report)
    return launches


def order_exact(ref_boxes, ref_scores, ours, c, score_tol=1e-3) -> bool:
    """Does `ours` emit the reference's first c detections at the same
    positions (box IoU > 0.5, |score delta| < tol)?"""
    if len(ours.scores) < c:
        return False
    return all(box_iou(ref_boxes[i], ours.boxes[i]) > IOU_MATCH
               and abs(float(ref_scores[i]) - float(ours.scores[i])) < score_tol
               for i in range(c))


def check_stress(detect, flagship, stress, phase):
    """The boundary-stress corpus through `detect` (a method of flagship):
    threshold-straddling scores, IoU~0.3 NMS clusters, 20-48-face
    saturation, and >100-survivor overflow — its truncation order at the
    100-face cap, and its uncapped survivor sets at max_faces=256."""
    per = detect(stress["imgs"]).trim()
    report = {"phase": phase, "images": len(per)}
    for axis in ("threshold", "nms", "saturation", "overflow"):
        idxs = np.where(stress["axis"] == axis)[0]
        agree, pose = 0, []
        for i in idxs:
            c = int(stress["counts"][i])
            ref = {k: stress[k][i, :c] for k in ("boxes", "scores", "poses")}
            pairs, full = match_image(ref, per[i])
            agree += full
            pose += [np.abs(ref["poses"][r] - per[i].poses[o]).max()
                     for r, o in pairs]
        report[axis] = {"images": len(idxs), "set_agreement": agree / len(idxs),
                        "pose_deg": dist(pose)}
        if agree != len(idxs) or not max(pose) < PARITY_BUDGET_DEG:
            raise AssertionError(f"stress/{axis}: {report[axis]}")
    ov = np.where(stress["axis"] == "overflow")[0]
    order = sum(order_exact(stress["boxes"][i], stress["scores"][i], per[i],
                            int(stress["counts"][i])) for i in ov)
    report["overflow_order_exact"] = f"{order}/{len(ov)}"
    if order != len(ov):
        raise AssertionError(f"stress: truncation order {order}/{len(ov)}")

    saved = flagship.max_faces
    flagship.max_faces = 256
    try:
        unc = detect(stress["imgs"][stress["ov_idx"]]).trim()
    finally:
        flagship.max_faces = saved
    agree = count = order = 0
    for j, ours in enumerate(unc):
        c = int(stress["ov_counts"][j])
        ref = {"boxes": stress["ov_boxes"][j, :c],
               "scores": stress["ov_scores"][j, :c]}
        agree += match_image(ref, ours)[1]
        count += len(ours) == c
        order += order_exact(ref["boxes"], ref["scores"], ours, c)
    n = len(unc)
    report["uncapped_256"] = {"images": n, "set_agreement": agree / n,
                              "count_match": count, "order_exact": order,
                              "max_survivors": int(stress["ov_counts"].max())}
    if not agree == count == order == n:
        raise AssertionError(f"stress uncapped: {report['uncapped_256']}")
    return report


def phase_stress(flagship, stress):
    emit(check_stress(flagship.detect, flagship, stress, "stress"))


def phase_best(flagship, best, corpus):
    imgs = corpus["imgs"][:8]
    a, b = best.detect(imgs), flagship.detect(imgs)
    if not torch.equal(a.valid, b.valid):
        raise AssertionError("best_detector: detection sets differ")
    m = b.valid
    box_err = float((a.boxes - b.boxes)[m].abs().max())
    score_err = float((a.scores - b.scores)[m].abs().max())
    if box_err > 1e-6 or score_err > 1e-6:
        raise AssertionError(f"best_detector: boxes {box_err} / scores "
                             f"{score_err} differ from the flagship's")
    emit({"phase": "best", "images": 8, "detections": int(m.sum()),
          "box_err": box_err, "score_err": score_err,
          "pose_diff_max_deg": float((a.poses - b.poses)[m].abs().max())})


def phase_fused(flagship, best, corpus, production, stress, frames128):
    """The slice's path, FaceDetector.detect_fused (preprocess →
    backbone_forward → SSD 1x1 products → mlp_head_forward → the
    postprocess kernel → trim), through the main path's gates; best's
    detect_fused against its own detect; then the B=128 network stage of
    both paths."""
    from headpose_tpu_torch.runtime.fused import fused_network

    library.reset_launches()                 # the fused path's window opens
    parity = check_parity(flagship.detect_fused, corpus, production,
                          "fused")
    stressed = check_stress(flagship.detect_fused, flagship, stress,
                            "fused")
    imgs = corpus["imgs"][:8]
    a, b = best.detect_fused(imgs), best.detect(imgs)
    launches = library.launches()            # ... and closes
    if min(launches[k] for k in ("postprocess", "backbone_forward",
                                 "mlp_head")) < 1:
        raise AssertionError(f"detect_fused missed a kernel: {launches}")
    if not torch.equal(a.valid, b.valid):
        raise AssertionError("best detect_fused: detection sets differ")
    m = b.valid
    best_err = {k: float((getattr(a, k) - getattr(b, k))[m].abs().max())
                for k in ("boxes", "scores", "poses")}
    for k, tol in (("boxes", 1e-4), ("scores", 1e-4), ("poses", 5e-4)):
        if not best_err[k] <= tol:
            raise AssertionError(f"best detect_fused: {k} err "
                                 f"{best_err[k]} > {tol}")
    with torch.inference_mode():
        fused_ms = median_ms(lambda: fused_network(flagship.net, frames128),
                             20)
        cudnn_ms = median_ms(lambda: flagship.net(frames128), 20)
        best_ms = {"fused": median_ms(lambda: fused_network(best.net,
                                                            frames128), 20),
                   "cudnn": median_ms(lambda: best.net(frames128), 20)}
    del parity["phase"], stressed["phase"]
    emit({"phase": "fused", "launches": launches, "parity": parity,
          "stress": stressed,
          "best": {"images": 8, "detections": int(m.sum()), **best_err},
          "b128_network_ms_median": {"fused": fused_ms, "cudnn": cudnn_ms,
                                     "best": best_ms}})
    return launches


NARROW2 = dict(stem_features=8,
               block_channels=(8, 8, 12, 12, 16, 16, 24, 24, 32, 32, 40,
                               96, 96, 96, 96, 96))
# the flagship's widths with segment D widening to 128 channels, the
# kernel's widest instance
WIDE_D = dict(block_channels=(24, 28, 32, 36, 42, 48, 56, 64, 72, 80, 88, 96,
                              104, 112, 120, 128))


def segments_work(spec, B):
    """(tensor-core operations, fp32 operations, bytes) of the split-bf16
    segments of `spec`'s plan (kb2.segment_plan) for B images: each
    pointwise multiply-add as 2 on the tensor cores, three times (hi.hi,
    lo.hi, hi.lo); the depthwise multiply-adds as 2, its bias and the
    split's subtraction as 1 each, the bias, skip add and ReLU as 1 each,
    in fp32.  Bytes: the maps that enter the segments from outside them (the
    stem's output, an fp32 block's output) read once, the maps that leave
    them (the two taps, an fp32 block's input) written once, the weights
    once (fp32 and the bf16 hi/lo packs)."""
    from headpose_tpu_torch.ops.kernels import backbone2 as kb2

    plan = kb2.segment_plan(spec)
    chans = (spec.stem_features, *spec.block_channels)
    n = len(spec.block_channels)
    h, sizes = spec.input_size // 2, []        # the map after each block
    for i in range(n):
        h //= 2 if i in spec.downsample_blocks else 1
        sizes.append(h)
    split = {i for first, last, _ in plan.values()
             for i in range(first, last + 1)}
    tc = f32 = weights = maps = 0
    for first, last, h_in in plan.values():
        if first - 1 not in split:                 # from the stem or fp32
            maps += h_in * h_in * chans[first]
        if last == spec.tap88_block or last == n - 1 or last + 1 not in split:
            maps += sizes[last] ** 2 * chans[last + 1]
        for i in range(first, last + 1):
            cin, cout, pix = chans[i], chans[i + 1], sizes[i] ** 2
            tc += 3 * 2 * pix * cin * cout
            f32 += 2 * 9 * pix * cin + 2 * pix * cin + 3 * pix * cout
            weights += (4 * (10 * cin + cout)
                        + 2 * 2 * (-(-cout // 8) * 8) * (-(-cin // 16) * 16))
    return B * tc, B * f32, 4 * B * maps + weights


def segments_bound(spec, B):
    """(bound ms, bound by, its terms) of segments_work: bytes over 3.35
    TB/s, tensor-core operations over 989 TFLOP/s (bf16), fp32 operations
    over 67 TFLOP/s."""
    tc_ops, f32_ops, nbytes = segments_work(spec, B)
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
             "tensor-core operations": tc_ops / H100_BF16_FLOPS * 1e3,
             "fp32 operations": f32_ops / H100_FP32_FLOPS * 1e3}
    ms = max(terms.values())
    return ms, "bytes" if terms["bytes"] == ms else "operations", terms


def apply_fused_grids(net):
    """The launches of kb2.apply_fused_cuda(net, .) in order, labelled:
    the fp32 stem, then per segment each launch's blocks, and each fp32
    block."""
    from headpose_tpu_torch.ops.kernels import backbone2 as kb2

    labels = ["stem (fp32)"]
    plan = kb2.segment_plan(net.spec)
    for kind, key in kb2._schedule(net.spec):
        if kind == "fp32":
            labels.append(f"block{key} (fp32)")
            continue
        i = plan[key][0]
        for size in kb2.segment_launches(net, key):
            labels.append(f"{key}: block{i}" if size == 1
                          else f"{key}: blocks {i}-{i + size - 1}")
            i += size
    return labels


def time_segments(net, x):
    """The split-bf16 kernel on the main path's shapes for frames x: {"ms":
    every segment launch alone on its own input, "apply_fused_ms": the
    whole backbone, "grid_ms": each launch of apply_fused in order}."""
    from headpose_tpu_torch.ops.kernels import backbone2 as kb2

    pack = kb2.pack_backbone(net)
    inputs = kb2.segment_inputs(net, x, pack)
    labels = apply_fused_grids(net)
    per_grid = grids_in_order(lambda: kb2.apply_fused_cuda(net, x), 10,
                              len(labels))
    return {"ms": cuda_ms(lambda: [kb2.run_segment_cuda(net, y, seg, pack)
                                   for seg, y in inputs.items()], 50),
            "apply_fused_ms": cuda_ms(lambda: kb2.apply_fused_cuda(net, x),
                                      50),
            "grid_ms": dict(zip(labels, per_grid)),
            "launches_per_call": len(labels)}


def phase_kernel_backbone2(dev, flagship, back, frames128, frames256, built):
    """apply_fused: the split-bf16 segment kernels against the plain version
    (SPLIT_TOL) and against an fp32 backbone (SPLIT_VS_FP32_TOL) on the
    card: the flagship at B in {1, 3, 8, 128} on corpus frames, a narrow
    random-init spec at B=4 and a random-init spec whose segment D widens to
    128 channels at B=2 (against the fp32 backbone_forward kernel); the
    back model (input 256, every block split-bf16) at B in {1, 8, 128} on
    corpus frames resized to 256 (against its cuDNN BlazeFaceNet taps:
    kernel #2 does not take that spec).  Then timed at B=128 for both
    models: the segment launches alone (the row's ms), apply_fused whole,
    and each launch."""
    from headpose_tpu_torch.models import BlazeFace, BlazeFaceNet
    from headpose_tpu_torch.ops.kernels import backbone as kbb
    from headpose_tpu_torch.ops.kernels import backbone2 as kb2

    net, bnet = flagship.net.backbone, back.net.backbone
    narrow = random_init(BlazeFaceNet(BlazeFace(**NARROW2), device=dev), 6)
    wide = random_init(BlazeFaceNet(BlazeFace(**WIDE_D), device=dev), 8)
    xn = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, (4, 128, 128, 3)).astype(np.float32)).to(dev)
    cases, worst = [], {"plain": (0.0, 0.0), "fp32": (0.0, 0.0)}
    with torch.inference_mode():
        for name, m, x, fp32 in (
                ("flagship_b1", net, frames128[:1], kbb.backbone_forward_cuda),
                ("flagship_b3", net, frames128[:3], kbb.backbone_forward_cuda),
                ("flagship_b8", net, frames128[:8], kbb.backbone_forward_cuda),
                ("flagship_b128", net, frames128, kbb.backbone_forward_cuda),
                ("narrow_b4", narrow, xn, kbb.backbone_forward_cuda),
                ("wide_d_b2", wide, frames128[:2], kbb.backbone_forward_cuda),
                ("back_b1", bnet, frames256[:1], cudnn_taps),
                ("back_b8", bnet, frames256[:8], cudnn_taps),
                ("back_b128", bnet, frames256, cudnn_taps)):
            want = kb2.apply_fused_plain(m, x)
            ref = fp32(m, x)
            row = {"case": name, "b": int(x.shape[0])}
            got = kb2.apply_fused_cuda(m, x)
            torch.cuda.synchronize()
            for key, (w, tol) in (("plain", (want, kb2.SPLIT_TOL)),
                                  ("fp32", (ref, SPLIT_VS_FP32_TOL))):
                errs = [close(g, v, **tol) for g, v in zip(got, w)]
                err = max(e for e, _ in errs)
                ratio = max(r for _, r in errs)
                row[f"max_abs_err_vs_{key}"] = err
                row[f"tolerance_ratio_vs_{key}"] = ratio
                worst[key] = (max(worst[key][0], err),
                              max(worst[key][1], ratio))
            # the scale of the maps, and how far the plain version itself
            # lies from the fp32 backbone
            row["max_abs_map"] = max(float(w.abs().max()) for w in ref)
            row["plain_vs_fp32"] = max(float((p - w).abs().max())
                                       for p, w in zip(want, ref))
            cases.append(row)
        mine = time_segments(net, frames128)
        bmine = time_segments(bnet, frames256)
        inputs = kb2.segment_inputs(net, frames128, kb2.pack_backbone(net))
        plain_ms = cuda_ms(lambda: [kb2.run_segment_plain(net, y, seg)
                                    for seg, y in inputs.items()], 3)
        whole_plain_ms = cuda_ms(lambda: kb2.apply_fused_plain(net,
                                                               frames128), 3)
        library_ms = cuda_ms(lambda: cudnn_taps(net, frames128), 50)
        back_plain_ms = cuda_ms(lambda: kb2.apply_fused_plain(bnet,
                                                              frames256), 3)
        back_library_ms = cuda_ms(lambda: cudnn_taps(bnet, frames256), 50)
    B = int(frames128.shape[0])
    bound_ms, bound_by, times = segments_bound(net.spec, B)
    back_bound = segments_bound(bnet.spec, B)
    back_row = {"ms": bmine["ms"], "apply_fused_ms": bmine["apply_fused_ms"],
                "plain_ms": back_plain_ms, "library_ms": back_library_ms,
                "bound_ms": back_bound[0], "bound_by": back_bound[1],
                "bound_terms_ms": back_bound[2], "grid_ms": bmine["grid_ms"],
                "launches_per_call": bmine["launches_per_call"],
                "plan": kb2.segment_plan(bnet.spec),
                "timed": "the four segments (blocks 0-16) at B=128; "
                         "apply_fused_ms adds the fp32 stem"}
    emit({"phase": "kernels", "kernel": "apply_fused", "cases": cases,
          "ms": mine["ms"], "plain_ms": plain_ms,
          "apply_fused_ms": mine["apply_fused_ms"],
          "apply_fused_plain_ms": whole_plain_ms, "library_ms": library_ms,
          "bound_ms": bound_ms, "bound_terms_ms": times,
          "grid_ms": mine["grid_ms"], "back256": back_row})
    for key, tol in (("plain", kb2.SPLIT_TOL), ("fp32", SPLIT_VS_FP32_TOL)):
        if worst[key][1] > 1.0:
            raise AssertionError(f"apply_fused disagrees with the {key} "
                                 f"version beyond {tol}: {cases}")
    return {
        "name": "apply_fused", "route": "cuda",
        "source": "headpose_tpu_torch/csrc/backbone2.cu",
        "replaces": "headpose_tpu/ops/pallas/backbone2.py:334",
        "launches": None,                     # filled by the fast phase
        "max_abs_err": worst["plain"][0], "tolerance": kb2.SPLIT_TOL,
        "tolerance_ratio": worst["plain"][1],
        "max_abs_err_vs_fp32": worst["fp32"][0],
        "tolerance_vs_fp32": SPLIT_VS_FP32_TOL,
        "ms": mine["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "library": "sequence of calls, not one, of another function: the "
                   "port's cuDNN fp32 BlazeFaceNet stem + 16 blocks to the "
                   "two NHWC taps (no PyTorch call computes a 3-pass "
                   "split-bf16 product)",
        "timed": "the four segments (blocks 0-10, 12-15) at B=128, each "
                 "on its own input; apply_fused_ms adds the fp32 stem and "
                 "block 11",
        "apply_fused_ms": mine["apply_fused_ms"],
        "apply_fused_plain_ms": whole_plain_ms,
        "grid_ms": mine["grid_ms"],
        "grids_per_launch": mine["launches_per_call"],
        "back256": back_row,
        "bound_terms_ms": times,
        "shape": {"B": B, "S": net.spec.input_size},
        "build_s": built["apply_fused"]["build_s"],
        "ptxas": built["apply_fused"]["ptxas"],
    }


# ------------------------------------------------ single-pass bf16 island
# the island kernel against its plain version (the same bf16 operands; the
# fp32 sum order is the only freedom): |diff| <= 1e-5 of the map's largest
# |value|, block by block on the same input
ISLAND_TOL_FRAC = 1e-5
# a whole chain against the composition of its blocks' plain versions: one
# bf16 step (2^-7) of the map's largest |value| (tests/
# test_torch_island_chain.py::CHAIN_TOL_FRAC: a one-ulp fp32 difference
# before a block's bf16 rounding moves an element a bf16 step, and the
# blocks after it carry that on)
CHAIN_TOL_FRAC = 2.0 ** -7
U32 = 2.0 ** -24


def island_work(net, i, h, B):
    """(tensor-core operations, bytes) of island block i of `net` on an h x h
    map for B images: each multiply-add of the dense 3x3 conv as 2 (bf16 on
    the tensor cores; the bias, skip and ReLU are below 1% of them); the
    input read once, the output written once (fp32), the bf16 kernel and
    the fp32 bias once."""
    blk = net.blocks[i]
    cin, cout, s = blk.dw.weight.shape[0], blk.pw.weight.shape[0], blk.stride
    ho = h // s
    return (2 * B * ho * ho * 9 * cin * cout,
            4 * B * (h * h * cin + ho * ho * cout) + 2 * 9 * cin * cout
            + 4 * cout)


def island_bound(works):
    """(bound ms, bound by, terms) of the summed island_work of blocks:
    bytes over 3.35 TB/s, tensor-core operations over 989 TFLOP/s."""
    ops = sum(w[0] for w in works)
    nbytes = sum(w[1] for w in works)
    terms = {"bytes": nbytes / H100_BYTES_PER_S * 1e3,
             "tensor-core operations": ops / H100_BF16_FLOPS * 1e3}
    ms = max(terms.values())
    return ms, "bytes" if terms["bytes"] == ms else "operations", {
        **terms, "gflop": ops / 1e9, "mbytes": nbytes / 1e6}


def island_library(net, i, x):
    """The library yardsticks of island block i on NHWC x, each one cuDNN
    call on operands prepared outside it: ("bf16", its conv of the composed
    kernel in bf16, channels-last, output rounded to bf16: a second
    rounding the function does not make) and ("fp32", its fp32 conv of the
    bf16-rounded operands with TF32 off: the function's products, on the
    CUDA cores); both pad 1/1 (at stride 2 the function pads 0/1: the time,
    not the edge, is the point)."""
    import torch.nn.functional as F
    from headpose_tpu_torch.core.single_pass import bf16_round

    blk = net.blocks[i]
    K, bias = (t.detach() for t in blk.composed())
    xb = x.permute(0, 3, 1, 2).to(torch.bfloat16)          # channels-last
    Kb = K.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    xf = bf16_round(x).permute(0, 3, 1, 2)
    Kf = bf16_round(K).contiguous(memory_format=torch.channels_last)
    bb = bias.to(torch.bfloat16)
    return {"bf16": lambda: F.conv2d(xb, Kb, bb, blk.stride, 1),
            "fp32": lambda: F.conv2d(xf, Kf, bias, blk.stride, 1)}


def island_scale(net, i, x):
    """The sum of |terms| of island block i on NHWC x (|products| + |bias|
    + |skip|), on the card in fp32: the scale of its fp32 sum order."""
    import torch.nn.functional as F
    from headpose_tpu_torch.core.single_pass import bf16_round, fp32_exact
    from headpose_tpu_torch.models.blazeface import _pad_same

    blk = net.blocks[i]
    K, bias = (t.detach() for t in blk.composed())
    xa = bf16_round(x).abs().permute(0, 3, 1, 2)
    with fp32_exact():
        mag = (blk._conv3(xa, bf16_round(K).abs())
               + bias.abs()[:, None, None])
    skip = x.abs().permute(0, 3, 1, 2)
    if blk.stride == 2:
        skip = F.max_pool2d(skip, 2, 2)
    skip = F.pad(skip, (0, 0, 0, 0, 0, mag.shape[1] - skip.shape[1]))
    return (mag + skip).permute(0, 2, 3, 1)


def kernel_alone_ms(fn, kernel: str, reps: int = 20) -> float:
    """Device time of one launch of the kernel named `kernel` in fn() (one
    launch a call), the profiler's: the mean over the launches recorded in
    a window of reps warm calls, the most of PROFILE_TRIES windows.  A mean
    over recorded launches cannot be emptied by a dropped event, as a sum
    over the window divided by reps can (PERF.md §7)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = 0.0
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and kernel in e.name]
        if ev:
            best = max(best, sum(e.time_range.end - e.time_range.start
                                 for e in ev) / len(ev) / 1e3)
    if best == 0.0:
        raise AssertionError(f"the profiler recorded no {kernel} launch in "
                             f"{PROFILE_TRIES} windows")
    return best


def chain_work(net, first, last, h, B):
    """(tensor-core operations, bytes) of one chain: the blocks' operations
    summed; the chain's input read once, its last map and (when the spec's
    tap lies inside and is not the last) the tap's map written once, each
    block's bf16 kernel and fp32 bias once."""
    ops = nbytes = 0
    hh, out = h, 0
    for i in range(first, last + 1):
        w = island_work(net, i, hh, B)
        blk = net.blocks[i]
        cin, cout = blk.dw.weight.shape[0], blk.pw.weight.shape[0]
        ops += w[0]
        nbytes += 2 * 9 * cin * cout + 4 * cout
        hh //= blk.stride
        if i == last or i == net.spec.tap88_block:
            out += 4 * B * hh * hh * cout
    cin0 = net.blocks[first].dw.weight.shape[0]
    return ops, nbytes + 4 * B * h * h * cin0 + out


def check_chain(kd, m, first, last, y0):
    """The chain kernel against its plain version on its input y0: (a) each
    prefix chain first..k against dense_block_plain of block k on the
    prefix first..k-1's map (the chain's own intermediate), at
    ISLAND_TOL_FRAC of the map; the chain bitwise its longest prefix, its
    tap bitwise its prefix to the tap; (b) the whole chain (and its tap)
    against dense_chain_plain at CHAIN_TOL_FRAC of the map, with the share
    of elements beyond ISLAND_TOL_FRAC of the map; and the first and last
    image of the batch run alone bitwise their maps in the batch (an image's
    result does not depend on its place in it)."""
    got, got_tap = kd.dense_chain_cuda(m, first, last, y0)
    invariant = True
    for j in sorted({0, y0.shape[0] - 1}):
        one, one_tap = kd.dense_chain_cuda(m, first, last, y0[j:j + 1])
        invariant &= torch.equal(one[0], got[j])
        if got_tap is not None:
            invariant &= torch.equal(one_tap[0], got_tap[j])
    prev, worst_a, exact = y0, 0.0, True
    for k in range(first, last + 1):
        cur, _ = kd.dense_chain_cuda(m, first, k, y0)
        want = kd.dense_block_plain(m, k, prev)
        torch.cuda.synchronize()
        worst_a = max(worst_a, close(cur, want, 0.0, ISLAND_TOL_FRAC
                                     * float(want.abs().max()))[1])
        if k == m.spec.tap88_block:
            exact &= torch.equal(got_tap, cur)
        prev = cur
    exact &= torch.equal(got, prev)
    want, want_tap = kd.dense_chain_plain(m, first, last, y0)
    scale = float(want.abs().max())
    err, ratio_b = close(got, want, 0.0, CHAIN_TOL_FRAC * scale)
    if want_tap is not None and want_tap is not want:
        ratio_b = max(ratio_b, close(got_tap, want_tap, 0.0, CHAIN_TOL_FRAC
                                     * float(want_tap.abs().max()))[1])
    share = float(((got - want).abs() > ISLAND_TOL_FRAC * scale).float()
                  .mean())
    return {"max_abs_err": err, "max_abs_map": scale,
            "a_tolerance_ratio": worst_a, "b_tolerance_ratio": ratio_b,
            "share_beyond_1e-5": share, "prefix_bitwise": bool(exact),
            "batch_invariant": bool(invariant)}


def phase_kernel_dense(dev, flagship, back, frames128, frames256, built):
    """The island kernels against their plain versions.  dense_block
    (island_block_kernel) block by block, each on the same input: every
    block of the flagship and of the back model at B=128, 1 and 3 (the
    "max" plan's inputs, from a pass through the kernels, cover every block
    shape of both specs; the tile plan depends on the batch, and at B=1 and
    3 every CTA walks a single short tile), and a random-init spec widening
    to 128 channels at B=2, within ISLAND_TOL_FRAC of the map's largest
    |value| (the difference in units of fp32 roundoff of the sum of |terms|
    beside it), the first and last image alone bitwise their maps in the
    batch.  dense_chain
    (island_chain_kernel) on every chain of the "turbo" and "max" plans
    (`island_chains`) of the flagship and the back model at B=128, 1 and
    3 and of the wide spec at B=2, on the chain's own input: (a) block by
    block through its prefix chains at ISLAND_TOL_FRAC, (b) whole at
    CHAIN_TOL_FRAC (check_chain).  Then timed at B=128 (CUDA events): per
    block and per chain the kernel, the kernel alone (kernel_alone_ms),
    the plain version, the two cuDNN yardsticks (a chain: its blocks'
    summed), the bound (a chain: its own, and its blocks' summed); and per
    island of "turbo" and "max" of both models, the plan (its blocks alone
    and its chains) beside every island block alone."""
    from headpose_tpu_torch.models import BlazeFace, BlazeFaceNet
    from headpose_tpu_torch.ops.kernels import backbone2 as kb2
    from headpose_tpu_torch.ops.kernels import dense_bf16 as kd
    from headpose_tpu_torch.runtime.fused import island_of

    net, bnet = flagship.net.backbone, back.net.backbone
    wide = random_init(BlazeFaceNet(BlazeFace(**WIDE_D), device=dev), 8)
    cases, chain_cases, worst = [], [], (0.0, 0.0, 0.0)
    worst_chain = (0.0, 0.0, 0.0)
    timed, timed_chains = {}, {}
    with torch.inference_mode():
        for name, m, x, blocks in (
                ("flagship_b128", net, frames128, range(16)),
                ("back_b128", bnet, frames256, range(17)),
                ("flagship_b1", net, frames128[:1], range(16)),
                ("flagship_b3", net, frames128[:3], range(16)),
                ("back_b1", bnet, frames256[:1], range(17)),
                ("back_b3", bnet, frames256[:3], range(17)),
                ("wide_b2", wide, frames128[:2], range(16))):
            island = tuple(range(len(m.blocks)))
            inputs = kb2.segment_inputs(m, x, kb2.pack_backbone(m), island)
            dpack = kd.dense_pack(m)
            for i in blocks:
                y = inputs[i]
                got = kd.dense_block_cuda(m, i, y, dpack)
                want = kd.dense_block_plain(m, i, y)
                torch.cuda.synchronize()
                scale = float(want.abs().max())
                err, ratio = close(got, want, 0.0, ISLAND_TOL_FRAC * scale)
                units = float(((got - want).abs()
                               / (U32 * island_scale(m, i, y))).max())
                invariant = all(torch.equal(kd.dense_block_cuda(
                    m, i, y[j:j + 1], dpack)[0], got[j])
                    for j in sorted({0, y.shape[0] - 1}))
                worst = (max(worst[0], err), max(worst[1], ratio),
                         max(worst[2], units))
                cases.append({"case": name, "block": i,
                              "in": list(y.shape[1:]),
                              "max_abs_err": err, "max_abs_map": scale,
                              "tolerance_ratio": ratio,
                              "sum_order_units": units,
                              "plan": list(kd.tile_plan(
                                  y.shape[0], y.shape[1],
                                  *kd._shapes(m.spec)[i][:3])),
                              "batch_invariant": invariant})
                if x.shape[0] == 128:
                    lib = island_library(m, i, y)
                    h = int(y.shape[1])
                    work = island_work(m, i, h, 128)
                    one = island_bound([work])
                    call = (lambda m=m, i=i, y=y:
                            kd.dense_block_cuda(m, i, y, dpack))
                    timed[(name, i)] = {
                        "block": i, "in": list(y.shape[1:]),
                        "ms": cuda_ms(call, 50),
                        "kernel_ms": kernel_alone_ms(
                            call, "island_block_kernel"),
                        "plain_ms": cuda_ms(lambda: kd.dense_block_plain(
                            m, i, y), 10),
                        "library_bf16_ms": cuda_ms(lib["bf16"], 50),
                        "library_fp32_ms": cuda_ms(lib["fp32"], 20),
                        "bound_ms": one[0], "bound_by": one[1],
                        "work": work}
            chains = sorted({s for mode in ("turbo", "max")
                             for s in kd.island_chains(
                                 m.spec, island_of(m.spec, mode))
                             if s[0] == "chain"})
            for _, first, last in chains:
                if not any(first <= i <= last for i in blocks):
                    continue
                y0 = inputs[first]
                row = {"case": name, "chain": [first, last],
                       "in": list(y0.shape[1:]),
                       **check_chain(kd, m, first, last, y0)}
                chain_cases.append(row)
                worst_chain = (max(worst_chain[0], row["a_tolerance_ratio"]),
                               max(worst_chain[1], row["b_tolerance_ratio"]),
                               max(worst_chain[2], row["max_abs_err"]))
                if x.shape[0] == 128:
                    h = int(y0.shape[1])
                    work = chain_work(m, first, last, h, 128)
                    own = island_bound([work])
                    summed = island_bound([timed[(name, i)]["work"] for i
                                           in range(first, last + 1)])
                    call = (lambda m=m, f=first, la=last, y=y0:
                            kd.dense_chain_cuda(m, f, la, y, dpack))
                    timed_chains[(name, first, last)] = {
                        "chain": [first, last], "in": list(y0.shape[1:]),
                        "plan": list(kd.chain_plan(*kd._chain_args(
                            m.spec, first, last))),
                        "ms": cuda_ms(call, 50),
                        "kernel_ms": kernel_alone_ms(
                            call, "island_chain_kernel"),
                        "plain_ms": cuda_ms(lambda m=m, f=first, la=last,
                                            y=y0: kd.dense_chain_plain(
                                                m, f, la, y), 10),
                        **{k: sum(timed[(name, i)][k] for i in range(
                            first, last + 1)) for k in (
                            "library_bf16_ms", "library_fp32_ms")},
                        "per_block_kernel_ms": sum(
                            timed[(name, i)]["kernel_ms"]
                            for i in range(first, last + 1)),
                        "bound_ms": own[0], "bound_by": own[1],
                        "bound_terms": own[2],
                        "blocks_bound_ms": summed[0], "work": work}

    def total(name, spec, mode):
        """The island of `mode` as its plan launches it, and every island
        block alone (the per-block schedule), summed."""
        island = island_of(spec, mode)
        steps = kd.island_chains(spec, island)
        rows = [timed[(name, s[1])] if s[0] == "block"
                else timed_chains[(name, s[1], s[2])] for s in steps]
        blocks = [timed[(name, i)] for i in island]
        b = island_bound([r["work"] for r in rows])
        return {"blocks": list(island), "plan": [list(s) for s in steps],
                "launches": len(steps),
                **{k: sum(r[k] for r in rows) for k in (
                    "ms", "kernel_ms", "plain_ms", "library_bf16_ms",
                    "library_fp32_ms")},
                "bound_ms": b[0], "bound_by": b[1], "bound_terms": b[2],
                "blocks_bound_ms": island_bound(
                    [r["work"] for r in blocks])[0],
                "every_block_alone": {k: sum(r[k] for r in blocks) for k in (
                    "ms", "kernel_ms")}}

    sums = {"front_turbo": total("flagship_b128", net.spec, "turbo"),
            "front_max": total("flagship_b128", net.spec, "max"),
            "back_turbo": total("back_b128", bnet.spec, "turbo"),
            "back_max": total("back_b128", bnet.spec, "max")}
    per_block = {f"{name}.block{i}": {k: v for k, v in row.items()
                                      if k != "work"}
                 for (name, i), row in timed.items()}
    per_chain = {f"{name}.chain{f}-{la}": {k: v for k, v in row.items()
                                           if k != "work"}
                 for (name, f, la), row in timed_chains.items()}
    slower = ([k for k, r in per_block.items()
               if r["kernel_ms"] > r["library_bf16_ms"]]
              + [k for k, r in per_chain.items()
                 if r["kernel_ms"] > r["library_bf16_ms"]])
    emit({"phase": "kernels", "kernel": "dense_block", "cases": cases,
          "chain_cases": chain_cases, "sums_b128": sums,
          "per_block_b128": per_block, "per_chain_b128": per_chain,
          "slower_than_cudnn_bf16": slower})
    bad = [c for c in cases
           if c["tolerance_ratio"] > 1.0 or not c["batch_invariant"]]
    if bad:
        raise AssertionError(f"dense_block disagrees with its plain version "
                             f"beyond {ISLAND_TOL_FRAC} of the map, or an "
                             f"image alone with itself in the batch: {bad}")
    bad = [c for c in chain_cases if c["a_tolerance_ratio"] > 1.0
           or c["b_tolerance_ratio"] > 1.0 or not c["prefix_bitwise"]
           or not c["batch_invariant"]]
    if bad:
        raise AssertionError(f"dense_chain disagrees with its plain version "
                             f"(a: {ISLAND_TOL_FRAC} of the map a block, b: "
                             f"{CHAIN_TOL_FRAC} whole): {bad}")
    common = {
        "route": "cuda", "source": "headpose_tpu_torch/csrc/dense_bf16.cu",
        "replaces": "headpose_tpu/models/blazeface.py:162 (no Pallas "
                    "kernel: an island block is XLA's conv at "
                    "Precision.DEFAULT in BlazeFace.apply)",
        "launches": None,                     # filled by the turbo phase
        "library_fp32_ms_note": "cuDNN fp32 conv of the rounded operands",
        "build_s": built["dense_block"]["build_s"],
        "ptxas": built["dense_block"]["ptxas"],
        "sass_hmma": built["dense_block"]["sass_hmma"]}
    fm = sums["front_max"]
    large = [timed[("flagship_b128", s[1])] for s in kd.island_chains(
        net.spec, island_of(net.spec, "max")) if s[0] == "block"]
    block_entry = {
        "name": "dense_block", **common,
        "max_abs_err": worst[0], "tolerance_frac_of_map": ISLAND_TOL_FRAC,
        "tolerance_ratio": worst[1], "sum_order_units": worst[2],
        **{k: sum(r[k] for r in large) for k in (
            "ms", "kernel_ms", "plain_ms")},
        "bound_ms": island_bound([r["work"] for r in large])[0],
        "bound_by": island_bound([r["work"] for r in large])[1],
        "library_ms": sum(r["library_bf16_ms"] for r in large),
        "library": "cuDNN bf16 conv per block (torch.nn.functional.conv2d, "
                   "channels-last; output rounded to bf16), summed",
        "library_fp32_ms": sum(r["library_fp32_ms"] for r in large),
        "timed": "the front model's large-map blocks 0-5 (the \"max\" "
                 "plan's blocks alone) at B=128, each on its own input, "
                 "summed",
        "sums_b128": sums}
    ft = timed_chains[("flagship_b128", 10, 15)]
    chain_entry = {
        "name": "dense_chain", **common,
        "max_abs_err": worst_chain[2],
        "tolerance": {"a_frac_of_map_per_block": ISLAND_TOL_FRAC,
                      "b_frac_of_map_whole": CHAIN_TOL_FRAC},
        "a_tolerance_ratio": worst_chain[0],
        "b_tolerance_ratio": worst_chain[1],
        "ms": ft["ms"], "kernel_ms": ft["kernel_ms"],
        "plain_ms": ft["plain_ms"], "bound_ms": ft["bound_ms"],
        "bound_by": ft["bound_by"], "blocks_bound_ms": ft["blocks_bound_ms"],
        "library_ms": ft["library_bf16_ms"],
        "library": "cuDNN bf16 conv of each block of the chain "
                   "(channels-last; output rounded to bf16), summed",
        "library_fp32_ms": ft["library_fp32_ms"],
        "timed": "the front model's \"turbo\" chain (blocks 10-15) at "
                 "B=128, one launch",
        "front_max_ms": fm["ms"], "front_max_kernel_ms": fm["kernel_ms"]}
    return block_entry, chain_entry


MATMUL_SIZES = (2048, 4096)   # the matmul probe's default and next size
MATMUL_TOL_FRAC = 1e-5        # kernel against plain, of the largest |plain|
# (M, N, K): fewer tiles than SMs at every tile, M, N and K all different
MATMUL_NON_SQUARE = (768, 1280, 384)


def matmul_non_square(ktm) -> dict:
    """Every tile at MATMUL_NON_SQUARE on seed-0 bf16 normals against its
    plain version, the output landing in a freed block filled with NaN (a
    tile the persistent schedule skipped would show): rel_err_vs_plain
    (max|got - plain| / max|plain|, NaN counting as infinite) a tile.  One
    launch a tile."""
    m, n, k = MATMUL_NON_SQUARE
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(m, k))).to(torch.bfloat16).cuda()
    b = torch.from_numpy(rng.normal(size=(k, n))).to(torch.bfloat16).cuda()
    rows = {}
    for name, tile in ktm.TILES.items():
        want = ktm.tiled_matmul_plain(a, b, tile)
        torch.full((m, n), float("nan"), device="cuda")   # freed, reused
        got = ktm.tiled_matmul(a, b, tile)
        gap = torch.nan_to_num((got - want).abs(), nan=float("inf"))
        rows[name] = {"rel_err_vs_plain": float(gap.max())
                      / float(want.abs().max()),
                      "max_abs_err_vs_plain": float(gap.max())}
    return rows


def phase_kernel_matmul(built, card):
    """tiled_matmul, the GEMM of the matmul probe: its main path is the
    probe itself (tools/probe_matmul.probe) at MATMUL_SIZES, and every tile
    at MATMUL_NON_SQUARE against its plain version, in one launch window.
    Every tile against its plain version at the same tile, and at
    MATMUL_SIZES against the plain float32 product, within MATMUL_TOL_FRAC
    of the largest |plain| (the products are exact, only the sum order
    differs); each tile's ms and TFLOP/s beside the bound and one cuBLAS
    call, and its ratio to that call's TFLOP/s.  Returns the kernels line's
    entry (at 2048^3 the fastest tile) and the GEMM rates for the flops
    accounting: cuBLAS's and the fastest tile's at each size."""
    from headpose_tpu_torch.ops.kernels import tiled_matmul as ktm
    from headpose_tpu_torch.tools import probe_matmul

    t0 = time.perf_counter()
    reports = {}
    library.reset_launches()             # the probe's window opens
    for n in MATMUL_SIZES:
        reports[n] = probe_matmul.probe(n, device="cuda")
    non_square = matmul_non_square(ktm)
    window = library.launches()          # ... and closes
    expected = sum(len(ktm.TILES) * (2 + r["iters"])
                   for r in reports.values()) + len(ktm.TILES)
    seconds = time.perf_counter() - t0
    vs_cublas = {str(n): {name: t["tflops"] / r["library"]["tflops"]
                          for name, t in r["tiles"].items()}
                 for n, r in reports.items()}
    emit({"phase": "kernel_matmul", "card": card,
          "reports": {str(n): r for n, r in reports.items()},
          "non_square": {"shape": list(MATMUL_NON_SQUARE),
                         "tiles": non_square},
          "tflops_vs_cublas": vs_cublas,
          "launches_window": {k: v for k, v in window.items() if v},
          "expected_launches": expected, "seconds": seconds})
    bad = [(n, name, row["rel_err_vs_plain"], row["rel_err"])
           for n, r in reports.items() for name, row in r["tiles"].items()
           if not (row["rel_err_vs_plain"] <= MATMUL_TOL_FRAC
                   and row["rel_err"] <= MATMUL_TOL_FRAC)]
    bad += [(MATMUL_NON_SQUARE, name, row["rel_err_vs_plain"])
            for name, row in non_square.items()
            if not row["rel_err_vs_plain"] <= MATMUL_TOL_FRAC]
    if bad:
        raise AssertionError(f"tiled_matmul disagrees with its plain version "
                             f"beyond {MATMUL_TOL_FRAC} of max|plain|: {bad}")
    if {k: v for k, v in window.items() if v} != {"tiled_matmul": expected}:
        raise AssertionError(f"the probe's window launched {window}, not "
                             f"tiled_matmul {expected} times")
    rates = {}
    for n, r in reports.items():
        fastest = min(r["tiles"], key=lambda k: r["tiles"][k]["ms"])
        rates[f"cublas {n}^3"] = r["library"]["tflops"]
        rates[f"tiled_matmul {fastest} {n}^3"] = r["tiles"][fastest]["tflops"]
    r = reports[MATMUL_SIZES[0]]
    head = min(r["tiles"], key=lambda k: r["tiles"][k]["ms"])
    row = r["tiles"][head]
    lib = built["tiled_matmul"]
    entry = {
        "name": "tiled_matmul", "route": "cuda",
        "source": "headpose_tpu_torch/csrc/tiled_matmul.cu",
        "replaces": "scripts/probe_mosaic_matmul.py:67",
        "launches": window["tiled_matmul"],
        "max_abs_err": max([t["max_abs_err_vs_plain"]
                            for rr in reports.values()
                            for t in rr["tiles"].values()]
                           + [t["max_abs_err_vs_plain"]
                              for t in non_square.values()]),
        "tolerance": f"{MATMUL_TOL_FRAC} of max|plain|",
        "ms": row["ms"], "plain_ms": row["plain_ms"],
        "bound_ms": r["bound"]["ms"], "bound_by": r["bound"]["bound_by"],
        "library_ms": r["library"]["ms"], "library": r["library"]["call"],
        "timed": f"tile {head} {tuple(row['tile'])} at "
                 f"{MATMUL_SIZES[0]}^3, the fastest of the five",
        "tiles": {str(n): {name: {k: t[k] for k in (
            "ms", "tflops", "plain_ms", "rel_err_vs_plain")}
            for name, t in rr["tiles"].items()}
            for n, rr in reports.items()},
        "tflops_vs_cublas": vs_cublas,
        "library_tflops": {str(n): rr["library"]["tflops"]
                           for n, rr in reports.items()},
        "bound_ms_by_size": {str(n): rr["bound"]["ms"]
                             for n, rr in reports.items()},
        "build_s": lib["build_s"], "ptxas": lib["ptxas"],
        "sass_hgmma": lib["sass_hgmma"], "sass_hmma": lib["sass_hmma"]}
    return entry, rates


def phase_flops_accounting(network_ms, rates, card):
    """tools/flops_accounting.account of the flagship's B=128 network
    stage at "fast" and "max" (the turbo phase's medians of this run)
    against the GEMM rates the matmul probe measured in this run."""
    from headpose_tpu_torch.models import BLAZEFACE_FRONT
    from headpose_tpu_torch.tools.flops_accounting import account

    doc = account(BLAZEFACE_FRONT, {m: network_ms[m] for m in ("fast", "max")},
                  rates)
    emit({"phase": "flops_accounting", "card": card, **doc})
    return doc


def detect_walls(detect, imgs128) -> dict:
    """detect wall time at B=1 and B=128 (host clock around a synchronised
    call; median of 50 and 20 warm calls)."""
    out = {}
    for B, reps in ((1, 50), (128, 20)):
        x = imgs128[:B]
        detect(x)
        torch.cuda.synchronize()
        walls, trims = [], []
        for _ in range(reps):
            t0 = time.perf_counter()
            batch = detect(x)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            batch.trim()
            t2 = time.perf_counter()
            walls.append((t1 - t0) * 1e3)
            trims.append((t2 - t0) * 1e3)
        med = statistics.median(walls)
        out[f"b{B}"] = {"reps": reps, "detect_ms_median": med,
                        "detect_ms_min": min(walls),
                        "detect_ms_max": max(walls),
                        "frames_per_s": B / med * 1e3,
                        "detect_trim_ms_median": statistics.median(trims)}
    return out


def phase_fast(flagship, best, corpus, production, stress, frames128):
    """precision="fast": FaceDetector.detect (preprocess → fp32 stem →
    split-bf16 segments A-C → fp32 block 11 → segment D → SSD 1x1 products
    → mlp_head_forward → the postprocess kernel → trim) through the parity
    and stress gates; best_detector at "fast" against its own "highest"
    detect; then the B=128 network stage of the three networks and the
    "fast" detect wall times."""
    from headpose_tpu_torch.pretrained import best_detector, flagship_detector
    from headpose_tpu_torch.runtime.fused import fused_network

    fast = flagship_detector(precision="fast")
    best_fast = best_detector(precision="fast")
    # e2e_production.npz at the mode's own contract for poses (the 0.1 deg
    # parity budget; "fast" moves them by about 1e-3 deg), scores and boxes
    # at the fp32 path's tolerances
    tol = {**PRODUCTION_TOL, "poses": PARITY_BUDGET_DEG}
    library.reset_launches()                 # the fast path's window opens
    parity = check_parity(fast.detect, corpus, production, "fast", tol)
    stressed = check_stress(fast.detect, fast, stress, "fast")
    imgs = corpus["imgs"][:8]
    a = best_fast.detect(imgs)
    launches = library.launches()            # ... and closes
    if min(launches[k] for k in ("apply_fused", "mlp_head",
                                 "postprocess")) < 1:
        raise AssertionError(f"the fast detect missed a kernel: {launches}")
    b = best.detect(imgs)
    if not torch.equal(a.valid, b.valid):
        raise AssertionError("best fast: detection sets differ")
    m = b.valid
    best_err = {k: float((getattr(a, k) - getattr(b, k))[m].abs().max())
                for k in ("boxes", "scores", "poses")}
    if not best_err["poses"] < 0.05:
        raise AssertionError(f"best fast: poses {best_err['poses']} deg "
                             "from its highest detect")
    with torch.inference_mode():
        network_ms = {
            "fast": median_ms(lambda: fused_network(flagship.net, frames128,
                                                    "fast"), 20),
            "fused_highest": median_ms(lambda: fused_network(flagship.net,
                                                             frames128), 20),
            "cudnn": median_ms(lambda: flagship.net(frames128), 20),
            "best_fast": median_ms(lambda: fused_network(best.net, frames128,
                                                         "fast"), 20)}
    imgs128 = np.concatenate([corpus["imgs"], corpus["imgs"][:16]])
    del parity["phase"], stressed["phase"]
    emit({"phase": "fast", "launches": launches, "parity": parity,
          "stress": stressed,
          "best_vs_its_highest": {"images": 8, "detections": int(m.sum()),
                                  **best_err},
          "b128_network_ms_median": network_ms,
          "detect_wall": detect_walls(fast.detect, imgs128)})
    return launches


# ------------------------------------------------- SE-Transformer head
def se_head_params(c, seed, num_heads=4, key_dim=16, reduction=16, ff=64,
                   hidden=128, out=3):
    """An SETransformerHead's params in JAX layout, with the shapes and
    limits of the JAX init (headpose_tpu/models/heads.py:298-320): Glorot-
    uniform dense kernels, q/k/v and attn_out uniform in
    sqrt(6 / (C + H D)), zero biases, unit LayerNorm gains; numpy, from a
    seed."""
    rng = np.random.default_rng(seed)
    H, D, M = num_heads, key_dim, c // reduction

    def uniform(shape, fans):
        lim = np.sqrt(6.0 / fans)
        return rng.uniform(-lim, lim, shape).astype(np.float32)

    def dense(cin, cout):
        return {"w": uniform((cin, cout), cin + cout),
                "b": np.zeros(cout, np.float32)}

    def qkv():
        return {"w": uniform((c, H, D), c + H * D),
                "b": np.zeros((H, D), np.float32)}

    def ln():
        return {"g": np.ones(c, np.float32), "b": np.zeros(c, np.float32)}

    return {"se": {"fc1": dense(c, M), "fc2": dense(M, c)},
            "query": qkv(), "key": qkv(), "value": qkv(),
            "attn_out": {"w": uniform((H, D, c), H * D + c),
                         "b": np.zeros(c, np.float32)},
            "ln1": ln(), "ff1": dense(c, ff), "ff2": dense(ff, c),
            "ln2": ln(), "fc": dense(c, hidden), "out": dense(hidden, out)}


def se_head(dev, c, seed, **fields):
    """An SETransformerHeadNet on the card with `se_head_params`."""
    from headpose_tpu_torch.models.heads import (SETransformerHead,
                                                 SETransformerHeadNet)
    from headpose_tpu_torch.models.params import params_from_jax

    spec = SETransformerHead(in_features=c, **fields)
    net = SETransformerHeadNet(spec, device=dev)
    net.load_state_dict(params_from_jax(spec, se_head_params(
        c, seed, num_heads=spec.num_heads, key_dim=spec.key_dim,
        reduction=spec.reduction, ff=spec.ff_dim, hidden=spec.hidden,
        out=spec.out_features)))
    return net


def se_model():
    """The SE-Transformer model: the flagship's backbone and SSD weights
    with SETransformerHead(88) and SETransformerHead(96) at their defaults,
    seeded (88, 96)."""
    from headpose_tpu_torch.models.heads import SETransformerHead
    from headpose_tpu_torch.models.unified import UnifiedPoseModel
    from headpose_tpu_torch.pretrained import FLAGSHIP, load_pretrained

    spec, params = load_pretrained(FLAGSHIP)
    params = {"backbone": params["backbone"],
              "head88": se_head_params(88, 88),
              "head96": se_head_params(96, 96)}
    return UnifiedPoseModel(backbone=spec.backbone,
                            head88=SETransformerHead(88),
                            head96=SETransformerHead(96)), params


def se_work(spec, B, T):
    """Work of one SE-Transformer head over B maps of T tokens as the kernel
    does it: {"tc": the products on the tensor cores (q/k/v, Q K^T, P V, the
    output projection, the FFN, the two 1x1s; for T = 1 only v and the
    tail, as the softmax over one key is 1), each multiply-add as 2, times
    three TF32 passes; "fp32": on the CUDA cores the token mean and the
    gate's two products, the biases, residual adds, ReLUs and LayerNorms (8
    per element) and the softmax (scale, max, subtract, exp, sum: 5 per
    score, a divide per output), as 1 each; "bytes": the maps read once,
    the output written once, the weights once; "fp32_only": every
    operation of the head with attention, all on the CUDA cores: the
    count of the kernel's first, fp32-only design}."""
    C, H, D = spec.in_features, spec.num_heads, spec.key_dim
    M, F, Hd, O = C // spec.reduction, spec.ff_dim, spec.hidden, \
        spec.out_features
    HD = H * D
    tail = T * HD * C + 2 * T * C * F + T * C * Hd + T * Hd * O
    attention = T * C * 3 * HD + T * T * HD * 2
    gate = 2 * T * C + M + C + 4 * C * M                 # mean, gate
    rest = (2 * T * C + 2 * 8 * T * C                    # residuals, LNs
            + T * (F + C + 2 * Hd + O))                  # FFN, 1x1s
    softmax = 3 * T * HD + 5 * H * T * T + T * HD        # biases, softmax
    weights = (2 * C * M + M + C + 3 * (C * HD + HD) + HD * C + C + 4 * C
               + 2 * C * F + F + C + C * Hd + Hd + Hd * O + O)
    nbytes = 4 * (B * T * (C + O) + weights)
    if T == 1:
        tc, fp32 = 2 * (T * C * HD + tail), gate + rest + T * HD
    else:
        tc, fp32 = 2 * (attention + tail), gate + rest + softmax
    return {"tc": 3 * B * tc, "fp32": B * fp32, "bytes": nbytes,
            "fp32_only": B * (2 * (attention + tail) + gate + rest + softmax)}


def se_bound(works):
    """(bound ms, bound by, its terms, the fp32-only bound) of a
    sum of `se_work`s: the largest of bytes over 3.35 TB/s, tensor-core
    operations over 495 TFLOP/s (TF32) and CUDA-core operations over 67
    TFLOP/s."""
    terms = {"bytes": sum(w["bytes"] for w in works) / H100_BYTES_PER_S * 1e3,
             "tensor-core operations": sum(w["tc"] for w in works)
             / H100_TF32_FLOPS * 1e3,
             "fp32 operations": sum(w["fp32"] for w in works)
             / H100_FP32_FLOPS * 1e3}
    ms = max(terms.values())
    old = bound(sum(w["fp32_only"] for w in works),
                sum(w["bytes"] for w in works))[0]
    return ms, "bytes" if terms["bytes"] == ms else "operations", terms, old


def se_library(net):
    """The yardstick: the same chain with one scaled_dot_product_attention
    call for the attention and torch Linear / layer_norm for the rest, fp32
    (timed here, never served)."""
    import torch.nn.functional as F

    s = net.spec
    C, H, D = s.in_features, s.num_heads, s.key_dim
    w = {name: getattr(net, name).w.reshape(C, H * D).t().contiguous()
         for name in ("query", "key", "value")}
    b = {name: getattr(net, name).b.reshape(H * D)
         for name in ("query", "key", "value")}
    wo = net.attn_out.w.reshape(H * D, C).t().contiguous()

    def run(x):
        B, Hs, Ws, _ = x.shape
        t = x.reshape(B, Hs * Ws, C)
        g = torch.sigmoid(net.se.fc2(torch.relu(net.se.fc1(t.mean(1)))))
        t = t * g[:, None]
        q, k, v = (F.linear(t, w[n], b[n]).reshape(B, -1, H, D)
                   .transpose(1, 2) for n in ("query", "key", "value"))
        o = F.scaled_dot_product_attention(q, k, v)
        o = F.linear(o.transpose(1, 2).reshape(B, -1, H * D), wo,
                     net.attn_out.b)
        t1 = F.layer_norm(t + o, (C,), net.ln1.g, net.ln1.b, eps=1e-3)
        f = net.ff2(torch.relu(net.ff1(t1)))
        t2 = F.layer_norm(t1 + f, (C,), net.ln2.g, net.ln2.b, eps=1e-3)
        return net.out(torch.relu(net.fc(t2))).reshape(B, Hs, Ws, -1)

    return run


def phase_kernel_se(dev, flagship, frames128, built):
    """se_transformer: the kernel against its plain version on the
    card (SE_TOL): the SE model's heads on the flagship's taps of corpus
    frames at B in {1, 8, 128}, a 2 x 8 head on random 8x8x96 maps, a
    one-head spec on random 16x16x88 maps, 5x5 maps (T = 25: ragged key
    blocks and tiles that span images), 8 heads of 8 and 2 heads of 32, T =
    1 rows at N in {1, 100, 12800}; then timed at B=128 (both maps) and on
    the 12,800 rows beside the plain version, the library yardstick and the
    bound (tensor-core work in three TF32 passes, and the fp32-only bound
    of the kernel's first design beside it)."""
    from headpose_tpu_torch.ops.kernels import se_attention as kse

    h88, h96 = se_head(dev, 88, 88), se_head(dev, 96, 96)
    with torch.inference_mode():
        out = flagship.net(frames128)
    taps = {88: out["feat88"].clone(), 96: out["feat96"].clone()}
    rng = np.random.default_rng(12)

    def rand(shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(dev)

    rows = taps[88].reshape(-1, 1, 1, 88)
    cases = [(f"flagship{c}_b{b}", h, taps[c][:b])
             for b in (1, 8, 128) for c, h in ((88, h88), (96, h96))]
    cases += [("narrow96_2x8_b4", se_head(dev, 96, 5, num_heads=2,
                                          key_dim=8), rand((4, 8, 8, 96))),
              ("one_head88_b4", se_head(dev, 88, 6, num_heads=1),
               rand((4, 16, 16, 88))),
              ("maps5x5_88_b6", h88, rand((6, 5, 5, 88))),
              ("heads8_kd8_88_b4", se_head(dev, 88, 7, num_heads=8,
                                           key_dim=8), rand((4, 16, 16, 88))),
              ("key_dim32_96_b4", se_head(dev, 96, 9, num_heads=2,
                                          key_dim=32), rand((4, 8, 8, 96)))]
    cases += [(f"rows_n{n}", h88, rows[:n].contiguous())
              for n in (1, 100, 12800)]
    report, worst = [], (0.0, 0.0)
    with torch.inference_mode():
        for name, net, x in cases:
            got = kse.se_transformer_forward_cuda(net, x)
            want = kse.se_transformer_forward_plain(net, x)
            torch.cuda.synchronize()
            err, ratio = close(got, want, **SE_TOL)
            report.append({"case": name, "shape": list(x.shape),
                           "max_abs_err": err, "tolerance_ratio": ratio,
                           "max_abs_out": float(want.abs().max())})
            worst = (max(worst[0], err), max(worst[1], ratio))
        lib88, lib96 = se_library(h88), se_library(h96)
        vs_library = max(
            float((lib88(taps[88]) - kse.se_transformer_forward_plain(
                h88, taps[88])).abs().max()),
            float((lib96(taps[96]) - kse.se_transformer_forward_plain(
                h96, taps[96])).abs().max()))
        x88, x96, r12800 = taps[88], taps[96], rows[:12800].contiguous()
        ms = cuda_ms(lambda: (kse.se_transformer_forward_cuda(h88, x88),
                              kse.se_transformer_forward_cuda(h96, x96)), 50)
        plain_ms = cuda_ms(lambda: (
            kse.se_transformer_forward_plain(h88, x88),
            kse.se_transformer_forward_plain(h96, x96)), 5)
        library_ms = cuda_ms(lambda: (lib88(x88), lib96(x96)), 50)
        rows_ms = cuda_ms(lambda: kse.se_transformer_forward_cuda(
            h88, r12800), 200)
        rows_plain_ms = cuda_ms(lambda: kse.se_transformer_forward_plain(
            h88, r12800), 20)
        rows_library_ms = cuda_ms(lambda: lib88(r12800), 200)
        grids = {"maps_b128": grid_ms(lambda: (
            kse.se_transformer_forward_cuda(h88, x88),
            kse.se_transformer_forward_cuda(h96, x96)), 10),
            "rows12800": grid_ms(lambda: kse.se_transformer_forward_cuda(
                h88, r12800), 10)}
    B = int(frames128.shape[0])
    work = [se_work(h88.spec, B, 256), se_work(h96.spec, B, 64)]
    bound_ms, bound_by, terms, fp32_only_ms = se_bound(work)
    rows_work = se_work(h88.spec, 12800, 1)
    rows_bound_ms, rows_bound_by, rows_terms, rows_fp32_only_ms = se_bound(
        [rows_work])
    emit({"phase": "kernels", "kernel": "se_transformer",
          "cases": report, "ms": ms, "plain_ms": plain_ms,
          "library_ms": library_ms, "bound_ms": bound_ms,
          "bound_terms_ms": terms, "bound_fp32_only_ms": fp32_only_ms,
          "rows12800": {"ms": rows_ms, "plain_ms": rows_plain_ms,
                        "library_ms": rows_library_ms,
                        "bound_ms": rows_bound_ms,
                        "bound_terms_ms": rows_terms,
                        "bound_fp32_only_ms": rows_fp32_only_ms},
          "grid_ms": grids,
          "max_abs_err_plain_vs_library": vs_library})
    if worst[1] > 1.0:
        raise AssertionError(f"se_transformer_forward disagrees with its "
                             f"plain version beyond {SE_TOL}: {report}")
    return {
        "name": "se_transformer", "route": "cuda",
        "source": "headpose_tpu_torch/csrc/se_attention.cu",
        "replaces": "headpose_tpu/ops/pallas/se_attention.py:39",
        "launches": None,                     # filled by the se phase
        "max_abs_err": worst[0], "tolerance": SE_TOL,
        "tolerance_ratio": worst[1],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        "library": "sequence of calls, not one: "
                   "scaled_dot_product_attention for the attention, torch "
                   "Linear / layer_norm for the rest, fp32",
        "timed": "head88 over B x 16x16 tokens + head96 over B x 8x8, "
                 "B=128 (two calls, four launches)",
        "rows12800": {"ms": rows_ms, "plain_ms": rows_plain_ms,
                      "library_ms": rows_library_ms,
                      "bound_ms": rows_bound_ms, "bound_by": rows_bound_by,
                      "bound_fp32_only_ms": rows_fp32_only_ms},
        "grid_ms": grids, "bound_terms_ms": terms,
        "bound_fp32_only_ms": fp32_only_ms,
        "tensor_core_operations": sum(w["tc"] for w in work),
        "fp32_operations": sum(w["fp32"] for w in work),
        "bytes": sum(w["bytes"] for w in work),
        "shape": {"B": B, "T88": 256, "T96": 64},
        "build_s": built["se_transformer"]["build_s"],
        "ptxas": built["se_transformer"]["ptxas"],
    }


def check_sets(per, corpus) -> dict:
    """Set agreement of per-image Results against the parity corpus's
    reference detections (boxes by IoU > 0.5, as check_parity)."""
    agree = 0
    for i, ours in enumerate(per):
        c = int(corpus["counts"][i])
        ref = {k: corpus[k][i, :c] for k in ("boxes", "scores")}
        agree += match_image(ref, ours)[1]
    if agree != len(per):
        raise AssertionError(f"detection sets differ on "
                             f"{len(per) - agree} images")
    return {"images": len(per), "set_agreement": agree / len(per)}


def pose_gap(a, b, tol) -> dict:
    """a, b: BatchResults with equal valid; the largest pose difference on
    valid slots and its ratio to `tol` (<= 1 passes)."""
    if not torch.equal(a.valid.cpu(), b.valid.cpu()):
        raise AssertionError("detection sets differ")
    m = b.valid.cpu()
    pa, pb = a.poses.cpu()[m], b.poses.cpu()[m]
    err, ratio = close(pa, pb, **tol)
    return {"detections": int(m.sum()), "pose_max_abs_diff": err,
            "tolerance_ratio": ratio}


def phase_se(corpus):
    """The SE-Transformer model on the card: detect_fused in both head
    profiles and the "fast" detect (map), each through the parity corpus
    in its own launch window; poses against the module path, the CPU path
    and (for "fast") the "highest" detect."""
    from headpose_tpu_torch.runtime.detector import FaceDetector

    spec, params = se_model()
    dets = {"map": FaceDetector(spec, params, head_eval="map"),
            "survivors": FaceDetector(spec, params)}
    if dets["survivors"].head_eval != "survivors":
        raise AssertionError("head_eval='auto' did not resolve to "
                             "'survivors' for the SE-Transformer model")
    fast = FaceDetector(spec, params, head_eval="map", precision="fast")
    imgs = corpus["imgs"]
    report = {"phase": "se", "images": len(imgs)}
    fused = {}
    for name, run in (("map", dets["map"].detect_fused),
                      ("survivors", dets["survivors"].detect_fused),
                      ("fast_map", fast.detect)):
        library.reset_launches()             # this path's window opens
        batch = run(imgs)
        launches = library.launches()        # ... and closes
        if launches["se_transformer"] < 1 or \
                launches["postprocess"] < 1:
            raise AssertionError(f"se {name}: a kernel did not launch "
                                 f"({launches})")
        fused[name] = batch
        report[name] = {"launches": launches,
                        **check_sets(batch.trim(), corpus)}
    for name in ("map", "survivors"):
        det = dets[name]
        report[name]["vs_module_path"] = pose_gap(fused[name],
                                                  det.detect(imgs),
                                                  SE_POSE_TOL)
        cpu = FaceDetector(spec, params, head_eval=name, device="cpu")
        report[name]["vs_cpu_path_8"] = pose_gap(
            dets[name].detect_fused(imgs[:8]), cpu.detect_fused(imgs[:8]),
            SE_POSE_TOL)
    fast_gap = pose_gap(fused["fast_map"], dets["map"].detect(imgs),
                        dict(rtol=0.0, atol=PARITY_BUDGET_DEG))
    report["fast_map"]["vs_highest_detect"] = fast_gap
    report["profiles_pose_max_abs_diff"] = float(
        (fused["map"].poses - fused["survivors"].poses)[
            fused["map"].valid].abs().max())
    imgs128 = np.concatenate([imgs, imgs[:16]])
    report["detect_fused_wall"] = {
        name: detect_walls(dets[name].detect_fused, imgs128)
        for name in ("map", "survivors")}
    emit(report)
    for name in ("map", "survivors"):
        for key in ("vs_module_path", "vs_cpu_path_8"):
            if report[name][key]["tolerance_ratio"] > 1.0:
                raise AssertionError(f"se {name} {key}: {report[name][key]}")
    if fast_gap["tolerance_ratio"] > 1.0:
        raise AssertionError(f"se fast: {fast_gap}")
    return report["map"]["launches"], report


def phase_unified_best(flagship, corpus):
    """'unified-best' on the card: head_eval 'auto' resolves to
    'survivors'; detect and detect_fused on 16 corpus frames give the
    flagship's detections, and poses within 1e-3 deg of the port's CPU
    detector; detect wall times."""
    from headpose_tpu_torch.pretrained import UNIFIED_BEST, load_pretrained
    from headpose_tpu_torch.runtime.detector import FaceDetector

    spec, params = load_pretrained(UNIFIED_BEST)
    ub = FaceDetector(spec, params)
    if ub.head_eval != "survivors":
        raise AssertionError("unified-best did not resolve to 'survivors'")
    imgs = corpus["imgs"][:16]
    flag = flagship.detect(imgs)
    cpu = FaceDetector(spec, params, device="cpu").detect(imgs)
    report = {"phase": "unified_best", "images": 16,
              "head_eval": ub.head_eval}
    for name, run in (("detect", ub.detect),
                      ("detect_fused", ub.detect_fused)):
        batch = run(imgs)
        if not torch.equal(batch.valid, flag.valid):
            raise AssertionError(f"unified-best {name}: detection sets "
                                 "differ from the flagship's")
        m = flag.valid
        gap = pose_gap(batch, cpu, dict(rtol=0.0,
                                        atol=UNIFIED_BEST_POSE_TOL_DEG))
        report[name] = {
            "box_err_vs_flagship": float((batch.boxes - flag.boxes)[m]
                                         .abs().max()),
            "vs_cpu_detector": gap}
        if gap["tolerance_ratio"] > 1.0:
            raise AssertionError(f"unified-best {name}: poses {gap} from "
                                 "the CPU detector")
    imgs128 = np.concatenate([corpus["imgs"], corpus["imgs"][:16]])
    report["detect_wall"] = detect_walls(ub.detect, imgs128)
    emit(report)


BACK_POSE_TOL_DEG = 1e-3       # "highest" on the card vs the CPU detector
BACK_FAST_POSE_TOL_DEG = 0.02  # "fast" on the card vs the CPU's "fast"


def phase_back(back, corpus, frames256):
    """'unified-back-distilled' (input 256: the corpus frames resized by the
    preprocess) on the card: detect at "highest" (cuDNN) and at "fast"
    (every block through the split-bf16 kernel) on the 112 corpus frames,
    the fast path in its own launch window (apply_fused, mlp_head
    and postprocess must launch); the two give one detection set, poses
    within the 0.1 deg budget of each other; each against the port's CPU
    detector at its precision on 16 frames; then the B=128 network stage
    and the "fast" detect wall times."""
    from headpose_tpu_torch.runtime.detector import FaceDetector
    from headpose_tpu_torch.runtime.fused import fused_network, head_route

    spec, params = back
    fast = FaceDetector(spec, params, precision="fast")
    highest = FaceDetector(spec, params)
    imgs = corpus["imgs"]
    library.reset_launches()                 # the back path's window opens
    got = fast.detect(imgs)
    launches = library.launches()            # ... and closes
    if min(launches[k] for k in ("apply_fused", "mlp_head",
                                 "postprocess")) < 1:
        raise AssertionError(f"the back model's fast detect missed a "
                             f"kernel: {launches}")
    want = highest.detect(imgs)
    report = {"phase": "back", "model": "unified-back-distilled",
              "input_size": spec.backbone.input_size, "images": len(imgs),
              "launches": launches,
              "head_routes": [head_route(h) for h in (fast.net.head88,
                                                      fast.net.head96)],
              "detections": int(want.valid.sum()),
              "fast_vs_highest": pose_gap(got, want, dict(
                  rtol=0.0, atol=PARITY_BUDGET_DEG))}
    if report["detections"] < len(imgs) // 2:
        raise AssertionError(f"the back model found {report['detections']} "
                             f"faces on {len(imgs)} frames")
    for name, det, tol in (("highest", highest, BACK_POSE_TOL_DEG),
                           ("fast", fast, BACK_FAST_POSE_TOL_DEG)):
        cpu = FaceDetector(spec, params, device="cpu", precision=name)
        report[f"{name}_vs_cpu_16"] = pose_gap(
            det.detect(imgs[:16]), cpu.detect(imgs[:16]),
            dict(rtol=0.0, atol=tol))
    with torch.inference_mode():
        report["b128_network_ms_median"] = {
            "fast": median_ms(lambda: fused_network(fast.net, frames256,
                                                    "fast"), 20),
            "cudnn": median_ms(lambda: fast.net(frames256), 20)}
    imgs128 = np.concatenate([imgs, imgs[:16]])
    report["fast_detect_wall"] = detect_walls(fast.detect, imgs128)
    emit(report)
    for key in ("fast_vs_highest", "highest_vs_cpu_16", "fast_vs_cpu_16"):
        if report[key]["tolerance_ratio"] > 1.0:
            raise AssertionError(f"back {key}: {report[key]}")
    return launches


# precision="turbo" and "max": JAX's certificate (docs/certification.json,
# measured on a TPU) is the contract, with room for another card's sum order
TURBO_POSE_P99_DEG = 0.43      # twice JAX's certified turbo p99 (0.216)
MAX_POSE_P99_DEG = 1.35        # twice JAX's certified max p99 (0.676)
MAX_AGREE_MIN = 108            # JAX's certified max: 108 of 112 images


def kernel_names_per_call(fn, calls: int = 3, want: dict | None = None,
                          more: int = 10) -> dict:
    """The CUDA kernels one warm fn() launches, counted by kind
    (torch.profiler): "split_bf16" (csrc/backbone2.cu's block_kernel and
    chain_kernel), "island" and "island_chain" (csrc/dense_bf16.cu's
    island_block_kernel and island_chain_kernel), "stem", "mlp_head", and
    every other kernel under its own name.  The profiler drops an event now
    and then and never adds one; most often it drops a window's first
    launches, late in the process (PERF.md §7), which for detect_fused is
    the stem.  So each of `calls` windows is profiled twice, once alone and
    once after a spin kernel (settled_kinds), and each kind's count is the
    most over all of them; while a kind of `want` is still short, up to
    `more` windows follow."""
    counts: dict[str, int] = {}
    windows = 0
    while windows < calls or (want and windows < calls + more and any(
            counts.get(k, 0) < v for k, v in want.items())):
        for kinds in (kernel_kinds(cuda_events(fn, 1)), settled_kinds(fn)):
            for kind, n in kinds.items():
                counts[kind] = max(n, counts.get(kind, 0))
        windows += 1
    return counts


def kernel_kinds(events) -> dict:
    """kernel_names_per_call's kinds of the CUDA events, counted."""
    counts: dict[str, int] = {}
    for e in events:
        name = e.name
        if "island_chain_kernel" in name:
            kind = "island_chain"
        elif "island_block_kernel" in name:
            kind = "island"
        elif "chain_kernel" in name or ("block_kernel" in name
                                        and "bfloat16" in name):
            kind = "split_bf16"
        elif "stem_kernel" in name:
            kind = "stem"
        elif "mlp_head_kernel" in name:
            kind = "mlp_head"
        else:
            kind = name.replace("(anonymous namespace)::", "").split(
                "(")[0][:60]
        counts[kind] = counts.get(kind, 0) + 1
    return counts


def versus(got, want) -> dict:
    """Ragged Results `got` against `want` (another mode of the same model)
    image by image: images whose detection sets agree (IoU matching, as the
    certificate's), and the pose differences of the matched detections."""
    from headpose_tpu_torch.tools.certify_modes import dist, match_image

    agree, pose = 0, []
    for g, w in zip(got, want):
        pairs, full = match_image({"boxes": w.boxes, "scores": w.scores}, g)
        agree += full
        pose += [float(np.abs(w.poses[ri] - g.poses[oi]).max())
                 for ri, oi in pairs]
    return {"images": len(want), "agree_images": agree,
            "detections": int(sum(len(w.scores) for w in want)),
            "pose_deg": dist(pose)}


def jax_certificate(mode: str) -> dict:
    """JAX's certificate of a mode, measured on a TPU (docs/
    certification.json): printed beside the card's figures, not the
    port's own."""
    with open(os.path.join(HERE, "docs", "certification.json")) as f:
        cert = json.load(f)
    par, st = cert["modes"][mode], cert["stress"]["modes"][mode]
    return {"agree_images": round(par["set_agreement"] * par["images"]),
            "pose_deg": par["pose_deg"],
            "stress_agree": {a: st[a]["agree_images"] for a in (
                "threshold", "nms", "saturation", "overflow")},
            "stress_pose_max": {a: st[a]["pose_deg"]["max"] for a in (
                "threshold", "nms", "saturation", "overflow")},
            "overflow_order": st["overflow_order"]["order_exact"]}


def phase_turbo(flagship, best, back_model, corpus, stress, frames128,
                card):
    """precision="turbo" and "max" on the card.  The flagship at "turbo"
    and at "max" over the parity corpus, each in its own launch window:
    "turbo" needs set agreement 1.0 and pose p99 <= TURBO_POSE_P99_DEG,
    "max" at least MAX_AGREE_MIN images agreeing and pose p99 <=
    MAX_POSE_P99_DEG; the stress corpus per axis and the overflow order
    beside JAX's certificate (reported, not gated: the certificate puts
    these modes outside the stress contract).  Launches of one detect (B=8),
    by the wrappers' counts and by the profiler's kernel names, against the
    plans (segment_plan, island_chains): "turbo" runs kernel #3 over
    segments A, B and C 6-9 (as many grids as segment_launches gives), one
    island chain launch (blocks 10-15), #4 twice and #1 once; "max" blocks
    0-5 an island launch each, one chain launch (6-15) and no #3.  turbo_island=() gives the "fast" slabs
    bit for bit on the corpus.  best_detector() at both modes against its
    own "highest" (0 errors; sets and poses printed); the back model
    (input 256) at both modes: at least one detection, finite slabs, poses
    against its "highest" beside docs/certification_back.json.  Then the
    network stage (fused_network) at B=128 and B=1 and the detect wall time
    at B=1 and B=128 of "fast", "turbo" and "max"."""
    from headpose_tpu_torch.ops.kernels import backbone2 as kb2
    from headpose_tpu_torch.ops.kernels import dense_bf16 as kd
    from headpose_tpu_torch.pretrained import best_detector, flagship_detector
    from headpose_tpu_torch.runtime.detector import FaceDetector
    from headpose_tpu_torch.runtime.fused import fused_network, island_of
    from headpose_tpu_torch.tools.certify_modes import (certify_parity,
                                                        certify_stress)

    dets = {mode: flagship_detector(precision=mode)
            for mode in ("fast", "turbo", "max")}
    report = {"phase": "turbo", "card": card}
    windows = {}
    for mode in ("turbo", "max"):
        library.reset_launches()             # the mode's window opens
        par = certify_parity(dets[mode].detect, corpus)
        windows[mode] = library.launches()   # ... and closes
        st = certify_stress(dets[mode].detect, stress)
        report[mode] = {
            "parity": par, "launches_parity_window": windows[mode],
            "stress_agree": {a: st[a]["agree_images"] for a in (
                "threshold", "nms", "saturation", "overflow")},
            "stress_pose_max": {a: st[a]["pose_deg"].get("max") for a in (
                "threshold", "nms", "saturation", "overflow")},
            "overflow_order": st["overflow_order"]["order_exact"],
            "jax_tpu_certificate": jax_certificate(mode)}

    # launches of one detect at B=8, by count and by kernel name
    imgs8 = corpus["imgs"][:8]
    net = flagship.net.backbone
    for mode in ("turbo", "max"):
        island = island_of(net.spec, mode)
        plan = kb2.segment_plan(net.spec, island)
        library.reset_launches()
        dets[mode].detect(imgs8)
        torch.cuda.synchronize()
        counts = library.launches()
        steps = kd.island_chains(net.spec, island)
        alone = sum(s[0] == "block" for s in steps)
        chained = sum(s[0] == "chain" for s in steps)
        want = {"split_bf16": sum(len(kb2.segment_launches(net, seg, island))
                                  for seg in plan),
                "island": alone, "island_chain": chained, "mlp_head": 2}
        names = kernel_names_per_call(lambda: dets[mode].detect(imgs8),
                                      want=want)
        report[mode]["per_detect"] = {"counts": counts, "kernels": names,
                                      "plan": plan,
                                      "island_plan": [list(s) for s in steps],
                                      "expected_grids": want}
        expected = {"backbone2_segment": len(plan), "dense_block": alone,
                    "dense_chain": chained,
                    "mlp_head": 2, "postprocess": 1,
                    "apply_fused": 1 if plan else 0, "backbone_forward": 0}
        bad = {k: counts[k] for k, v in expected.items() if counts[k] != v}
        bad.update({k: names.get(k, 0) for k, v in want.items()
                    if names.get(k, 0) != v})
        report[mode]["per_detect"]["mismatch"] = bad

    # the empty island is "fast", bit for bit
    empty = flagship_detector(precision="turbo", turbo_island=())
    a, b = empty.detect(corpus["imgs"]), dets["fast"].detect(corpus["imgs"])
    report["empty_island_bitwise_fast"] = all(
        torch.equal(getattr(a, k), getattr(b, k)) for k in FIELDS)

    # best_detector() and the back model at both modes
    best_per = best.detect(corpus["imgs"]).trim()
    with open(os.path.join(HERE, "docs", "certification_back.json")) as f:
        back_cert = json.load(f)["trained_modes"]
    spec, params = back_model
    back_high = FaceDetector(spec, params).detect(corpus["imgs"]).trim()
    for mode in ("turbo", "max"):
        got = best_detector(precision=mode).detect(corpus["imgs"]).trim()
        report[mode]["best_vs_its_highest"] = versus(got, best_per)
        bdet = FaceDetector(spec, params, precision=mode)
        slab = bdet.detect(corpus["imgs"])
        finite = all(bool(torch.isfinite(getattr(slab, k)).all())
                     for k in ("boxes", "keypoints", "scores", "poses"))
        report[mode]["back"] = {
            "detections": int(slab.valid.sum()), "finite": finite,
            "vs_its_highest": versus(slab.trim(), back_high),
            "jax_tpu_certificate_vs_highest": {
                k: back_cert[mode][k] for k in ("pose_front_deg",
                                                "pose_back_deg")}}

    # times, in this one call: the network stage and detect walls
    imgs128 = np.concatenate([corpus["imgs"], corpus["imgs"][:16]])
    with torch.inference_mode():
        report["b128_network_ms_median"] = {
            mode: median_ms(lambda: fused_network(flagship.net, frames128,
                                                  mode), 20)
            for mode in ("fast", "turbo", "max")}
        report["b1_network_ms_median"] = {
            mode: median_ms(lambda: fused_network(flagship.net,
                                                  frames128[:1], mode), 50)
            for mode in ("fast", "turbo", "max")}
    report["detect_wall"] = {mode: detect_walls(dets[mode].detect, imgs128)
                             for mode in ("fast", "turbo", "max")}
    emit(report)

    t, m = report["turbo"], report["max"]
    if not (t["parity"]["set_agreement"] == 1.0
            and t["parity"]["pose_deg"]["p99"] <= TURBO_POSE_P99_DEG):
        raise AssertionError(f"turbo on the parity corpus: {t['parity']}")
    if not (m["parity"]["agree_images"] >= MAX_AGREE_MIN
            and m["parity"]["pose_deg"]["p99"] <= MAX_POSE_P99_DEG):
        raise AssertionError(f"max on the parity corpus: {m['parity']}")
    for mode in ("turbo", "max"):
        if report[mode]["per_detect"]["mismatch"]:
            raise AssertionError(f"{mode}: launches per detect "
                                 f"{report[mode]['per_detect']}")
        need = ["mlp_head", "postprocess"] + [
            {"block": "dense_block", "chain": "dense_chain"}[s[0]]
            for s in kd.island_chains(net.spec, island_of(net.spec, mode))]
        if min(windows[mode][k] for k in need) < 1:
            raise AssertionError(f"{mode} missed a kernel: {windows[mode]}")
        back = report[mode]["back"]
        if back["detections"] < 1 or not back["finite"]:
            raise AssertionError(f"back model at {mode}: {back}")
    if windows["turbo"]["backbone2_segment"] < 1:
        raise AssertionError(f"turbo missed kernel #3: {windows['turbo']}")
    if not report["empty_island_bitwise_fast"]:
        raise AssertionError("turbo_island=() differs from fast")
    return windows, report["b128_network_ms_median"]


def head_routes() -> dict:
    """runtime.fused.head_route of both heads of every model served here."""
    from headpose_tpu_torch.models.heads import head_net
    from headpose_tpu_torch.pretrained import (BEST, FLAGSHIP, UNIFIED_BEST,
                                               load_pretrained)
    from headpose_tpu_torch.runtime.fused import head_route

    specs = {name: load_pretrained(name)[0] for name in (
        FLAGSHIP, BEST, UNIFIED_BEST, "unified-back-distilled")}
    specs["se_transformer (seeded)"] = se_model()[0]
    return {name: {h: head_route(head_net(getattr(spec, h), device="cpu"))
                   for h in ("head88", "head96")}
            for name, spec in specs.items()}


def phase_timing(flagship, corpus, card):
    from headpose_tpu_torch.ops.image import preprocess
    from headpose_tpu_torch.ops.kernels import postprocess_kernel

    imgs128 = np.concatenate([corpus["imgs"], corpus["imgs"][:16]])
    out = {"phase": "timing", "card": card, "frames": "128x128 uint8 BGR",
           **detect_walls(flagship.detect, imgs128)}

    # where the time goes at B=128: CUDA events between the stages
    dev = flagship.device
    x = torch.from_numpy(imgs128).to(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = {"preprocess": [], "network": [], "postprocess": []}
    with torch.inference_mode():
        for _ in range(20):
            ev[0].record()
            p = preprocess(x, 128, "bgr")
            ev[1].record()
            o = flagship.net(p)
            ev[2].record()
            postprocess_kernel(o["scores"], o["loc"], o["pose_front"],
                               o["pose_back"], flagship.anchors)
            ev[3].record()
            torch.cuda.synchronize()
            for i, k in enumerate(split):
                split[k].append(ev[i].elapsed_time(ev[i + 1]))
    out["b128_stage_ms_median"] = {k: statistics.median(v)
                                   for k, v in split.items()}
    emit(out)


# ------------------------------------------------- serving and timeline
SERVE_TOL = {"boxes": 1e-5, "scores": 1e-5, "poses": 1e-3}   # deg for poses


def served_vs_direct(answers, direct) -> dict:
    """Served answers against the same detector's direct detect: identical
    detection sets (count, then each row within SERVE_TOL)."""
    worst = {k: 0.0 for k in SERVE_TOL}
    for i, (got, want) in enumerate(zip(answers, direct)):
        if len(got) != len(want):
            raise AssertionError(f"frame {i}: {len(got)} served detections, "
                                 f"{len(want)} direct")
        for k in worst:
            if len(want):
                worst[k] = max(worst[k], float(np.abs(
                    getattr(got, k) - getattr(want, k)).max()))
    for k, tol in SERVE_TOL.items():
        if not worst[k] <= tol:
            raise AssertionError(f"served {k} {worst[k]} from direct detect")
    return worst


def serve_clients(url: str, n: int):
    """In a process of its own (a remote client does not share the server's
    interpreter): the first n corpus frames through PoseClient.detect_many at
    concurrency 32, then as one detect_batch; the answers, each call's
    seconds and /v1/stats."""
    from headpose_tpu_torch.runtime.client import PoseClient

    frames = list(np.load(os.path.join(GOLDEN, "parity_corpus.npz"))["imgs"]
                  [:n])
    with PoseClient(url) as client:
        client.health()
        t0 = time.perf_counter()
        many = client.detect_many(frames, concurrency=32)
        t1 = time.perf_counter()
        batch = client.detect_batch(np.stack(frames))
        t2 = time.perf_counter()
        return many, batch, t1 - t0, t2 - t1, client.stats()


def serve_one(name, det, corpus, card):
    """PoseServer(max_batch=128) over `det`, its clients in another process
    (serve_clients); the kernels' launch counts are reset just before the
    clients start and read just after they finish."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from headpose_tpu_torch.runtime.http import PoseServer

    frames = list(corpus["imgs"])
    spawn = multiprocessing.get_context("spawn")
    with PoseServer(det, port=0, max_batch=128, max_delay=0.005) as srv, \
            ProcessPoolExecutor(1, mp_context=spawn) as pool:
        pool.submit(time.sleep, 0).result()   # the client process is up
        batcher = srv.batcher
        warm = {}
        for w in batcher.widths:              # outside the window: each
            warm[w] = []                      # width's first dispatch in the
            for _ in range(2):                # dispatcher thread, and again
                t0 = time.perf_counter()
                for fut in [batcher.submit(f) for f in (frames * 2)[:w]]:
                    fut.result(timeout=600)
                warm[w].append((time.perf_counter() - t0) * 1e3)
        served0, dispatches0 = batcher.frames_served, batcher.dispatches
        library.reset_launches()              # the serve path's window opens
        many, batch, many_s, batch_s, stats = pool.submit(
            serve_clients, srv.url, len(frames)).result(timeout=600)
        launches = library.launches()         # ... and closes
        dispatches = batcher.dispatches - dispatches0
        served = batcher.frames_served - served0
    direct = det.detect(np.stack(frames)).trim()
    report = {"model": name, "precision": det.precision, "card": card,
              "frames": "112 parity-corpus frames, 128x128 uint8 BGR",
              "launches": launches, "dispatches": dispatches,
              "frames_served": served, "errors": stats["errors"],
              "frames_per_dispatch": served / max(dispatches, 1),
              "warmup_dispatch_ms_first_second": warm,
              "latency_ms": stats.get("latency_ms"),
              "detect_many_c32": {"s": many_s,
                                  "frames_per_s": len(frames) / many_s},
              "detect_batch_112": {"s": batch_s,
                                   "frames_per_s": len(frames) / batch_s},
              "many_vs_direct": served_vs_direct(many, direct),
              "batch_vs_direct": served_vs_direct(batch, direct)}
    if not (served == 2 * len(frames) and stats["errors"] == 0
            and dispatches < served):
        raise AssertionError(f"serve {name}: {served} frames served in "
                             f"{dispatches} dispatches, {stats['errors']} "
                             "errors")
    want = {"postprocess": dispatches}
    if det.precision == "fast":
        want.update(apply_fused=dispatches, mlp_head=2 * dispatches)
    for k, n in want.items():
        if launches[k] != n:
            raise AssertionError(f"serve {name}: {k} launched "
                                 f"{launches[k]} times for {dispatches} "
                                 "dispatches")
    return report, many, batch


def serve_cli(det, frames, args=("--model", "unified-best-distilled",
                                  "--precision", "fast")) -> dict:
    """The CLI as a user starts it, `python -m headpose_tpu_torch.runtime.
    http --model unified-best-distilled --precision fast` (or with `args`,
    e.g. an AOT artifact's directory; on the card: it has no device flag),
    on a free port: 16 frames through PoseClient against `det`'s direct
    detect; the process is stopped at the end."""
    import select

    from headpose_tpu_torch.runtime.client import PoseClient

    command = [sys.executable, "-m", "headpose_tpu_torch.runtime.http",
               *args, "--port", "0"]
    proc = subprocess.Popen(command, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        out, deadline = [], time.monotonic() + 300
        while not (out and out[-1].startswith("serving on ")):
            ready, _, _ = select.select([proc.stdout], [], [],
                                        max(0.0, deadline - time.monotonic()))
            line = proc.stdout.readline() if ready else ""
            if not line:
                raise AssertionError("the CLI did not start: "
                                     + "".join(out)[-3000:])
            out.append(line)
        url = out[-1].split()[2]
        with PoseClient(url) as client:
            got = client.detect_many(frames[:16], concurrency=8)
            stats = client.stats()
    finally:
        proc.terminate()
        proc.wait(timeout=60)
    direct = det.detect(np.stack(frames[:16])).trim()
    return {"command": " ".join(["python", *command[1:]]),
            "frames": 16, "dispatches": stats["dispatches"],
            "errors": stats["errors"],
            "vs_direct": served_vs_direct(got, direct)}


def phase_serve(flagship, corpus, card):
    """The serving path on the card: client → PoseServer → DynamicBatcher
    → FaceDetector.detect (its kernels launched from the dispatcher thread)
    → trim() → JSON, for the flagship at "highest" (kernel #1) and
    best_detector() at "fast" (kernels #3, #4 and #1).  The flagship's
    served answers also hold the parity corpus's gates."""
    from headpose_tpu_torch.pretrained import best_detector

    out = {}
    for name, det in (("flagship", flagship),
                      ("best_fast", best_detector(precision="fast"))):
        report, many, batch = serve_one(name, det, corpus, card)
        if name == "flagship":
            for route, per in (("detect_many", many), ("detect_batch", batch)):
                parity = corpus_parity(per, corpus, "serve")
                del parity["phase"]
                report[f"parity_{route}"] = parity
        if name == "best_fast":
            report["cli"] = serve_cli(det, list(corpus["imgs"]))
            if report["cli"]["errors"]:
                raise AssertionError(f"serve cli: {report['cli']}")
        out[name] = report
    emit({"phase": "serve", **out})
    return {name: r["launches"] for name, r in out.items()}


STREAM_POSE_TOL_DEG = 1e-3     # the card's timeline vs the CPU's
STREAM_BOX_TOL = 1e-5


def phase_stream(flagship, corpus, card):
    """detect_stream over the 112 corpus frames in batches of 16 against
    each batch's detect; process_frames (detect_stream → track_sequence)
    on the card against the same call on the port's CPU detector: valid
    identical, final track states identical, smoothed values within
    STREAM_POSE_TOL_DEG / STREAM_BOX_TOL."""
    from headpose_tpu_torch.pretrained import flagship_detector
    from headpose_tpu_torch.runtime.offline import (_smooth_timeline,
                                                    process_frames)
    from headpose_tpu_torch.runtime.streaming import detect_stream

    imgs = corpus["imgs"]
    batches = [imgs[i:i + 16] for i in range(0, len(imgs), 16)]
    list(detect_stream(flagship, batches[:2]))          # warm
    torch.cuda.synchronize()
    library.reset_launches()                  # the stream path's window opens
    slabs = [r.slab for r in detect_stream(flagship, batches, prefetch=2)]
    torch.cuda.synchronize()
    launches = library.launches()             # ... and closes

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def stream():
        for _ in detect_stream(flagship, batches, prefetch=2):
            pass

    def loop():
        for b in batches:
            flagship.detect(b)

    walls = {"stream": [], "loop": []}        # loop, stream, stream, loop
    for order in (("loop", "stream"), ("stream", "loop")) * 3:
        for name in order:
            walls[name].append(wall(stream if name == "stream" else loop))
    stream_s = statistics.median(walls["stream"])
    worst = 0.0
    for b, slab in zip(batches, slabs):
        want = flagship.detect(b)
        if not torch.equal(slab[..., 20] > 0.5, want.valid):
            raise AssertionError("detect_stream: detection sets differ")
        worst = max(worst, float((slab - want.slab).abs().max()))
    if not worst <= 1e-6:
        raise AssertionError(f"detect_stream: {worst} from detect")
    if launches["postprocess"] != len(batches):
        raise AssertionError(f"detect_stream: {launches}")

    cpu = flagship_detector(device="cpu")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_res = process_frames(flagship, imgs, batch_size=64)
    card_s = time.perf_counter() - t0
    cpu_res = process_frames(cpu, imgs, batch_size=64)
    if not np.array_equal(card_res.valid, cpu_res.valid):
        raise AssertionError("process_frames: valid differs from the CPU's")
    v = cpu_res.valid
    gap = {"poses_deg": float(np.abs(card_res.poses - cpu_res.poses)[v].max()),
           "boxes": float(np.abs(card_res.boxes - cpu_res.boxes)[v].max())}
    if not (gap["poses_deg"] <= STREAM_POSE_TOL_DEG
            and gap["boxes"] <= STREAM_BOX_TOL):
        raise AssertionError(f"process_frames: card vs CPU {gap}")
    # the final track states of both timelines
    raw = {dev: process_frames(det, imgs, batch_size=64, smooth_alpha=None)
           for dev, det in (("cuda", flagship), ("cpu", cpu))}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, st_card = _smooth_timeline(raw["cuda"], 0.15, True, return_state=True,
                                  device=flagship.device)
    torch.cuda.synchronize()
    track_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, st_cpu = _smooth_timeline(raw["cpu"], 0.15, True, return_state=True)
    track_cpu_s = time.perf_counter() - t0
    for field in ("active", "age"):
        if not torch.equal(getattr(st_card, field).cpu(),
                           getattr(st_cpu, field)):
            raise AssertionError(f"track state {field} differs")
    for k, init in st_cpu.ema.initialized.items():
        if not torch.equal(st_card.ema.initialized[k].cpu(), init):
            raise AssertionError(f"track slot occupancy ({k}) differs")
    emit({"phase": "stream", "card": card, "launches": launches,
          "detect_stream_16x7": {"s_median": stream_s,
                                 "frames_per_s": len(imgs) / stream_s,
                                 "max_abs_err_vs_detect": worst},
          "walls_s": walls,
          "process_frames_b64": {"s": card_s,
                                 "frames_per_s": len(imgs) / card_s,
                                 "track_sequence_s": track_s,
                                 "track_sequence_cpu_s": track_cpu_s,
                                 "detections": int(v.sum()),
                                 "card_vs_cpu": gap,
                                 "active_tracks": int(st_cpu.active.sum())}})


# ------------------------------------------------------------ head training
TRAIN_ROWS = 16384            # BIWI-scale rows (the train file's order)
TRAIN_EPOCHS = 20
TRAIN_LOSS_RTOL = 1e-3        # the card's epoch losses vs the CPU's
KERAS_RTOL = 1e-4             # tests/test_train_parity.py
EXTRACT_TOL = 1e-4            # features and scores, card vs CPU
SELF_POSE_TOL_DEG = 1e-3      # head on the extracted vector vs detect
JOINED_POSE_TOL_DEG = 1e-3    # the fp32 kernel path vs the module path
EVAL_TOL_DEG = 1e-4           # evaluate_head_pose_model, card vs CPU
DISTILL_WIDTHS = ((256, "tanh"), (128, "tanh"), (3, "linear"))


def keras_replay() -> dict:
    """tests/golden/keras_train_traj.npz on the card: 6 full-batch steps of
    SGD(0.01) and Adam(0.01) of a 96→8 tanh→3 head with L2(1e-3), losses
    and MAEs against tf-keras's history."""
    from headpose_tpu_torch.models import MLPHead, head_net
    from headpose_tpu_torch.models.params import params_from_jax
    from headpose_tpu_torch.train import TrainConfig, make_optimizer
    from headpose_tpu_torch.train.loop import _loss_and_metrics

    g = np.load(os.path.join(GOLDEN, "keras_train_traj.npz"))
    spec = MLPHead(96, ((8, "tanh"), (3, "linear")))
    n = g["x"].shape[0]
    batch = {"x": torch.tensor(g["x"].reshape(-1, 96)),
             "y": torch.tensor(g["y"].reshape(-1, 3)),
             "w": torch.ones(n), "mask": torch.ones(n)}
    batch = {k: v.cuda() for k, v in batch.items()}
    out = {}
    for name in ("sgd", "adam"):
        net = head_net(spec)
        net.load_state_dict(params_from_jax(spec, {"layers": [
            {"w": g["w0_k0"][0, 0], "b": g["w0_b0"]},
            {"w": g["w0_k1"][0, 0], "b": g["w0_b1"]}]}))
        opt = make_optimizer(TrainConfig(optimizer=name, learning_rate=0.01),
                             net.parameters())
        got = []
        for _ in range(6):
            opt.zero_grad()
            loss, mae = _loss_and_metrics(net, batch, None, 1e-3)
            loss.backward()
            opt.step()
            got.append((loss.item(), mae.item()))
        want = np.stack([g[f"loss_{name}"], g[f"mae_{name}"]], axis=1)
        rel = float(np.abs(np.asarray(got) / want - 1.0).max())
        if not rel <= KERAS_RTOL:
            raise AssertionError(f"keras trajectory {name}: rel {rel}")
        out[name] = {"max_rel_err": rel}
    return out


def train_twice(tag, cfg, ds, spec=None) -> dict:
    """fit on the card and on the CPU with the same seeds: per-epoch losses
    held at TRAIN_LOSS_RTOL; wall ms per epoch of each."""
    from headpose_tpu_torch.train import fit

    runs, walls = {}, {}
    for device in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[device] = fit(cfg.replace(run_name=f"{tag}-{device}"), ds,
                           spec=spec, device=device)
        torch.cuda.synchronize()
        walls[device] = (time.perf_counter() - t0) * 1e3 / len(
            runs[device].history)
    card, cpu = runs["cuda"].history, runs["cpu"].history
    if len(card) != len(cpu) or len(card) != cfg.total_epochs:
        raise AssertionError(f"epochs run: card {len(card)}, cpu {len(cpu)}")
    gap = {}
    for key in ("train_loss", "val_loss"):
        a = np.array([h[key] for h in card])
        b = np.array([h[key] for h in cpu])
        gap[key] = float(np.abs(a / b - 1.0).max())
        if not (np.isfinite(a).all() and gap[key] <= TRAIN_LOSS_RTOL):
            raise AssertionError(f"fit {key}: card vs CPU rel {gap[key]}")
    return {"result": runs["cuda"], "epoch_ms": walls,
            "max_rel_gap": gap, "best_epoch": runs["cuda"].best_epoch,
            "val_loss_first_last": [card[0]["val_loss"],
                                    card[-1]["val_loss"]]}


def phase_train(corpus, card, seed: int, keep_rows: str | None = None):
    """Head training end to end on the card: (a) features extracted from the
    corpus (card against CPU, and the self-consistency of the pose lookup);
    (b) two heads trained 20 epochs on 16,384 distillation rows, card
    against CPU, and the Keras golden trajectory; (c) the trained head96
    exported, joined to the flagship and served through detect, detect_fused
    and "fast" with its launches counted; (d) the 14 shipped heads
    evaluated, card against CPU.  Returns the launch counts of (c)."""
    import shutil
    import tempfile

    from headpose_tpu_torch.data import Dataset, load_dataset
    from headpose_tpu_torch.data import native
    from headpose_tpu_torch.models import MLPHead, join_models
    from headpose_tpu_torch.pretrained import (FLAGSHIP, HEADS,
                                               load_pretrained)
    from headpose_tpu_torch.runtime.detector import FaceDetector
    from headpose_tpu_torch.tools.evaluate import (evaluate_head_pose_model,
                                                   predict)
    from headpose_tpu_torch.tools.export import load_model, save_model
    from headpose_tpu_torch.tools.extract_features import FeatureExtractor
    from headpose_tpu_torch.train import config_96

    t_phase = time.perf_counter()
    report = {"phase": "train", "card": card, "seed": seed}
    imgs = corpus["imgs"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")

    # (a) extraction
    ext = FeatureExtractor()
    r = ext.extract(imgs)
    r_cpu = FeatureExtractor(device="cpu").extract(imgs)
    if not np.array_equal(r.found, r_cpu.found):
        raise AssertionError("extract: found differs from the CPU's")
    gaps = {k: float(np.abs(getattr(r, k) - getattr(r_cpu, k)).max())
            for k in ("features88", "features96", "scores")}
    if not all(v <= EXTRACT_TOL for v in gaps.values()):
        raise AssertionError(f"extract: card vs CPU {gaps}")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ext.extract(imgs)
        walls.append(time.perf_counter() - t0)
    flag_spec, flag_params = ext.model, ext.params
    per = FaceDetector(flag_spec, flag_params).detect(imgs).trim()
    self_err = 0.0
    found = np.flatnonzero(r.found)
    p88 = predict(flag_spec.head88, flag_params["head88"], r.features88)
    p96 = predict(flag_spec.head96, flag_params["head96"], r.features96)
    for i in found:
        best = per[i].poses[0]
        self_err = max(self_err, min(float(np.abs(p88[i] - best).max()),
                                     float(np.abs(p96[i] - best).max())))
    if not self_err <= SELF_POSE_TOL_DEG:
        raise AssertionError(f"extract: head on the vector vs detect "
                             f"{self_err}")
    report["extract"] = {"frames": len(imgs), "found": int(r.found.sum()),
                         "card_vs_cpu": gaps, "self_pose_deg": self_err,
                         "frames_per_s": len(imgs) / statistics.median(walls),
                         "wall_s": walls}

    # (b) training rows: extracted vectors + seeded noise, labelled by the
    # shipped heads (distillation, as distill96 was made)
    rng = np.random.default_rng(seed)
    rows = {}
    for c, head in ((96, "hrchr82r-96"), (88, "stoqa9pt-88")):
        base = getattr(r, f"features{c}")[found]
        x = (base[rng.integers(0, len(base), TRAIN_ROWS)]
             + rng.normal(0.0, 0.1, (TRAIN_ROWS, c))).astype(np.float32)
        spec, params = load_pretrained(head)
        rows[c] = Dataset(x, predict(spec, params, x, "cpu"))
    path = os.path.join(tmp, "rows96.npz")
    np.savez_compressed(path, features=rows[96].features,
                        poses=rows[96].poses)
    built = native.native_available()
    if built:
        got = native.load_npz_native(path)
        with np.load(path) as want:
            if any(got[k].tobytes() != want[k].tobytes() for k in want.files):
                raise AssertionError("native npz loader differs from np.load")
    ds = load_dataset(path)
    report["native_npz_loader"] = {"built": built,
                                   "bitwise_np_load": built or None}
    cfg = config_96(total_epochs=TRAIN_EPOCHS, seed=seed,
                    checkpoint_dir=os.path.join(tmp, "ck"))
    flagship_run = train_twice("config_96", cfg, ds)
    distill = train_twice("distill", cfg, ds,
                          spec=MLPHead(96, DISTILL_WIDTHS))
    report["fit"] = {name: {k: v for k, v in run.items() if k != "result"}
                     for name, run in (("config_96", flagship_run),
                                       ("distill96_width", distill))}
    report["keras_golden"] = keras_replay()

    # (c) export, join, serve
    trained = flagship_run["result"]
    save_model(os.path.join(tmp, "head96"), trained.spec, trained.params)
    spec96, params96 = load_model(os.path.join(tmp, "head96"))
    model, params = join_models(flag_spec.backbone, flag_params["backbone"],
                                flag_spec.head88, flag_params["head88"],
                                spec96, params96)
    save_model(os.path.join(tmp, "joined"), model, params)
    highest = FaceDetector.from_native(os.path.join(tmp, "joined"))
    fast = FaceDetector.from_native(os.path.join(tmp, "joined"),
                                    precision="fast")
    paths = {"detect": highest.detect, "detect_fused": highest.detect_fused,
             "fast": fast.detect}
    for fn in paths.values():
        fn(imgs[:8])                          # warm, and build
    want = {"detect": {"postprocess": 1},
            "detect_fused": {"backbone_forward": 1, "mlp_head": 2,
                             "postprocess": 1},
            "fast": {"apply_fused": 1, "mlp_head": 2,
                     "postprocess": 1}}
    want_names = {"detect": {"cta_kernel": 1},
                  "detect_fused": {"stem": 1, "mlp_head": 2, "cta_kernel": 1},
                  "fast": {"mlp_head": 2, "cta_kernel": 1}}
    outs, launches, kernels = {}, {}, {}
    for name, fn in paths.items():
        torch.cuda.synchronize()
        library.reset_launches()              # this path's window opens
        outs[name] = fn(imgs)
        torch.cuda.synchronize()
        launches[name] = library.launches()   # ... and closes
        least = dict(want_names[name], **(
            {"split_bf16": 1} if name == "fast" else {}))
        kernels[name] = kernel_names_per_call(lambda: fn(imgs), want=least)
    for name in paths:
        bad = {k: launches[name][k] for k, v in want[name].items()
               if launches[name][k] != v}
        bad.update({k: kernels[name].get(k, 0)
                    for k, v in want_names[name].items()
                    if kernels[name].get(k, 0) != v})
        if name == "fast" and not kernels[name].get("split_bf16"):
            bad["split_bf16"] = 0
        if bad:
            raise AssertionError(f"serve {name}: launches {bad}")
    module = outs["detect"].trim()
    check_sets(module, corpus)
    serve = {"detect": {"detections": int(outs["detect"].valid.sum())}}
    serve["detect_fused"] = pose_gap(outs["detect_fused"], outs["detect"],
                                     dict(rtol=0.0, atol=JOINED_POSE_TOL_DEG))
    if serve["detect_fused"]["tolerance_ratio"] > 1.0:
        raise AssertionError(f"detect_fused vs detect {serve}")
    fast_per = outs["fast"].trim()
    check_sets(fast_per, corpus)
    serve["fast"] = pose_gap(outs["fast"], outs["detect"],
                             dict(rtol=0.0, atol=PARITY_BUDGET_DEG))
    if serve["fast"]["tolerance_ratio"] > 1.0:
        raise AssertionError(f"fast vs detect {serve}")
    report["serve"] = {**serve, "launches": launches, "kernels": kernels}

    # (d) the shipped heads, card against CPU
    evals = {}
    for name in HEADS:
        spec, params = load_pretrained(name)
        ds_c = rows[spec.in_features]
        got = evaluate_head_pose_model(spec, ds_c, params=params,
                                       verbose=False)
        ref = evaluate_head_pose_model(spec, ds_c, params=params,
                                       verbose=False, device="cpu")
        worst = 0.0
        for kind in ("MAE", "MSE"):
            # an MSE moves by about 2 |err| per unit of pose difference
            scale = (1.0 if kind == "MAE"
                     else max(2 * ref["MAE"]["average"], 1.0))
            worst = max(worst, max(abs(got[kind][k] - v) / scale
                                   for k, v in ref[kind].items()))
        if not worst <= EVAL_TOL_DEG:
            raise AssertionError(f"evaluate {name}: card vs CPU {worst}")
        evals[name] = {"mae_avg": got["MAE"]["average"],
                       "max_gap_deg": worst}
    report["evaluate"] = evals
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    if keep_rows:                 # the parallel phase trains on them too
        shutil.copy(path, keep_rows)
    shutil.rmtree(tmp)
    return {name: launches[name] for name in paths}


# detector training (train.detector, train.calibrate) at full width
DT_COMPARE = 10               # the first steps of each trainer on the CPU
DT_FIT_STEPS = 300            # (a) on the card: enough to halve the loss
DT_FIT_IMAGES, DT_FIT_BATCH = 1024, 64
DT_PREFIX_STEPS = 100         # (b) distill_prefix on the card
DT_DISTILL_STEPS = 100        # (b) distill_detector on the card
DT_DISTILL_IMAGES, DT_DISTILL_BATCH = 512, 32
DT_CALIB_STEPS = 36           # (c) calibrate_fast_params on the card
DT_CALIB_BATCH = 64
DT_SERVE_FRAMES = 16
# 200 steps of front->back distillation on blob frames leave a detector
# that finds no face at the production threshold on corpus frames: it is
# held to the CPU at the threshold the e2e goldens were captured at, so
# that the sets are not empty
DT_LOW_THRESHOLD = 0.05
DT_BOX_TOL = 1e-5             # boxes and scores, card vs CPU at "highest"
DT_MATCH_TOL = 0.02           # a detection's box, card vs CPU, to pair it
# calibration's loss is the bf16 rounding residual of the island, carried
# by a few cells: moving every input pixel by one ulp moves it by percents
# on the CPU itself (PERF.md §6).  On the same images, the card's
# first 10 loss terms are held within twice that floor (the larger gap of
# one ulp up and one ulp down), measured in the same run, or
# TRAIN_LOSS_RTOL where the floor is lower; the exact targets, which no
# island rounds, within TRAIN_LOSS_RTOL
CALIB_FLOOR_FACTOR = 2.0
DT_POSE_TOL_DEG = 1e-3        # poses, card vs CPU at "highest"


def squares(n, size, seed):
    """Dark-noise frames with one bright square, its box and 6 keypoints (4
    corners, 2 edge midpoints): tests/test_detector_train.py::_squares and
    with_kps at `size`."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 60, size=(n, size, size, 3)).astype(np.uint8)
    boxes = np.zeros((n, 1, 4), np.float32)
    for i in range(n):
        s = rng.uniform(0.15, 0.6)
        cx = rng.uniform(s / 2, 1 - s / 2)
        cy = rng.uniform(s / 2, 1 - s / 2)
        boxes[i, 0] = [cx - s / 2, cy - s / 2, cx + s / 2, cy + s / 2]
        px = (boxes[i, 0] * size).astype(int)
        imgs[i, px[1]:px[3], px[0]:px[2]] = rng.integers(180, 256, size=3)
    x1, y1, x2, y2 = (boxes[..., i] for i in range(4))
    mx = (x1 + x2) / 2
    kps = np.stack([np.stack(p, -1) for p in (
        (x1, y1), (x2, y1), (x2, y2), (x1, y2), (mx, y1), (mx, y2))], -2)
    return imgs, boxes, np.ones((n, 1), np.float32), kps.astype(np.float32)


def blobs(n, size, seed):
    """Smooth blobs + noise (tests/test_detector_train.py TestDistill
    _images at `size`)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, size=(n, 4, 4, 3))
    imgs = np.repeat(np.repeat(base, size // 4, 1), size // 4, 2)
    imgs = imgs + rng.integers(-20, 20, size=(n, size, size, 3))
    return np.clip(imgs, 0, 255).astype(np.uint8)


def timed_run(run, card: bool = True) -> dict:
    """run(on_sync), a trainer, on the card (or the CPU): its params and
    history, the rate between the first and the last sync (steps/s,
    set-up excluded), the wall time and, on the card, the peak memory."""
    syncs = []
    if card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, hist = run(lambda done, m: syncs.append((done,
                                                    time.perf_counter())))
    wall = time.perf_counter() - t0
    (d0, t_0), (d1, t_1) = syncs[0], syncs[-1]
    return {"params": params, "history": hist, "wall_s": wall,
            "steps_per_s": (d1 - d0) / (t_1 - t_0) if d1 > d0 else None,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                  if card else None)}


def busy_share(run) -> dict:
    """run() (a short training call) under torch.profiler: the device's
    busy time (its kernels' summed durations) over the host's wall time,
    and the kernels launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.end - e.time_range.start for e in ev) / 1e6
    return {"wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall, "kernels": len(ev)}


def card_vs_cpu(card: dict, cpu: dict, what: str) -> dict:
    """Every loss term of the first DT_COMPARE steps within TRAIN_LOSS_RTOL
    of the CPU's, and every card loss finite."""
    gap = {}
    for k, v in cpu.items():
        if len(v) != DT_COMPARE:
            raise AssertionError(f"{what}: the CPU ran {len(v)} steps")
        a = np.asarray(card[k][:DT_COMPARE], np.float64)
        gap[k] = float(np.abs(a / v - 1.0).max())
        if not (np.isfinite(card[k]).all() and gap[k] <= TRAIN_LOSS_RTOL):
            raise AssertionError(f"{what} {k}: card vs CPU rel {gap[k]}")
    return gap


def served_vs_cpu(model, params, precision, imgs, want, what: str,
                  threshold: float = 0.4, empty_ok: bool = False):
    """model at `precision` and `threshold` on the card, in its own launch
    window, against the same model on the port's CPU detector, image by
    image; the launches exactly `want`.  At "highest" and "fast":
    identical detection sets (each CPU box matched to the card's nearest
    one, within DT_MATCH_TOL: two faces of near-equal scores may take each
    other's slot, and a detector this young gives degenerate boxes); over
    the matched pairs, at "highest" boxes and scores within DT_BOX_TOL and
    poses within DT_POSE_TOL_DEG, at "fast" poses within
    BACK_FAST_POSE_TOL_DEG (the back phase's bound, card vs the CPU's
    "fast"); at least one detection unless `empty_ok`.  At "turbo" the
    turbo phase's rule (`turbo_vs_cpu`).  Returns (report, launches, the
    card's detector)."""
    from headpose_tpu_torch.runtime.detector import FaceDetector

    det = FaceDetector(model, params, threshold, precision=precision)
    det.detect(imgs[:2])                      # warm, and build
    got, counts = launch_window(det.detect, imgs)
    check_counts(counts, want, f"{what} {precision}")
    ref = FaceDetector(model, params, threshold, precision=precision,
                       device="cpu").detect(imgs)
    if precision == "turbo":
        out = turbo_vs_cpu(got.trim(), ref.trim(), threshold, what)
        out["launches"] = counts
        return out, counts, det
    errs = {"boxes": 0.0, "scores": 0.0, "poses": 0.0}
    matched = 0
    for i, (g, r) in enumerate(zip(got.trim(), ref.trim())):
        if len(g.boxes) != len(r.boxes):
            raise AssertionError(f"{what} {precision}: image {i}: scores "
                                 f"{g.scores} on the card, {r.scores} on "
                                 "the CPU")
        free = list(range(len(g.boxes)))
        for ri in range(len(r.boxes)):      # the nearest box not yet taken
            d = [float(np.abs(g.boxes[oi] - r.boxes[ri]).max())
                 for oi in free]
            if min(d) > DT_MATCH_TOL:
                raise AssertionError(f"{what} {precision}: image {i}: the "
                                     f"CPU's box {r.boxes[ri]} is {min(d)} "
                                     "from the card's nearest")
            oi = free.pop(int(np.argmin(d)))
            for k in errs:
                errs[k] = max(errs[k], float(np.abs(
                    getattr(g, k)[oi] - getattr(r, k)[ri]).max()))
        matched += len(r.boxes)
    pose_tol = {"highest": DT_POSE_TOL_DEG,
                "fast": BACK_FAST_POSE_TOL_DEG}[precision]
    out = {"score_threshold": threshold, "detections": matched,
           "max_abs_diff": errs,
           "slots_identical": bool(torch.equal(got.valid.cpu(), ref.valid)),
           "pose_tol_deg": pose_tol, "launches": counts}
    if not ((matched or empty_ok) and errs["poses"] <= pose_tol and (
            precision != "highest"
            or max(errs["boxes"], errs["scores"]) <= DT_BOX_TOL)):
        raise AssertionError(f"{what} {precision}: card vs CPU {out}")
    return out, counts, det


def turbo_vs_cpu(got, ref, threshold: float, what: str) -> dict:
    """The card's "turbo" detections `got` against the CPU's `ref` (trimmed
    Results) by the turbo phase's rule, the CPU's taken as the reference:
    every face matched one to one at IoU > 0.5 (certify_modes.match_image,
    the certificate's matching), pose p99 of the pairs within
    TURBO_POSE_P99_DEG.  The two sides' scores differ by the island's
    rounding (about 1e-3), so a face one side alone reports passes when its
    score lies within that noise of the threshold: within the largest score
    gap of the matched pairs.  Matching by IoU and a p99 take in a face
    whose two best anchors score within that noise: the sides may report
    different anchors of it, from another cell or grid, whose poses differ
    by degrees."""
    from headpose_tpu_torch.tools.certify_modes import dist, match_image

    gaps, poses, lone = [], [], []
    for i, (g, r) in enumerate(zip(got, ref)):
        pairs, _ = match_image({"boxes": r.boxes, "scores": r.scores}, g)
        gaps += [abs(float(r.scores[a]) - float(g.scores[b]))
                 for a, b in pairs]
        poses += [float(np.abs(r.poses[a] - g.poses[b]).max())
                  for a, b in pairs]
        lone += [(i, "cpu", float(s)) for a, s in enumerate(r.scores)
                 if a not in {p[0] for p in pairs}]
        lone += [(i, "card", float(s)) for b, s in enumerate(g.scores)
                 if b not in {p[1] for p in pairs}]
    noise = max(gaps, default=0.0)
    out = {"score_threshold": threshold, "frames": len(ref),
           "detections": len(poses), "one_sided": lone,
           "score_noise": noise, "pose_deg": dist(poses),
           "pose_p99_tol_deg": TURBO_POSE_P99_DEG}
    if not (poses and all(s - threshold <= noise for _, _, s in lone)
            and out["pose_deg"]["p99"] <= TURBO_POSE_P99_DEG):
        raise AssertionError(f"{what} turbo: card vs CPU {out}")
    return out


def phase_detector_train(corpus, card, seed: int):
    """Detector training at full width on the card (the docstring's
    `detector_train` entry).  Returns {window: launch counts}."""
    report = {"phase": "detector_train", "card": card, "seed": seed}
    try:
        windows = detector_train(report, corpus, seed)
    except BaseException:
        emit(report)                  # what ran, then the failure
        raise
    emit(report)
    return windows


def rel_gaps(got: dict, want: dict) -> dict:
    """Each history key's largest relative gap |got / want - 1|."""
    return {k: float(np.abs(np.asarray(got[k], np.float64) / v - 1.0).max())
            for k, v in want.items()}


def calibration_targets(model, params, x, device) -> dict:
    """calibrate_fast_params' targets of one batch x (CPU) on `device`: the
    exact fp32 forward (TF32 off) of the original params, scores
    post-sigmoid, as float64 numpy arrays."""
    from headpose_tpu_torch.core.single_pass import fp32_exact
    from headpose_tpu_torch.models.unified import UnifiedPoseNet
    from headpose_tpu_torch.models.params import params_from_jax

    net = UnifiedPoseNet(model, device=device).eval()
    net.load_state_dict(params_from_jax(model, params))
    with torch.no_grad(), fp32_exact():
        out = net(x.to(net.backbone.stem.weight.device))
    out["scores"] = torch.sigmoid(out["scores"])
    return {k: out[k].cpu().numpy().astype(np.float64)
            for k in ("pose_front", "pose_back", "scores", "loc")}


def trained_report(card: dict, cpu: dict, what: str, **fields) -> dict:
    """A trainer's line: its recipe `fields`, first and last loss, the
    card-vs-CPU gaps (raising beyond TRAIN_LOSS_RTOL), rates and memory."""
    loss = card["history"]["loss"]
    return {**fields, "steps": len(loss),
            "loss_first_last": [float(loss[0]), float(loss[-1])],
            "card_vs_cpu_rel": card_vs_cpu(card["history"], cpu["history"],
                                           what),
            "steps_per_s": {"card": card["steps_per_s"],
                            "cpu": cpu["steps_per_s"]},
            "wall_s": {"card": card["wall_s"],
                       f"cpu_{DT_COMPARE}_steps": cpu["wall_s"]},
            "peak_memory_bytes": card["peak_memory_bytes"]}


def detector_train(report, corpus, seed: int) -> dict:
    """phase_detector_train's body: fills `report` as it goes."""
    from headpose_tpu_torch.models import (BLAZEFACE_BACK, BLAZEFACE_FRONT,
                                           TURBO_FAST_BLOCKS, join_models)
    from headpose_tpu_torch.pretrained import FLAGSHIP, load_pretrained
    from headpose_tpu_torch.runtime.detector import FaceDetector
    from headpose_tpu_torch.tools.certify_modes import certify_parity
    from headpose_tpu_torch.models.params import flatten_params
    from headpose_tpu_torch.train import calibrate, detector

    t_phase = time.perf_counter()
    flag_spec, flag_params = load_pretrained(FLAGSHIP)
    teacher = flag_params["backbone"]
    imgs = corpus["imgs"][:DT_SERVE_FRAMES]
    windows = {}
    fast_want = {"apply_fused": 1, "mlp_head": 2,
                 "postprocess": 1}

    def serve(name, spec, params, frames, threshold, empty_ok=False):
        """The trained backbone joined to the flagship's heads, served at
        "highest" and "fast" against the CPU."""
        model, joined = join_models(
            spec, params, flag_spec.head88, flag_params["head88"],
            flag_spec.head96, flag_params["head96"])
        out = {}
        for precision, want in (("highest", {"postprocess": 1}),
                                ("fast", fast_want)):
            out[precision], windows[f"{name}_{precision}"], _ = \
                served_vs_cpu(model, joined, precision, frames, want, name,
                              threshold, empty_ok)
        return out

    # (a) supervised: fit_detector(BLAZEFACE_FRONT) on seeded squares
    sq, boxes, mask, kps = squares(DT_FIT_IMAGES, 128, seed)
    cfg_a = detector.DetectorFitConfig(
        steps=DT_FIT_STEPS, batch_size=DT_FIT_BATCH, warmup_steps=50,
        steps_per_sync=50, seed=seed)
    fit_args = (BLAZEFACE_FRONT, sq, boxes, mask)
    a = timed_run(lambda s: detector.fit_detector(
        *fit_args, cfg_a, keypoints=kps, kp_weight=1.0, on_sync=s))
    a_cpu = timed_run(lambda s: detector._fit_detector(
        *fit_args, dataclasses.replace(cfg_a, steps_per_sync=5),
        keypoints=kps, kp_weight=1.0, on_sync=s, device="cpu",
        stop=DT_COMPARE), card=False)
    loss = a["history"]["loss"]
    halving = [float(loss[:20].mean()), float(loss[-20:].mean())]
    report["fit_detector"] = trained_report(
        a, a_cpu, "fit_detector", spec="BLAZEFACE_FRONT", images=len(sq),
        batch=DT_FIT_BATCH, kp_weight=1.0, loss_mean_first_last_20=halving)
    report["fit_detector"]["profiled_50_steps"] = busy_share(
        lambda: detector.fit_detector(
            *fit_args, dataclasses.replace(cfg_a, steps=50),
            keypoints=kps, kp_weight=1.0))
    if not halving[1] < 0.5 * halving[0]:
        raise AssertionError(f"fit_detector: the mean loss went {halving} "
                             f"in {DT_FIT_STEPS} steps")
    held_out = squares(DT_SERVE_FRAMES, 128, seed + 1)[0]
    report["fit_detector"]["serve"] = {
        "corpus": serve("fit", BLAZEFACE_FRONT, a["params"], imgs, 0.4,
                        empty_ok=True),      # a square detector: no face
        "held_out_squares": serve("fit_squares", BLAZEFACE_FRONT,
                                  a["params"], held_out, 0.4)}

    # (b) distillation front -> back: warm start, prefix, whole network
    frames = blobs(DT_DISTILL_IMAGES, 128, seed)
    ws = detector.warmstart_params(BLAZEFACE_BACK, BLAZEFACE_FRONT, teacher,
                                   key=torch.Generator().manual_seed(seed))
    cfg_p = detector.DetectorDistillConfig(
        steps=DT_PREFIX_STEPS, batch_size=DT_DISTILL_BATCH,
        learning_rate=2e-3, warmup_steps=20, steps_per_sync=25, seed=seed)
    prefix_args = (BLAZEFACE_BACK, 0, BLAZEFACE_FRONT, -1, teacher, frames)
    p = timed_run(lambda s: detector.distill_prefix(
        *prefix_args, cfg_p, init_params=ws, on_sync=s))
    p_cpu = timed_run(lambda s: detector._distill_prefix(
        *prefix_args, dataclasses.replace(cfg_p, steps_per_sync=5),
        init_params=ws, on_sync=s, device="cpu", stop=DT_COMPARE),
        card=False)
    report["distill_prefix"] = trained_report(
        p, p_cpu, "distill_prefix", images=len(frames),
        batch=DT_DISTILL_BATCH, taps="student 0, teacher -1")
    got, start = flatten_params(p["params"]), flatten_params(ws)
    moved = [k for k in start if not np.array_equal(got[k], start[k])]
    report["distill_prefix"]["moved_leaves"] = moved
    if not moved or any(not k.startswith(("stem/", "blocks/0/"))
                        for k in moved):
        raise AssertionError(f"distill_prefix moved {moved} (the stem and "
                             "block 0 only may move)")
    # at lr 4e-4 the card's and the CPU's trajectories part by up to 1.2e-3
    # in 10 steps (Adam turns gradients whose last bits differ into
    # lr-sized steps; PERF.md §6), at 1e-4 by at most 5.7e-5
    cfg_d = detector.DetectorDistillConfig(
        steps=DT_DISTILL_STEPS, batch_size=DT_DISTILL_BATCH,
        learning_rate=1e-4, warmup_steps=20, steps_per_sync=25, seed=seed,
        feat_cell_eps=0.2)
    distill_args = (BLAZEFACE_BACK, BLAZEFACE_FRONT, teacher, frames)
    d = timed_run(lambda s: detector.distill_detector(
        *distill_args, cfg_d, init_params=p["params"], on_sync=s))
    d_cpu = timed_run(lambda s: detector._distill_detector(
        *distill_args, dataclasses.replace(cfg_d, steps_per_sync=5),
        init_params=p["params"], on_sync=s, device="cpu", stop=DT_COMPARE),
        card=False)
    report["distill_detector"] = trained_report(
        d, d_cpu, "distill_detector", images=len(frames),
        batch=DT_DISTILL_BATCH, feat_cell_eps=0.2)
    report["distill_detector"]["profiled_50_steps"] = busy_share(
        lambda: detector.distill_detector(
            *distill_args, dataclasses.replace(cfg_d, steps=50),
            init_params=p["params"]))
    report["distill_detector"]["serve"] = serve(
        "distill", BLAZEFACE_BACK, d["params"], imgs, DT_LOW_THRESHOLD)

    # (c) calibration of the flagship's "turbo" island
    calib = dict(steps=DT_CALIB_STEPS, batch=DT_CALIB_BATCH,
                 learning_rate=1e-5, fast_blocks=TURBO_FAST_BLOCKS,
                 seed=seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params_c, hist_c = calibrate.calibrate_fast_params(flag_spec, flag_params,
                                                       **calib)
    wall_c = time.perf_counter() - t0
    peak_c = torch.cuda.max_memory_allocated()
    # the card's first DT_COMPARE batches, synthesized once on the card as
    # its run draws them and handed bitwise to the card and the CPU
    gen = torch.Generator().manual_seed(seed)
    x = torch.stack([calibrate.synthesize_images(gen, DT_CALIB_BATCH, 128)
                     for _ in range(DT_COMPARE)]).cpu()
    given = dict(calib, loss_weights=(1.0, 1.0, 10.0, 0.1), stop=DT_COMPARE)
    _, hist_c_given = calibrate._calibrate(flag_spec, flag_params, images=x,
                                           device=None, **given)
    t0 = time.perf_counter()
    _, hist_c_cpu = calibrate._calibrate(flag_spec, flag_params, images=x,
                                         device="cpu", **given)
    wall_c_cpu = time.perf_counter() - t0
    # the objective's own noise floor: the CPU again with every pixel one
    # ulp up, and one ulp down; its loss is a bf16 rounding residual,
    # carried by a few cells
    ulp = [calibrate._calibrate(
        flag_spec, flag_params, images=torch.nextafter(x, torch.tensor(v)),
        device="cpu", **given)[1] for v in (np.inf, -np.inf)]
    # what the island's rounding does not touch: the exact fp32 targets of
    # the first batch, card vs CPU, relative to each output's largest value
    targets = {dev: calibration_targets(flag_spec, flag_params, x[0], dev)
               for dev in (None, "cpu")}
    report["calibrate"] = {
        "model": FLAGSHIP, "fast_blocks": list(TURBO_FAST_BLOCKS),
        "steps": DT_CALIB_STEPS, "batch": DT_CALIB_BATCH,
        "learning_rate": 1e-5,
        "loss_first_last": [float(hist_c["loss"][0]),
                            float(hist_c["loss"][-1])],
        "loss_history": [float(v) for v in hist_c["loss"]],
        "steps_per_s_with_setup": {"card": DT_CALIB_STEPS / wall_c,
                                   "cpu": DT_COMPARE / wall_c_cpu},
        "peak_memory_bytes": peak_c,
        "profiled_10_steps": busy_share(
            lambda: calibrate.calibrate_fast_params(
                flag_spec, flag_params, **dict(calib, steps=10)))}
    rc = report["calibrate"]
    rc["card_vs_cpu_rel"] = rel_gaps(hist_c_given, hist_c_cpu)
    rc["cpu_one_ulp_rel"] = {k: max(rel_gaps(h, hist_c_cpu)[k] for h in ulp)
                             for k in hist_c_cpu}
    # a reading: the card's own run (images synthesized on the card)
    # against the same images given
    rc["card_synthesized_vs_given_rel"] = rel_gaps(
        {k: v[:DT_COMPARE] for k, v in hist_c.items()}, hist_c_given)
    rc["targets_card_vs_cpu_rel"] = {
        k: float(np.abs(targets[None][k] - v).max() / np.abs(v).max())
        for k, v in targets["cpu"].items()}
    for k, gap in rc["card_vs_cpu_rel"].items():
        bound = max(TRAIN_LOSS_RTOL,
                    CALIB_FLOOR_FACTOR * rc["cpu_one_ulp_rel"][k])
        if not (np.isfinite(hist_c[k]).all() and gap <= bound):
            raise AssertionError(f"calibrate {k}: card vs CPU rel {gap}, "
                                 f"bound {bound}")
    for k, gap in rc["targets_card_vs_cpu_rel"].items():
        if not gap <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"calibrate targets {k}: card vs CPU rel "
                                 f"{gap}")
    for name in ("head88", "head96"):
        if params_c[name] is not flag_params[name]:
            raise AssertionError(f"calibration replaced {name}")
    turbo_want = {"apply_fused": 1, "dense_chain": 1, "mlp_head": 2,
                  "postprocess": 1}
    report["calibrate"]["serve"], windows["calibrated_turbo"], det_c = \
        served_vs_cpu(flag_spec, params_c, "turbo", corpus["imgs"],
                      turbo_want, "calibrated")
    report["calibrate"]["turbo_corpus_pose_p99_deg_reading"] = {
        name: certify_parity(det.detect, corpus)["pose_deg"]["p99"]
        for name, det in (("calibrated", det_c),
                          ("uncalibrated", FaceDetector(
                              flag_spec, flag_params, precision="turbo")))}
    report["phase_s"] = time.perf_counter() - t_phase
    return windows


H5_DIR = os.path.join(HERE, "tests", "golden_torch")
H5_NAMES = ("flagship_joined", "se_transformer_head", "head96")
H5_SCORE_TOL = 1e-5            # tests/test_detection.py:194-207
H5_POSE_TOL_DEG = 1e-3
H5_CONVERT_TOL = 1e-5          # the reference's validate_conversion bar
H5_SUSTAINED_ITERS = 500


def h5_twin(name: str):
    """The ModelDef of a fixture's h5py-free twin (<name>_config.json +
    <name>_weights.npz) through core.h5io._model_from_parts."""
    from headpose_tpu_torch.core.h5io import _model_from_parts

    with open(os.path.join(H5_DIR, f"{name}_config.json")) as f:
        config = json.load(f)
    with np.load(os.path.join(H5_DIR, f"{name}_weights.npz")) as w:
        return _model_from_parts(config, {k: w[k] for k in w.files})


def same_modeldef(a, b, where: str) -> int:
    """Raise unless two ModelDefs have the same layers, configs, inbound
    and weights (bitwise), nested submodels too; returns the arrays
    compared."""
    if (a.order != b.order or a.inputs != b.inputs or a.outputs != b.outputs
            or a.keras3 != b.keras3):
        raise AssertionError(f"{where}: graphs differ")
    n = 0
    for name in a.order:
        la, lb = a.layers[name], b.layers[name]
        if (la.class_name, la.config, la.inbound, la.call_kwargs) != \
                (lb.class_name, lb.config, lb.inbound, lb.call_kwargs):
            raise AssertionError(f"{where}/{name}: layer differs")
        if list(la.weights) != list(lb.weights) or any(
                la.weights[k].tobytes() != lb.weights[k].tobytes()
                for k in la.weights):
            raise AssertionError(f"{where}/{name}: weights differ")
        n += len(la.weights)
        if (la.submodel is None) != (lb.submodel is None):
            raise AssertionError(f"{where}/{name}: submodel differs")
        if la.submodel is not None:
            n += same_modeldef(la.submodel, lb.submodel, f"{where}/{name}")
    return n


def launch_window(fn, imgs):
    """fn(imgs) with every launch count set to 0 just before and read just
    after: (result, counts)."""
    torch.cuda.synchronize()
    library.reset_launches()
    out = fn(imgs)
    torch.cuda.synchronize()
    return out, library.launches()


def check_counts(counts: dict, want: dict, what: str) -> None:
    """The named kernels launched exactly as `want`, every other kernel
    (but backbone2_segment, counted beside apply_fused) not at all."""
    bad = {k: n for k, n in counts.items()
           if k != "backbone2_segment" and n != want.get(k, 0)}
    if bad:
        raise AssertionError(f"{what}: launches {bad}, want {want}")


def phase_h5(flagship, corpus, frames128, card):
    """The H5 graph compiler and loaders on the card (the docstring's
    `h5` entry).  Returns {kernel: {window: launches}}."""
    import shutil
    import tempfile

    from headpose_tpu_torch.compat import blazeFaceDetector
    from headpose_tpu_torch.core.h5io import read_model
    from headpose_tpu_torch.models import (join_models,
                                           se_transformer_from_h5)
    from headpose_tpu_torch.models.heads import head_from_h5
    from headpose_tpu_torch.pretrained import (FLAGSHIP, PRETRAINED_DIR,
                                               load_pretrained)
    from headpose_tpu_torch.runtime.detector import FaceDetector
    from headpose_tpu_torch.tools.convert import validate_conversion
    from headpose_tpu_torch.tools.export import save_model
    from headpose_tpu_torch.tools.join_cli import join_and_save
    from headpose_tpu_torch.utils.profiling import (
        staged_uint8_frames, sustained_seconds_per_dispatch)

    t_phase = time.perf_counter()
    try:
        import h5py
        h5py_version = h5py.__version__
    except ImportError:
        h5py_version = None
    report = {"phase": "h5", "card": card, "h5py": h5py_version}

    # 1. the sources: the twin always, the .h5 file where h5py imports
    twins = {name: h5_twin(name) for name in H5_NAMES}
    if h5py_version is not None:
        arrays = {name: same_modeldef(read_model(os.path.join(
            H5_DIR, f"{name}.h5")), twins[name], name) for name in H5_NAMES}
        report["h5_file"] = {"read_model_equals_twin": True,
                             "arrays": arrays}
        source = {name: os.path.join(H5_DIR, f"{name}.h5")
                  for name in H5_NAMES}
    else:
        report["h5_file"] = "not run: h5py absent"
        source = twins
    imgs = corpus["imgs"]
    windows: dict[str, dict] = {}

    # 2. the native import, bitwise the flagship on each path
    flag_spec, flag_params = load_pretrained(FLAGSHIP)
    det = FaceDetector.from_h5(source["flagship_joined"])
    fast = FaceDetector.from_h5(source["flagship_joined"], precision="fast")
    ref_fast = FaceDetector(flag_spec, flag_params, precision="fast")
    paths = {"detect": (det.detect, flagship.detect,
                        {"postprocess": 1}),
             "fast": (fast.detect, ref_fast.detect,
                      {"apply_fused": 1, "mlp_head": 2,
                       "postprocess": 1}),
             "detect_fused": (det.detect_fused, flagship.detect_fused,
                              {"backbone_forward": 1, "mlp_head": 2,
                               "postprocess": 1})}
    native = {}
    for name, (fn, ref, want) in paths.items():
        fn(imgs[:8])                          # warm, and build
        got, counts = launch_window(fn, imgs)
        check_counts(counts, want, f"from_h5 {name}")
        if not torch.equal(got.slab, ref(imgs).slab):
            raise AssertionError(f"from_h5 {name}: slab differs from the "
                                 "flagship's")
        windows[f"from_h5_{name}"] = counts
        native[name] = {"bitwise_flagship": True,
                        "detections": int(got.valid.sum())}
    report["from_h5"] = native

    # 3. the graph compiler on the card
    compat = FaceDetector.from_h5_compat(source["flagship_joined"])
    with torch.inference_mode():
        outs = compat.net.graph(frames128)
        want = flagship.net.reference_outputs(frames128)
    ratios = [close(o, w, **BACKBONE_TOL)[1] for o, w in zip(outs, want)]
    if not max(ratios) <= 1.0:
        raise AssertionError(f"from_h5_compat outputs: ratios {ratios}")
    compat.detect(imgs[:8])
    got, counts = launch_window(compat.detect, imgs)
    check_counts(counts, {"postprocess": 1}, "from_h5_compat detect")
    windows["from_h5_compat"] = counts
    ref = flagship.detect(imgs)
    if not torch.equal(got.valid, ref.valid):
        raise AssertionError("from_h5_compat: detection sets differ")
    m = ref.valid
    score_err = float((got.scores[m] - ref.scores[m]).abs().max())
    pose_err = float((got.poses[m] - ref.poses[m]).abs().max())
    if not (score_err <= H5_SCORE_TOL and pose_err <= H5_POSE_TOL_DEG):
        raise AssertionError(f"from_h5_compat vs flagship: score "
                             f"{score_err}, pose {pose_err}")
    parity = corpus_parity(got.trim(), corpus, "h5_compat")
    del parity["phase"]
    try:
        FaceDetector.from_h5_compat(source["flagship_joined"],
                                    precision="fast")
        raise AssertionError("from_h5_compat served precision='fast'")
    except ValueError as e:
        if "native backbone spec" not in str(e):
            raise
    report["from_h5_compat"] = {
        "outputs_tolerance_ratio": max(ratios),
        "outputs_max_abs_err": max(close(o, w, **BACKBONE_TOL)[0]
                                   for o, w in zip(outs, want)),
        "score_max_abs_diff": score_err, "pose_max_abs_diff": pose_err,
        "parity": parity, "fast_refused": True}

    # 4. the SE-Transformer head from H5, joined, through kernel #5
    spec88, params88 = se_transformer_from_h5(source["se_transformer_head"])
    model, params = join_models(flag_spec.backbone, flag_params["backbone"],
                                spec88, params88, flag_spec.head96,
                                flag_params["head96"])
    se = FaceDetector(model, params, head_eval="map")
    se.detect_fused(imgs[:8])
    got, counts = launch_window(se.detect_fused, imgs)
    check_counts(counts, {"backbone_forward": 1, "se_transformer": 1,
                          "mlp_head": 1, "postprocess": 1},
                 "SE head detect_fused")
    windows["se_head_detect_fused"] = counts
    cpu = FaceDetector(model, params, head_eval="map",
                       device="cpu").detect_fused(imgs[:16])
    card_16 = se.detect_fused(imgs[:16])
    gap = pose_gap(card_16, cpu, SE_POSE_TOL)
    if gap["tolerance_ratio"] > 1.0:
        raise AssertionError(f"SE head: card vs CPU {gap}")
    report["se_head"] = {"spec_reduction": spec88.reduction,
                         "detections": int(got.valid.sum()),
                         "card_vs_cpu": gap}

    # 5. conversion and joining
    spec96, params96 = head_from_h5(source["head96"])
    err = validate_conversion(source["head96"], spec96, params96)
    if not err <= H5_CONVERT_TOL:
        raise AssertionError(f"validate_conversion max err {err}")
    report["validate_conversion"] = {"max_abs_err": err}
    # join_and_save on the card (its contract forward at device=None): the
    # H5 files where h5py imports, else the twin's ModelDef as the detector
    # and head96 as a native directory
    tmp = tempfile.mkdtemp(prefix="chip_smoke_h5_")
    reg2 = source["head96"]
    if h5py_version is None:
        reg2 = os.path.join(tmp, "head96")
        save_model(reg2, spec96, params96)
    outs = [join_and_save(source["flagship_joined"],
                          os.path.join(PRETRAINED_DIR, "stoqa9pt-88"), reg2,
                          os.path.join(tmp, str(i)))
            for i in range(2)]
    slabs = [FaceDetector.from_native(o).detect(imgs).slab for o in outs]
    shutil.rmtree(tmp)
    if not (torch.equal(slabs[0], slabs[1])
            and torch.equal(slabs[0], ref.slab)):
        raise AssertionError("join_and_save: not the flagship's slabs")
    report["join_and_save"] = {
        "runs": 2, "bitwise_flagship": True,
        "detector": "h5 file" if h5py_version else "twin ModelDef"}
    try:                                  # the plain chain stays on the CPU
        FaceDetector(flag_spec, flag_params, postprocess="xla")
        raise AssertionError("postprocess='xla' served on the card")
    except ValueError as e:
        if "CPU only" not in str(e):
            raise
    report["xla_postprocess_refused"] = True

    # 6. the compat layer, and the sustained dispatch reading
    ref_det = blazeFaceDetector()
    for img in imgs[:16]:
        a, b = ref_det.detectFaces(img), flagship.detect_single(img)
        if len(a) != len(b) or any(
                not np.array_equal(getattr(a, k), getattr(b, k))
                for k in ("boxes", "keypoints", "scores", "poses")):
            raise AssertionError("compat detectFaces differs from "
                                 "detect_single")
    report["compat_detect_faces"] = {"frames": 16, "equal": True}
    staged = staged_uint8_frames(128, n_buffers=8)
    s = sustained_seconds_per_dispatch(ref_fast.detect, staged,
                                       iters=H5_SUSTAINED_ITERS)
    report["sustained_fast_detect_b128"] = {
        "seconds_per_dispatch": s, "frames_per_s": 128 / s,
        "iters": H5_SUSTAINED_ITERS, "buffers": 8, "card": card}
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    per_kernel: dict[str, dict] = {}
    for window, counts in windows.items():
        for kernel, n in counts.items():
            if n:
                per_kernel.setdefault(kernel, {})[window] = n
    return per_kernel


# ------------------------------------------------- deployment artifacts
# a replay may load only these of the port (tools/aot.py's claim)
AOT_ALLOWED = ("headpose_tpu_torch", "headpose_tpu_torch.tools",
               "headpose_tpu_torch.tools.aot", "headpose_tpu_torch.ops",
               "headpose_tpu_torch.ops.kernels",
               "headpose_tpu_torch.ops.kernels.library",
               "headpose_tpu_torch.ops.detection",
               "headpose_tpu_torch.runtime",
               "headpose_tpu_torch.runtime.results",
               "headpose_tpu_torch.utils", "headpose_tpu_torch.utils.build",
               "headpose_tpu_torch.utils.profiling")
# the ops a program holds, each counting its launches as on the source
AOT_OPS = ("postprocess", "backbone2_segment", "dense_block", "dense_chain",
           "mlp_head", "se_transformer")

_AOT_LOADER = """\
import json, sys, time

sys.path.insert(0, {here!r})


class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "headpose_tpu", "h5py"):
            raise ImportError(f"{{name}} blocked")
        return None


sys.meta_path.insert(0, _Block())

import numpy as np
import torch

import headpose_tpu_torch.tools.aot as aot

imgs = np.load({frames!r})
t0 = time.perf_counter()
torch.zeros(1, device="cuda")
cuda_init_s = time.perf_counter() - t0
slabs, load_s = {{}}, {{}}
for name, path in {artifacts!r}.items():
    t0 = time.perf_counter()
    det = aot.load_exported(path)
    for width in det.batch_sizes:
        det.program(width)
    load_s[name] = time.perf_counter() - t0
    slabs[name] = det.call(imgs).cpu().numpy()
    if name == "highest":
        for b in (1, 7):
            slabs[f"highest_b{{b}}"] = det.call(imgs[:b]).cpu().numpy()
torch.cuda.synchronize()
np.savez({out!r}, **slabs)
mods = sorted(m for m in sys.modules if m.startswith("headpose_tpu_torch"))
bad = [m for m in mods if m not in {allowed!r}]
bad += [m for m in sys.modules
        if m.split(".")[0] in ("jax", "jaxlib", "headpose_tpu", "h5py")]
assert not bad, bad
print(json.dumps({{"cuda_init_s": cuda_init_s, "load_s": load_s,
                  "modules": mods}}))
"""


def port_kernels(kinds: dict) -> dict:
    """The port's own kernels among kernel_kinds' counts (the cuDNN,
    cuBLAS and elementwise kernels of the plain ops dropped)."""
    own = ("split_bf16", "island", "island_chain", "stem", "mlp_head")
    named = ("cta_kernel", "block_kernel", "gate_kernel", "kv_kernel",
             "attend_kernel")
    return {k: n for k, n in kinds.items()
            if k in own or any(name in k for name in named)}


def settled_kinds(fn) -> dict:
    """kernel_kinds of the second of two warm fn() calls in one profiled
    window: the kernels after a spin kernel launched between them.  The
    profiler drops a window's first launches now and then, most often late
    in a long process (PERF.md §7: the aot phase, which comes last, lost
    the stem and the first segments of a B=128 `detect` so): the second
    call lies clear of the window's start.  {} when the marker itself went
    missing."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda._sleep(1000)
        fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA),
                key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(ev) if "spin_kernel" in e.name]
    return kernel_kinds(ev[marks[-1] + 1:]) if marks else {}


def port_kernels_alike(replay, source, more: int = 10) -> tuple:
    """port_kernels of both calls, each kind the most of 3 windows
    (settled_kinds).  The profiler drops an event now and then and never
    adds one, so while the two differ each takes up to `more` windows
    further, every kind the most over all its windows.  Returns (replay's,
    source's, windows each)."""
    a, b, windows = {}, {}, 0
    while windows < 3 or (a != b and windows < 3 + more):
        for fn, counts in ((replay, a), (source, b)):
            for kind, n in port_kernels(settled_kinds(fn)).items():
                counts[kind] = max(n, counts.get(kind, 0))
        windows += 1
    return a, b, windows


def aot_fresh_process(artifacts: dict, imgs, tmp: str) -> dict:
    """Every artifact loaded and replayed in a process of its own with jax,
    headpose_tpu and h5py blocked, which asserts that it loaded no module
    of the port outside AOT_ALLOWED: its slabs and load seconds."""
    frames = os.path.join(tmp, "frames.npy")
    out = os.path.join(tmp, "slabs.npz")
    np.save(frames, imgs)
    proc = subprocess.run(
        [sys.executable, "-c", _AOT_LOADER.format(
            here=HERE, frames=frames, artifacts=artifacts, out=out,
            allowed=AOT_ALLOWED)],
        capture_output=True, text=True, timeout=600, cwd=HERE)
    if proc.returncode != 0:
        raise AssertionError(f"aot: the fresh process failed:\n"
                             f"{proc.stderr[-3000:]}")
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    with np.load(out) as f:
        report["slabs"] = {k: f[k] for k in f.files}
    return report


def phase_aot(corpus, card):
    """The AOT artifacts (tools/aot.py) on the card: the flagship exported
    at "highest", "fast", "turbo" and "max" (widths 1 and 128),
    best_detector() and the SE-Transformer model (se_model) at "fast"
    (128).  For each: the port's op nodes of each program against the
    launches of the source's detect (one op per counted launch), the replay
    of the 128 main-path frames in its own launch window (every count as
    the source detect's) and by profiler kernel name (the port's kernels,
    port_kernels_alike, as the source's), its slab bit for bit the
    source's, and again after a load in a fresh process that loads no model
    code (aot_fresh_process); width 1 bitwise too where it is exported (the
    flagship's four modes); through the "highest" artifact B=1 bitwise and
    B=7 (the width-128 program, padded) bitwise the source's rows of the
    same padded batch and at the serve bounds (SERVE_TOL) of its B=7
    detect; the
    flagship's "fast" replay through the corpus parity gate; the http CLI
    over the "fast" artifact in its own process, 16 frames against direct
    detect.  Export and load seconds (the fresh process's first load also
    imports torch.export's loader), program bytes and the detect walls of
    source and replay (B=1 pads to 128 where 1 is not exported).  Returns
    {artifact: the replay window's launches}."""
    import tempfile

    from headpose_tpu_torch.ops.image import preprocess
    from headpose_tpu_torch.pretrained import best_detector, flagship_detector
    from headpose_tpu_torch.runtime.detector import FaceDetector
    from headpose_tpu_torch.runtime.results import BatchResults
    from headpose_tpu_torch.tools.aot import export_detector, load_exported

    imgs128 = np.concatenate([corpus["imgs"], corpus["imgs"][:16]])
    sources = {
        "highest": (flagship_detector(), (1, 128)),
        "fast": (flagship_detector(precision="fast"), (1, 128)),
        "turbo": (flagship_detector(precision="turbo"), (1, 128)),
        "max": (flagship_detector(precision="max"), (1, 128)),
        "best_fast": (best_detector(precision="fast"), (128,)),
        "se_fast": (FaceDetector(*se_model(), precision="fast"), (128,))}
    report = {"phase": "aot", "card": card, "frames": "128 main-path "
              "frames (the 112 corpus frames + the first 16), 128x128 uint8"}
    windows = {}
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, (det, widths) in sources.items():
            path = paths[name] = os.path.join(tmp, name)
            t0 = time.perf_counter()
            meta = export_detector(det, path, batch_sizes=widths)
            export_s = time.perf_counter() - t0
            want, source_counts = launch_window(det.detect, imgs128)
            aot = load_exported(path)
            got, counts = launch_window(aot.detect, imgs128)
            ops = meta["programs"]["128"]["ops"]
            want_ops = {op: source_counts[op] for op in AOT_OPS}
            have_ops = {op: ops.count(op) for op in want_ops}
            staged = torch.from_numpy(imgs128).to(det.device)
            kinds, source_kinds, profiled = port_kernels_alike(
                lambda: aot.detect(staged), lambda: det.detect(staged))
            entry = {
                "precision": meta["config"]["precision"],
                "head_eval": meta["config"]["head_eval"],
                "widths": meta["batch_sizes"], "export_s": export_s,
                "program_bytes": {
                    w: os.path.getsize(os.path.join(path, p["file"]))
                    for w, p in meta["programs"].items()},
                "ops_b128": ops, "launches": counts,
                "source_launches": source_counts, "kernels": kinds,
                "source_kernels": source_kinds,
                "profiled_windows": profiled,
                "bitwise_b128": torch.equal(got.slab, want.slab),
                "bitwise_b1": (torch.equal(aot.detect(imgs128[:1]).slab,
                                           det.detect(imgs128[:1]).slab)
                               if 1 in widths else None),
                "detect_wall": detect_walls(aot.detect, imgs128),
                "source_detect_wall": detect_walls(det.detect, imgs128)}
            report[name] = entry
            windows[name] = counts
            if have_ops != want_ops or counts != source_counts or \
                    kinds != source_kinds or not kinds:
                emit(report)
                raise AssertionError(
                    f"aot {name}: ops {have_ops} (want {want_ops}), "
                    f"launches {counts} (source {source_counts}), kernels "
                    f"{kinds} (source {source_kinds})")
            if not entry["bitwise_b128"] or entry["bitwise_b1"] is False:
                emit(report)
                raise AssertionError(f"aot {name}: the replayed slab differs "
                                     "from the source's at an exported "
                                     "width")
            if name == "highest":
                entry["launches_chunked"] = {
                    f"b{b}": launch_window(aot.detect, imgs128[:b])[1]
                    for b in (1, 7)}
                if any(n["postprocess"] != 1 or sum(n.values()) != 1
                       for n in entry["launches_chunked"].values()):
                    emit(report)
                    raise AssertionError(f"aot highest: chunked launches "
                                         f"{entry['launches_chunked']}")
            if name == "fast":
                parity = corpus_parity(aot.detect(corpus["imgs"]).trim(),
                                       corpus, "aot")
                del parity["phase"]
                entry["parity"] = parity
                entry["cli"] = serve_cli(det, list(corpus["imgs"]),
                                         ("--model", path))
                if entry["cli"]["errors"]:
                    raise AssertionError(f"aot cli: {entry['cli']}")
        fresh = aot_fresh_process(paths, imgs128, tmp)
    report["fresh_process"] = {k: fresh[k] for k in ("cuda_init_s",
                                                     "load_s", "modules")}
    for name, (det, _) in sources.items():
        want = det.detect(imgs128).slab.cpu().numpy()
        if not np.array_equal(fresh["slabs"][name], want):
            emit(report)
            raise AssertionError(f"aot {name}: the fresh process's slab "
                                 "differs from the source's")
    # chunked through the "highest" artifact: B=1 is its width 1; B=7 runs
    # the width-128 program over 7 frames and 121 zero frames, row for row
    # the source's detect of that padded batch; the source's own B=7 detect
    # sees another batch (cuDNN's convs choose by it), held at the serve
    # bounds
    high = sources["highest"][0]
    got1, got7 = fresh["slabs"]["highest_b1"], fresh["slabs"]["highest_b7"]
    padded = np.concatenate([imgs128[:7], np.zeros((121,) + imgs128.shape[1:],
                                                   np.uint8)])
    want7 = high.detect(imgs128[:7])
    chunked = {
        "b1": {"bitwise": bool(np.array_equal(
            got1, high.detect(imgs128[:1]).slab.cpu().numpy()))},
        "b7": {"bitwise_source_padded_rows": bool(np.array_equal(
            got7, high.detect(padded).slab[:7].cpu().numpy())),
            "bitwise_source_b7": bool(np.array_equal(
                got7, want7.slab.cpu().numpy())),
            "vs_direct_b7": served_vs_direct(
                BatchResults(torch.from_numpy(got7)).trim(), want7.trim())}}
    # where the source's B=7 detect parts from its padded batch's rows: the
    # network's outputs
    with torch.inference_mode():
        x = preprocess(torch.from_numpy(padded).to(high.device))
        rows, seven = high.net(x), high.net(x[:7])
    chunked["b7"]["network_max_abs_diff_b7_vs_padded_rows"] = {
        k: float((seven[k] - rows[k][:7]).abs().max())
        for k in ("feat88", "feat96", "scores", "loc", "pose_front",
                  "pose_back")}
    if not (chunked["b1"]["bitwise"]
            and chunked["b7"]["bitwise_source_padded_rows"]):
        report["highest_chunked"] = chunked
        emit(report)
        raise AssertionError("aot highest: a chunked replay differs from "
                             "the source's detect of the same rows")
    report["highest_chunked"] = chunked
    emit(report)
    return windows


def phase_edge(flagship, corpus, card):
    """The edge pipeline's host half on the card's host: the g++-built
    NativePostprocess (runtime/edge.py, native/postprocess.cpp) against
    kernel #1's slab on the flagship's outputs for the 128 main-path frames
    and on the kernels phase's fuzz (every case with max_faces > 0; the
    back model's anchors and 1/256 decode where the case says so): counts
    identical, boxes, keypoints and poses bit for bit, scores within 2e-7
    (a sigmoid ulp).  The versions of h5py and tensorflow (or null); where
    tensorflow imports, the flagship exported by export_unified_tflite and
    served by EdgeDetector on 16 corpus frames against the card's detect
    (sets identical, poses within 1e-3 deg)."""
    from headpose_tpu_torch.models.anchors import (BACK_CONFIG, FRONT_CONFIG,
                                                   generate_anchors)
    from headpose_tpu_torch.ops.detection import split_slab
    from headpose_tpu_torch.ops.image import preprocess
    from headpose_tpu_torch.ops.kernels.postprocess import postprocess_slab
    from headpose_tpu_torch.runtime.edge import (NativePostprocess,
                                                 native_available)

    if not native_available():
        raise AssertionError("edge: g++ could not build "
                             "native/postprocess.cpp")
    imgs128 = np.concatenate([corpus["imgs"], corpus["imgs"][:16]])
    with torch.inference_mode():
        o = flagship.net(preprocess(torch.from_numpy(imgs128).to(
            flagship.device)))
    cases = [dict(name="flagship_b128", thr=0.4, iou=0.3, mf=100,
                  inputs=[o[k].cpu().numpy() for k in ("scores", "loc",
                                                       "pose_front",
                                                       "pose_back")])]
    cases += [dict(c, inputs=fuzz_inputs(c["b"], c["seed"],
                                         c.get("loc_std", 8.0),
                                         c.get("bias", 0.0),
                                         c.get("quantize", False),
                                         c.get("nonfinite", False)))
              for c in FUZZ if c["mf"] > 0]
    report = {"phase": "edge", "card": card, "cases": {}}
    for c in cases:
        size = c.get("input_size", 128)
        anchors = generate_anchors(BACK_CONFIG if size == 256
                                   else FRONT_CONFIG).astype(np.float32)
        dev = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
               for a in c["inputs"]]
        slab = postprocess_slab(*dev, torch.from_numpy(anchors).cuda(),
                                score_threshold=c["thr"],
                                iou_threshold=c["iou"], input_size=size,
                                max_faces=c["mf"])
        want = {k: v.cpu().numpy() for k, v in split_slab(slab).items()}
        got = NativePostprocess(anchors, input_size=size,
                                score_threshold=c["thr"],
                                iou_threshold=c["iou"],
                                max_faces=c["mf"])(*c["inputs"])
        score_err = 0.0
        for i, res in enumerate(got):
            n = int(want["valid"][i].sum())
            same = (len(res) == n
                    and np.array_equal(res.boxes, want["boxes"][i, :n])
                    and np.array_equal(res.keypoints,
                                       want["keypoints"][i, :n])
                    and np.array_equal(res.poses, want["poses"][i, :n]))
            if n:
                score_err = max(score_err, float(np.abs(
                    res.scores - want["scores"][i, :n]).max()))
            if not same or not score_err <= 2e-7:
                emit(report)
                raise AssertionError(f"edge {c['name']} image {i}: the native "
                                     f"postprocess differs from kernel #1 "
                                     f"(score err {score_err})")
        report["cases"][c["name"]] = {
            "images": len(got), "detections": int(sum(len(r) for r in got)),
            "score_max_abs_err": score_err}
    versions = {}
    for mod in ("h5py", "tensorflow"):
        try:
            versions[mod] = __import__(mod).__version__
        except ImportError:
            versions[mod] = None
    report["versions"] = versions
    if versions["tensorflow"] is None:
        report["tflite"] = ("tensorflow does not import on this machine: "
                            "the .tflite export and EdgeDetector not run")
    else:
        import tempfile

        from headpose_tpu_torch.pretrained import load_flagship
        from headpose_tpu_torch.runtime.edge import EdgeDetector
        from headpose_tpu_torch.tools.tflite import export_unified_tflite

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "flagship.tflite")
            exported = export_unified_tflite(*load_flagship(), path)
            edge = EdgeDetector(path)
            frames = corpus["imgs"][:16]
            got = [edge.detect_single(f) for f in frames]
        direct = flagship.detect(frames).trim()
        pose = 0.0
        for i, (g, w) in enumerate(zip(got, direct)):
            if len(g) != len(w):
                raise AssertionError(f"edge tflite frame {i}: {len(g)} "
                                     f"detections, detect {len(w)}")
            if len(w):
                pose = max(pose, float(np.abs(g.poses - w.poses).max()))
        report["tflite"] = {"bytes": exported["bytes"],
                            "maxerr": exported["maxerr"], "frames": 16,
                            "pose_deg_max_vs_detect": pose}
        if not pose <= 1e-3:
            raise AssertionError(f"edge tflite: poses {pose} deg from "
                                 "detect")
    emit(report)


# the parallel phase: the dryrun's ranks as processes
PARALLEL_TIMEOUT_S = 300      # each spawn of ranks
PARALLEL_KERNELS = ("postprocess", "apply_fused", "mlp_head")
PARALLEL_ROWS_PER_CARD = 128  # the main path's batch, on every card


def parallel_plan(n_cards: int) -> dict:
    """The parallel phase's spawns of dryrun ranks on a machine of
    `n_cards` cards, by run name: `parallel.dryrun.launch`'s keywords (the
    device, frames, rows and timeout aside).  One NCCL rank on every card:
    on one card the parts detect and fit at 128 rows; on N >= 2 every part
    at 128 rows a rank, the TP step on the dryrun's `train_meshes(N)`
    ((N/2, 2) and (1, N) where N is even and >= 4).  Then two gloo ranks sharing cuda:0, every
    part at 64 rows a rank, the TP step on (1, 2)."""
    from headpose_tpu_torch.parallel.dryrun import PARTS

    if n_cards < 1:
        raise ValueError(f"the parallel phase needs a card, got {n_cards}")
    nccl = dict(nproc=n_cards, backend="nccl",
                batch=PARALLEL_ROWS_PER_CARD * n_cards)
    if n_cards == 1:
        nccl["parts"] = ("detect", "fit")
    else:
        nccl["parts"] = PARTS
    return {f"nccl_{n_cards}x1": nccl,
            "gloo_2_ranks": dict(nproc=2, backend="gloo", same_device=True,
                                 model_parallel=2, parts=PARTS,
                                 batch=PARALLEL_ROWS_PER_CARD)}


def _topology() -> dict:
    """`nvidia-smi topo -m` as it answers (exit code and text), and which
    cards can reach which other's memory directly (peer access)."""
    try:
        p = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True,
                           text=True, timeout=60)
        topo = {"exit": p.returncode, "text": (p.stdout + p.stderr).strip()}
    except (OSError, subprocess.SubprocessError) as e:
        topo = {"exit": None, "text": f"not run: {e}"}
    n = torch.cuda.device_count()
    topo["peer_access"] = [[i == j or torch.cuda.can_device_access_peer(i, j)
                            for j in range(n)] for i in range(n)]
    return topo


def phase_parallel(card, rows: str):
    """The multi-device paths on the card (parallel/dryrun.py) by
    `parallel_plan(torch.cuda.device_count())`: one NCCL rank on every
    card, then two gloo ranks sharing cuda:0.  Every rank's checks must
    hold.  Returns the detect windows' launches of #1, #3 and #4 by run,
    rank and path."""
    import shutil
    import tempfile

    from headpose_tpu_torch.parallel.dryrun import failed_checks, launch

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    out = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    plan = parallel_plan(n_cards)
    runs = {run: launch(out=os.path.join(out, run), device="cuda",
                        frames="corpus", rows=rows,
                        timeout=PARALLEL_TIMEOUT_S, **kw)
            for run, kw in plan.items()}
    report = {"phase": "parallel", "card": card, "cards": n_cards,
              "topology": _topology(), "plan": plan}
    launches = {}
    for run, ranks in runs.items():
        missed = failed_checks(ranks)
        if missed:
            raise AssertionError(f"parallel {run}: {missed}")
        # every planned rank reported (under NCCL each rank's
        # device[current] check holds rank r to cuda:r)
        assert len(ranks) == plan[run]["nproc"], (run, len(ranks))
        for r in ranks:
            det = r["detect"]
            paths = {k: v for k, v in det.items() if isinstance(v, dict)}
            report[f"{run}/rank{r['rank']}"] = {
                "checks": len(r["checks"]), "device": r["device"],
                "cuda_device": r["cuda_device"],
                "host_staged": r["host_staged"], "part_s": r["part_s"],
                "all_gather_rows_ms": det.get("all_gather_rows_ms"),
                "all_gather_rows_bytes": det.get("all_gather_rows_bytes"),
                "detect": {k: {f: v[f] for f in (
                    "detections", "bitwise", "pose_max_abs_diff",
                    "launches_window", "wall_s", "wall_unsharded_s",
                    "wall_local_rows_s")}
                    for k, v in paths.items()},
                "fit": {k: {f: v[f] for f in (
                    "max_rel", "bitwise", "epoch_ms", "epoch_ms_one_process",
                    "rows", "epochs", "wall_s", "wall_one_process_s")
                    if f in v}
                    for k, v in r["fit"].items()},
                "train": {shape: {fam: {f: t[fam][f] for f in (
                    "max_grad_err", "max_param_err", "sharded_params",
                    "warm_step_ms", "warm_step_ms_unsharded")}
                    for fam in t if fam != "mesh"}
                    for shape, t in r.get("train_meshes", {}).items()},
                "batcher": r.get("batcher")}
            for k in PARALLEL_KERNELS:
                n = {path: v["launches_window"].get(k, 0)
                     for path, v in paths.items()
                     if v["launches_window"].get(k, 0)}
                launches.setdefault(k, {})[f"{run}/rank{r['rank']}"] = n
    report["phase_s"] = time.perf_counter() - t_phase
    emit(report)
    shutil.rmtree(out, ignore_errors=True)
    return launches


# ----------------------------- the precision strings "high", "default"
# "default" on the parity corpus: the gate at twice the CPU emulation's
# figures (109/112 images, pose p99 1.05 deg), the rule the turbo phase
# applies to JAX's certificate of "turbo" and "max"
MP_DEFAULT_AGREE_MIN = 108
MP_DEFAULT_POSE_P99_DEG = 2.1
# a single-pass stage (one product of bf16-rounded operands, the bias
# unrounded) on the card against the CPU on the same input: only the fp32
# sum order differs, held within this fraction of the output's largest
# |value|; the resize is two products with a rounding between them, where
# an ulp of sum order may flip one bf16 step (2^-8) of the intermediate
MP_STAGE_FRAC = 1e-5
MP_RESIZE_FRAC = 2.0 ** -7
MP_TRAIN_STEPS = 100          # fit_detector at "default" on the card
MP_TRAIN_IMAGES, MP_TRAIN_BATCH = 512, 64
MP_HIGH_STEPS = 20            # fit_detector at "high" and "highest"


def single_pass_stages(card_net, cpu_net, frames) -> dict:
    """Each single-pass stage of a "default" UnifiedPoseNet (MLP heads),
    computed by the port's own functions on the card and on the CPU from
    the CPU's input of that stage: the resize of `frames` (uint8, not at
    the model's size) to the model's size, the stem, every block's
    depthwise and pointwise product, the four SSD heads, each head layer.
    Returns {stage: |card - cpu| max over the CPU output's largest
    |value|}."""
    from headpose_tpu_torch.core.single_pass import linear
    from headpose_tpu_torch.ops.image import preprocess

    dev = card_net.backbone.stem.weight.device
    size = cpu_net.backbone.spec.input_size
    bb = cpu_net.backbone
    stages = []

    def stage(name, fn, inp):
        stages.append((name, fn, inp))
        return fn(cpu_net, inp)

    def to(t, device):
        return (tuple(v.to(device) for v in t) if isinstance(t, tuple)
                else t.to(device))

    with torch.inference_mode():
        x = stage("resize", lambda n, t: preprocess(t, size, "bgr", True),
                  torch.from_numpy(frames))
        y = stage("stem", lambda n, t: n.backbone._stem(t, True), x)
        for i, blk in enumerate(bb.blocks):
            t = stage(f"block{i}_depthwise",
                      lambda n, v, i=i: n.backbone.blocks[i].depthwise(v),
                      y)
            y = blk.finish(stage(
                f"block{i}_pointwise",
                lambda n, v, i=i: n.backbone.blocks[i].pointwise(v), t), y)
            if i == bb.spec.tap88_block:
                f88 = y
        stage("ssd", lambda n, v: torch.cat(
            [o.reshape(o.shape[0], -1) for o in n.backbone.ssd(*v, True)],
            1), (f88, y))
        for name, feat in (("head88", f88), ("head96", y)):
            h = feat.permute(0, 2, 3, 1)
            head = getattr(cpu_net, name)
            for j, act in enumerate(head._acts):
                h = act(stage(f"{name}_layer{j}",
                              lambda n, v, name=name, j=j: linear(
                                  getattr(n, name).layers[j], v, True), h))
        gaps = {}
        for name, fn, inp in stages:
            want = fn(cpu_net, inp)
            got = fn(card_net, to(inp, dev)).cpu()
            gaps[name] = float((got - want).abs().max()
                               / want.abs().max())
    return gaps


def one_ulp_params(params, direction: float):
    """Every leaf of a JAX-layout params tree moved one fp32 ulp toward
    `direction` (+inf or -inf)."""
    if isinstance(params, dict):
        return {k: one_ulp_params(v, direction) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [one_ulp_params(v, direction) for v in params]
    a = np.asarray(params, np.float32)
    return np.nextafter(a, np.float32(direction)).astype(np.float32)


def phase_matmul_precision(back_model, corpus, production, stress, card,
                           seed: int):
    """The two strings JAX passes to jax.default_matmul_precision, on the
    card (the docstring's `matmul_precision` entry).  Returns {window:
    launch counts}."""
    report = {"phase": "matmul_precision", "card": card, "seed": seed}
    try:
        windows = matmul_precision(report, back_model, corpus, production,
                                   stress, seed)
    except BaseException:
        emit(report)                  # what ran, then the failure
        raise
    emit(report)
    return windows


def matmul_precision(report, back_model, corpus, production, stress,
                     seed: int) -> dict:
    """phase_matmul_precision's body: fills `report` as it goes."""
    import tempfile

    from headpose_tpu_torch.models import BLAZEFACE_FRONT
    from headpose_tpu_torch.pretrained import best_detector, flagship_detector
    from headpose_tpu_torch.runtime.detector import FaceDetector
    from headpose_tpu_torch.tools.aot import export_detector, load_exported
    from headpose_tpu_torch.tools.certify_modes import (certify_parity,
                                                        certify_stress)
    from headpose_tpu_torch.models.params import flatten_params
    from headpose_tpu_torch.train import detector

    t_phase = time.perf_counter()
    imgs128 = np.concatenate([corpus["imgs"], corpus["imgs"][:16]])
    windows = {}
    fast_want = {"apply_fused": 1, "mlp_head": 2,
                 "postprocess": 1}

    # (a) native "high": the "fast" network, slab for slab
    flag_high = flagship_detector(precision="high")
    pairs = {
        "flagship": (flag_high, flagship_detector(precision="fast")),
        "best": (best_detector(precision="high"),
                 best_detector(precision="fast")),
        "back": (FaceDetector(*back_model, precision="high"),
                 FaceDetector(*back_model, precision="fast")),
        "se": (FaceDetector(*se_model(), precision="high"),
               FaceDetector(*se_model(), precision="fast"))}
    high = report["high"] = {}
    for name, (det, fast) in pairs.items():
        det.detect(imgs128[:2])
        want, want_counts = launch_window(fast.detect, imgs128)
        got, counts = launch_window(det.detect, imgs128)
        windows[f"high_{name}"] = counts
        high[name] = {"launches": counts, "head_eval": det.head_eval,
                      "detections": int(got.valid.sum()),
                      "bitwise_fast": torch.equal(got.slab, want.slab)}
        named = ({"se_transformer"} if name == "se"
                 else {"mlp_head"}) | {"apply_fused",
                                               "postprocess"}
        if name in ("flagship", "best"):
            check_counts(counts, fast_want, f"high {name}")
        if counts != want_counts or any(counts[k] < 1 for k in named):
            raise AssertionError(f"high {name}: launches {counts}, fast's "
                                 f"{want_counts}")
        if not high[name]["bitwise_fast"]:
            raise AssertionError(f"high {name}: the slab differs from "
                                 "fast's")
    tol = {**PRODUCTION_TOL, "poses": PARITY_BUDGET_DEG}
    parity = check_parity(flag_high.detect, corpus, production, "high", tol)
    stressed = check_stress(flag_high.detect, flag_high, stress, "high")
    del parity["phase"], stressed["phase"]
    high["flagship"].update(parity=parity, stress=stressed,
                            detect_wall=detect_walls(flag_high.detect,
                                                     imgs128))

    # (b) graph-compiled "high": fp32, bitwise "highest"
    compat = {p: FaceDetector.from_h5_compat(h5_twin("flagship_joined"),
                                             precision=p)
              for p in ("highest", "high", "default")}
    slabs = {}
    for p, det in compat.items():
        det.detect(imgs128[:2])
        slabs[p], windows[f"graph_{p}"] = launch_window(det.detect, imgs128)
        check_counts(windows[f"graph_{p}"], {"postprocess": 1},
                     f"graph {p}")
    report["graph"] = {
        "high_bitwise_highest": torch.equal(slabs["high"].slab,
                                            slabs["highest"].slab),
        "launches": {p: windows[f"graph_{p}"] for p in compat}}
    if not report["graph"]["high_bitwise_highest"]:
        raise AssertionError("graph high: the slab differs from highest's")

    # (c) "default" on the flagship
    default = flagship_detector(precision="default")
    default.detect(imgs128[:2])
    got, windows["default"] = launch_window(default.detect, imgs128)
    check_counts(windows["default"], {"postprocess": 1}, "default")
    cpu_default = flagship_detector(precision="default", device="cpu")
    par = certify_parity(default.detect, corpus)
    st = certify_stress(default.detect, stress)
    stages = single_pass_stages(default.net, cpu_default.net,
                                np.repeat(production["img"][None], 4, 0))
    report["default"] = {
        "launches": windows["default"], "parity": par, "stress": st,
        "gate": {"agree_images_min": MP_DEFAULT_AGREE_MIN,
                 "pose_p99_max_deg": MP_DEFAULT_POSE_P99_DEG},
        "stages_vs_cpu_frac": stages,
        "stage_frac_max": max(v for k, v in stages.items()
                              if k != "resize"),
        "vs_cpu_16": versus(default.detect(corpus["imgs"][:16]).trim(),
                            cpu_default.detect(corpus["imgs"][:16]).trim()),
        "graph_vs_native": versus(slabs["default"].trim(), got.trim()),
        "detect_wall": detect_walls(default.detect, imgs128),
        "highest_detect_wall": detect_walls(flagship_detector().detect,
                                            imgs128)}
    if not (par["agree_images"] >= MP_DEFAULT_AGREE_MIN
            and par["pose_deg"]["p99"] <= MP_DEFAULT_POSE_P99_DEG):
        raise AssertionError(f"default parity: {par['agree_images']} "
                             f"images, pose {par['pose_deg']}")
    bad = {k: v for k, v in stages.items()
           if v > (MP_RESIZE_FRAC if k == "resize" else MP_STAGE_FRAC)}
    if bad:
        raise AssertionError(f"default stages vs the CPU: {bad}")

    # (d) export: each string baked into its program
    aot = report["aot"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, det in (("high", flag_high), ("default", default)):
            path = os.path.join(tmp, name)
            meta = export_detector(det, path, batch_sizes=(128,))
            want, source_counts = launch_window(det.detect, imgs128)
            replay, counts = launch_window(load_exported(path).detect,
                                           imgs128)
            ops = meta["programs"]["128"]["ops"]
            want_ops = {op: source_counts[op] for op in AOT_OPS}
            have_ops = {op: ops.count(op) for op in want_ops}
            aot[name] = {"precision": meta["config"]["precision"],
                         "ops": ops, "launches": counts,
                         "bitwise": torch.equal(replay.slab, want.slab)}
            windows[f"aot_{name}"] = counts
            if (have_ops != want_ops or counts != source_counts
                    or not aot[name]["bitwise"]
                    or meta["config"]["precision"] != name):
                raise AssertionError(f"aot {name}: {aot[name]}, ops want "
                                     f"{want_ops}, source launches "
                                     f"{source_counts}")

    # (e) the detector trainer at both strings
    sq, boxes, mask, kps = squares(MP_TRAIN_IMAGES, 128, seed)
    cfg = detector.DetectorFitConfig(
        steps=MP_TRAIN_STEPS, batch_size=MP_TRAIN_BATCH, warmup_steps=10,
        steps_per_sync=10, seed=seed)
    args = (BLAZEFACE_FRONT, sq, boxes, mask)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # a gap is the string's
    try:
        runs = {p: detector.fit_detector(
            *args, dataclasses.replace(cfg, steps=MP_HIGH_STEPS,
                                       precision=p),
            keypoints=kps, kp_weight=1.0) for p in ("highest", "high")}
    finally:
        torch.backends.cudnn.deterministic = saved
    (ph, hh), (pg, hg) = runs["highest"], runs["high"]
    fh, fg = flatten_params(ph), flatten_params(pg)
    train = report["train"] = {
        "high_bitwise_highest": all(np.array_equal(fh[k], fg[k])
                                    for k in fh) and all(
            np.array_equal(hh[k], hg[k]) for k in hh),
        "high_steps": MP_HIGH_STEPS}
    if not train["high_bitwise_highest"]:
        raise AssertionError("fit_detector high: not bitwise highest")
    dcfg = dataclasses.replace(cfg, precision="default")
    init = BLAZEFACE_FRONT.init(detector._generator(seed, 0))
    card = timed_run(lambda s: detector.fit_detector(
        *args, dcfg, keypoints=kps, kp_weight=1.0, init_params=init,
        on_sync=s))

    def cpu_run(params):
        return detector._fit_detector(
            *args, dataclasses.replace(dcfg, steps_per_sync=5),
            keypoints=kps, kp_weight=1.0, init_params=params, device="cpu",
            stop=DT_COMPARE)[1]

    cpu = cpu_run(init)
    ulp = [cpu_run(one_ulp_params(init, v)) for v in (np.inf, -np.inf)]
    loss = card["history"]["loss"]
    first = {k: v[:DT_COMPARE] for k, v in card["history"].items()}
    train["default"] = {
        "steps": MP_TRAIN_STEPS, "images": MP_TRAIN_IMAGES,
        "batch": MP_TRAIN_BATCH,
        "loss_mean_first_last_20": [float(loss[:20].mean()),
                                    float(loss[-20:].mean())],
        "card_vs_cpu_rel": rel_gaps(first, cpu),
        "cpu_one_ulp_rel": {k: max(rel_gaps(h, cpu)[k] for h in ulp)
                            for k in cpu},
        "steps_per_s": card["steps_per_s"], "wall_s": card["wall_s"]}
    td = train["default"]
    for k, gap in td["card_vs_cpu_rel"].items():
        bound = max(TRAIN_LOSS_RTOL,
                    CALIB_FLOOR_FACTOR * td["cpu_one_ulp_rel"][k])
        if not (np.isfinite(card["history"][k]).all() and gap <= bound):
            raise AssertionError(f"fit_detector default {k}: card vs CPU "
                                 f"rel {gap}, bound {bound}")
    if not td["loss_mean_first_last_20"][1] < td[
            "loss_mean_first_last_20"][0]:
        raise AssertionError(f"fit_detector default: the loss did not "
                             f"fall ({td['loss_mean_first_last_20']})")
    report["phase_s"] = time.perf_counter() - t_phase
    return windows


def main() -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the train phases' rows and images")
    args = parser.parse_args()
    t_script = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from headpose_tpu_torch.pretrained import (best_detector,
                                               flagship_detector,
                                               load_pretrained)
    from headpose_tpu_torch.runtime.detector import FaceDetector

    card = nvidia_smi()
    dev = torch.device("cuda")
    emit({"phase": "device", "nvidia_smi": card,
          "nvidia_smi_cards": nvidia_smi_cards(),
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda,
          "capability": list(torch.cuda.get_device_capability(0))})

    corpus = dict(np.load(os.path.join(GOLDEN, "parity_corpus.npz")))
    production = dict(np.load(os.path.join(GOLDEN, "e2e_production.npz")))
    stress = dict(np.load(os.path.join(GOLDEN, "stress_corpus.npz")))
    built = phase_build()
    flagship = flagship_detector()            # TF32 off from here on
    best = best_detector()
    with warnings.catch_warnings():           # a synthetic bring-up model
        warnings.simplefilter("ignore")
        back_model = load_pretrained("unified-back-distilled")
    back = FaceDetector(*back_model)
    emit({"phase": "head_routes", **head_routes()})

    # the main path's own inputs: 128 corpus frames, and the network's
    # outputs for them; the same frames resized to the back model's 256
    imgs128 = np.concatenate([corpus["imgs"], corpus["imgs"][:16]])
    from headpose_tpu_torch.ops.image import preprocess
    with torch.inference_mode():
        frames128 = preprocess(torch.from_numpy(imgs128).to(dev))
        frames256 = preprocess(torch.from_numpy(imgs128).to(dev),
                               256).contiguous()     # the resize's view
        o = flagship.net(frames128)
    main_inputs = [o["scores"], o["loc"], o["pose_front"], o["pose_back"]]

    entries = [phase_kernels(dev, flagship.anchors, back.anchors, main_inputs,
                             built),
               phase_kernel_backbone(dev, flagship, frames128, built),
               phase_kernel_head(dev, flagship, best, frames128, built),
               phase_kernel_backbone2(dev, flagship, back, frames128,
                                      frames256, built),
               phase_kernel_se(dev, flagship, frames128, built),
               *phase_kernel_dense(dev, flagship, back, frames128,
                                   frames256, built)]
    matmul_entry, matmul_rates = phase_kernel_matmul(built, card)
    detect_launches = phase_parity(flagship, corpus, production)
    phase_stress(flagship, stress)
    phase_best(flagship, best, corpus)
    fused_launches = phase_fused(flagship, best, corpus, production, stress,
                                 frames128)
    fast_launches = phase_fast(flagship, best, corpus, production, stress,
                               frames128)
    se_launches, se_report = phase_se(corpus)
    phase_unified_best(flagship, corpus)
    back_launches = phase_back(back_model, corpus, frames256)
    turbo_launches, turbo_network_ms = phase_turbo(
        flagship, best, back_model, corpus, stress, frames128, card)
    phase_flops_accounting(turbo_network_ms, matmul_rates, card)
    phase_timing(flagship, corpus, card)
    serve_launches = phase_serve(flagship, corpus, card)
    phase_stream(flagship, corpus, card)
    import shutil
    import tempfile
    parallel_tmp = tempfile.mkdtemp(prefix="chip_smoke_rows_")
    rows = os.path.join(parallel_tmp, "rows96.npz")
    train_launches = phase_train(corpus, card, args.seed, keep_rows=rows)
    detector_train_launches = phase_detector_train(corpus, card, args.seed)
    h5_launches = phase_h5(flagship, corpus, frames128, card)
    aot_launches = phase_aot(corpus, card)
    phase_edge(flagship, corpus, card)
    parallel_launches = phase_parallel(card, rows)
    shutil.rmtree(parallel_tmp, ignore_errors=True)
    precision_launches = phase_matmul_precision(back_model, corpus,
                                                production, stress, card,
                                                args.seed)

    for entry in entries[:3]:
        entry["launches"] = fused_launches[entry["name"]]
    entries[0]["launches_detect"] = detect_launches["postprocess"]
    entries[3]["launches"] = fast_launches["apply_fused"]
    entries[3]["launches_back_window"] = back_launches["apply_fused"]
    entries[4]["launches"] = se_launches["se_transformer"]
    entries[0]["launches_serve"] = {
        name: n["postprocess"] for name, n in serve_launches.items()}
    for entry in entries[2:4]:
        entry["launches_serve_best_fast"] = \
            serve_launches["best_fast"][entry["name"]]
    entries[3]["launches_turbo_window"] = turbo_launches["turbo"][
        "apply_fused"]
    entries[3]["launches_max_window"] = turbo_launches["max"]["apply_fused"]
    entries[5]["launches"] = turbo_launches["max"]["dense_block"]
    entries[5]["launches_turbo_window"] = turbo_launches["turbo"][
        "dense_block"]
    entries[6]["launches"] = turbo_launches["turbo"]["dense_chain"]
    entries[6]["launches_max_window"] = turbo_launches["max"]["dense_chain"]
    entries[4]["launches_se_windows"] = {
        name: se_report[name]["launches"]["se_transformer"]
        for name in ("map", "survivors", "fast_map")}
    for entry in entries[:4]:         # the trained head's serve step
        entry["launches_train_window"] = {
            path: n[entry["name"]] for path, n in train_launches.items()}
    for i in (0, 2, 3, 6):            # the trained detectors' serve steps
        entries[i]["launches_detector_train_window"] = {
            window: n[entries[i]["name"]]
            for window, n in detector_train_launches.items()
            if n[entries[i]["name"]]}
    for entry in entries[:5]:         # the H5 loaders' windows
        entry["launches_h5_window"] = h5_launches.get(entry["name"], {})
    for entry in entries:             # the AOT replays' windows
        entry["launches_aot_window"] = {
            name: n[entry["name"]] for name, n in aot_launches.items()
            if n[entry["name"]]}
    for i in (0, 2, 3):               # the parallel phase's windows
        entries[i]["launches_parallel_window"] = parallel_launches[
            entries[i]["name"]]
    for entry in entries:             # the "high" and "default" windows
        entry["launches_matmul_precision_window"] = {
            name: n[entry["name"]] for name, n in precision_launches.items()
            if n[entry["name"]]}
    entries.append(matmul_entry)      # its window: the probe's own
    emit({"phase": "total", "script_s": time.perf_counter() - t_script})
    emit({"kernels": entries})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
