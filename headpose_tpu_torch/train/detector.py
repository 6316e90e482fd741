"""Detector training, PyTorch edition: supervised SSD losses and teacher
distillation of a BlazeFace topology.

Port of headpose_tpu/train/detector.py, with its names, defaults and
return contract.  Two ways to train a BlazeFace topology, neither of which
the reference has (its detector arrives as external weights):

1. SUPERVISED (`fit_detector`): ground-truth boxes → per-anchor targets by
   scale-split cell assignment (`ssd_targets`), sigmoid-focal
   classification + Huber localisation (`ssd_loss`).
2. DISTILLATION (`distill_detector`): a trained detector supervises another
   topology through its two pose-tap feature maps, its per-anchor logits
   and its raw loc (scaled by student_size / teacher_size: raw offsets are
   in input pixels); `warmstart_params` starts the student from the
   teacher's weights wherever block shapes align, and `distill_prefix`
   first trains only a leading slice of the student on one tap map.  This
   is how the front→back model was made (scripts/distill_back.py, JAX).

No TPU kernel of the JAX package has a backward, and JAX trains through
XLA's convs, so the port trains the modules (`models.BlazeFaceNet`) through
autograd: cuDNN and cuBLAS forward and backward on the card.

The device loop, the port's form of JAX's scanned blocks:
  * the images stay uint8 on the device and each step gathers its batch
    there and preprocesses it through `ops.image.preprocess` (the bicubic
    GEMMs), as serving does;
  * a step's metrics stay on the device; the host reads them once per
    block of `steps_per_sync` steps, when `on_sync(done, {key: last
    value})` fires;
  * the init and the batch indices (randint with replacement, a step's
    draw at a time) come from CPU `torch.Generator`s seeded from
    `cfg.seed`, whatever the device, so a run on the card and one on the
    CPU see the same batches;
  * `precision` is the student's, as JAX's trainers pass it to
    `jax.default_matmul_precision` (the teacher's targets are always
    exact): "highest" and "high" are fp32 with TF32 off for the whole
    step, the backward included (PyTorch's default lets cuDNN convs use
    TF32; the TPU's "high" is three bf16 passes, an emulation of fp32);
    "default" is the TPU's single bf16 pass: the forward's resize GEMMs,
    stem, blocks and SSD heads (and distill_prefix's teacher taps) take
    bf16-rounded operands (core/single_pass.py), and the backward runs
    through autograd of the roundings, which rounds each rounded operand's
    cotangent to bf16 as JAX's transpose of `astype` does, its products in
    fp32 (JAX's `simulate_fast` convention).

Entry points run on the card (`device=None`) unless the caller passes
`device="cpu"`.  Params go in and come out in JAX layout (nested dicts and
lists of float32 numpy arrays); histories are {key: per-step np.ndarray}.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..core.single_pass import fp32_exact, single_pass_of
from ..models.blazeface import BlazeFace, BlazeFaceNet
from ..models.params import params_from_jax, params_to_jax
from ..ops.image import preprocess
from ..utils.device import resolve_device
from .optim import Adam, freeze, warmup_cosine_decay_schedule

__all__ = ["DetectorDistillConfig", "distill_targets", "distill_detector",
           "DetectorFitConfig", "ssd_grids", "ssd_targets", "ssd_loss",
           "fit_detector", "warmstart_params", "distill_prefix"]

Params = dict[str, Any]
OnSync = Callable[[int, dict], None]

FIT_KEYS = ("loss", "focal", "loc")
DISTILL_KEYS = ("loss", "feat", "score", "loc")
PREFIX_KEYS = ("loss",)


@dataclasses.dataclass(frozen=True)
class DetectorDistillConfig:
    """Distillation recipe (defaults tuned in JAX for front→back on
    synthetic data, scripts/distill_back.py)."""

    steps: int = 6000
    batch_size: int = 64
    learning_rate: float = 1e-3
    warmup_steps: int = 200          # linear warmup, then cosine to 0
    feat_weight: float = 1.0         # per feature map
    score_weight: float = 1.0
    loc_weight: float = 1.0
    steps_per_sync: int = 250        # steps per host read of the metrics
    seed: int = 0
    precision: str = "highest"       # core.single_pass.MATMUL_PRECISIONS
    # logits are compared through a smooth bounded squash s·tanh(x/s), so
    # saturated background anchors cannot dominate the MSE
    logit_squash: float = 8.0
    clip_norm: float = 1.0           # global-norm gradient clip (0 disables)
    # > 0: weight the feature-map MSE per CELL by (this + the teacher's face
    # probability at the cell); the value is the background floor
    feat_cell_eps: float = 0.0


@dataclasses.dataclass(frozen=True)
class DetectorFitConfig:
    """Supervised SSD training recipe (fit_detector)."""

    steps: int = 2000
    batch_size: int = 64
    learning_rate: float = 1e-3
    warmup_steps: int = 100
    steps_per_sync: int = 250
    seed: int = 0
    precision: str = "highest"
    # anchor assignment: GT faces smaller than this (normalized max extent)
    # go to the fine front grid, larger ones to the coarse back grid
    scale_split: float = 0.35
    focal_alpha: float = 0.75
    focal_gamma: float = 2.0
    loc_weight: float = 5.0
    huber_delta: float = 0.1     # in normalized (input-relative) units


# ----------------------------------------------------------------- helpers
def _generator(seed: int, stream: int) -> torch.Generator:
    """A CPU generator for one random stream of a run (0 the init, 1 the
    batch indices), a function of the seed only."""
    state = np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)
    return torch.Generator().manual_seed(int(state[0] >> np.uint64(1)))


def _on(a, device: torch.device, dtype=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=device, dtype=dtype)


def _net(spec: BlazeFace, params: Params,
         device: torch.device) -> BlazeFaceNet:
    net = BlazeFaceNet(spec, device=device)
    net.load_state_dict(params_from_jax(spec, params))
    return net


def _schedule(cfg):
    return warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, max(cfg.warmup_steps, 1),
        max(cfg.steps, cfg.warmup_steps + 1))


def _train(step: Callable[[torch.Tensor], torch.Tensor], keys, n: int, cfg,
           device: torch.device, on_sync: OnSync | None, indices=None,
           stop: int | None = None) -> dict[str, np.ndarray]:
    """The device loop: `step(idx)` runs one update on the batch of image
    indices idx (int64, on the device) and returns its metrics as one
    device vector in `keys` order.  Steps run in blocks of
    cfg.steps_per_sync; a block's metrics are read in one device→host copy
    at its end, where `on_sync` fires.  `indices` (steps, batch) replaces
    the seeded draws, and `stop` ends the run after that many steps (the
    schedule still spans cfg.steps)."""
    steps = cfg.steps if stop is None else min(stop, cfg.steps)
    gen = _generator(cfg.seed, 1)
    blocks: list[np.ndarray] = []
    done = 0
    with fp32_exact():
        while done < steps:
            length = min(cfg.steps_per_sync, steps - done)
            if indices is None:
                idx = torch.stack([torch.randint(0, n, (cfg.batch_size,),
                                                 generator=gen)
                                   for _ in range(length)])
            else:
                idx = torch.as_tensor(np.asarray(
                    indices[done:done + length], np.int64))
            if device.type == "cuda":
                idx = idx.pin_memory()
            idx = idx.to(device, non_blocking=True)
            rows = torch.stack([step(idx[i]) for i in range(length)])
            block = rows.cpu().numpy()
            blocks.append(block)
            done += length
            if on_sync is not None:
                on_sync(done, {k: float(v) for k, v in zip(keys, block[-1])})
    hist = (np.concatenate(blocks) if blocks
            else np.zeros((0, len(keys)), np.float32))
    return {k: hist[:, j] for j, k in enumerate(keys)}


def _update(opt: Adam, loss: torch.Tensor) -> None:
    opt.zero_grad()
    if loss.requires_grad:           # no trained leaf upstream: g = 0
        loss.backward()
    opt.step()


# -------------------------------------------------------------- supervised
def ssd_grids(spec: BlazeFace) -> tuple[int, int, int, int]:
    """(front_grid, back_grid, anchors_per_front_cell,
    anchors_per_back_cell) of a BlazeFace spec: the SSD geometry its
    forward flattens scores/loc by (16, 8, 2, 6 for both production
    specs)."""
    d_before = sum(1 for d in spec.downsample_blocks if d <= spec.tap88_block)
    g1 = spec.input_size // (2 * 2 ** d_before)
    g2 = spec.input_size // (2 * 2 ** len(spec.downsample_blocks))
    return g1, g2, spec.cls_channels[0], spec.cls_channels[1]


@torch.no_grad()
def ssd_targets(spec: BlazeFace, boxes, mask, keypoints=None,
                scale_split: float = 0.35):
    """Ground truth → per-anchor SSD targets, on the device of `boxes`.

    boxes: (B, K, 4) normalized corners [x1, y1, x2, y2]; mask: (B, K) 1 for
    real GT rows; keypoints: optional (B, K, 6, 2) normalized.  Each GT is
    assigned to every anchor of the cell holding its center on ONE grid
    chosen by face scale (< scale_split → the fine front grid, else the
    coarse back grid).  Returns (labels (B, A), loc_tgt (B, A, 16)); loc
    targets are in input pixels, the inverse of the decode.

    Cell collisions keep one GT: JAX's scatter with repeated indices keeps
    the last write on its CPU, which is the highest live k of the anchor.
    The port resolves that winner explicitly (a deterministic amax) and
    writes once, so the card and the CPU give the same targets (a scatter
    of duplicate indices is unordered on CUDA)."""
    boxes = torch.as_tensor(boxes, dtype=torch.float32)
    device = boxes.device
    mask = _on(mask, device, torch.float32)
    g1, g2, pc1, pc2 = ssd_grids(spec)
    n_front = g1 * g1 * pc1
    n_anchors = n_front + g2 * g2 * pc2
    B, K, _ = boxes.shape
    size = spec.input_size

    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    fine = torch.maximum(w, h) < scale_split

    def cell_base(g, pc, offset):
        col = (cx * g).to(torch.int32).clamp(0, g - 1)
        row = (cy * g).to(torch.int32).clamp(0, g - 1)
        return offset + (row * g + col) * pc, (col + 0.5) / g, (row + 0.5) / g

    base_f, acx_f, acy_f = cell_base(g1, pc1, 0)
    base_b, acx_b, acy_b = cell_base(g2, pc2, n_front)
    base = torch.where(fine, base_f, base_b)                   # (B, K)
    acx = torch.where(fine, acx_f, acx_b)
    acy = torch.where(fine, acy_f, acy_b)
    per_cell = torch.where(fine, pc1, pc2)

    tgt = torch.zeros((B, K, 16), device=device)
    tgt[..., 0] = (cx - acx) * size
    tgt[..., 1] = (cy - acy) * size
    tgt[..., 2] = w * size
    tgt[..., 3] = h * size
    if keypoints is not None:
        kps = _on(keypoints, device, torch.float32)
        kp = (kps - torch.stack([acx, acy], -1)[:, :, None, :]) * size
        tgt[..., 4:16] = kp.reshape(B, K, 12)

    # every live (GT, anchor of its cell) pair; dead ones go to the spare
    # column n_anchors, dropped at the end
    max_pc = max(pc1, pc2)
    offs = torch.arange(max_pc, device=device)
    idx = base[..., None].long() + offs                         # (B, K, pc)
    live = (mask[..., None] > 0) & (offs < per_cell[..., None])
    idx = torch.where(live, idx, n_anchors)
    k = torch.arange(K, device=device)[None, :, None].expand(B, K, max_pc)
    winner = torch.full((B, n_anchors + 1), -1, dtype=torch.int64,
                        device=device)
    winner.scatter_reduce_(1, idx.reshape(B, -1), k.reshape(B, -1), "amax")
    winner = winner[:, :-1]
    hit = winner >= 0
    loc_tgt = torch.gather(tgt, 1, winner.clamp(min=0)[..., None].expand(
        B, n_anchors, 16))
    return hit.float(), torch.where(hit[..., None], loc_tgt, 0.0)


def ssd_loss(spec: BlazeFace, out: dict, labels, loc_tgt,
             cfg: DetectorFitConfig, kp_weight: float = 0.0):
    """Sigmoid-focal classification + Huber localisation (normalized
    units); `labels` doubles as the positive mask of the localisation term,
    and kp_weight > 0 also supervises the 12 keypoint offsets.  The
    cross-entropy is optax's sigmoid_binary_cross_entropy,
    -y·logsigmoid(x) - (1 - y)·logsigmoid(-x).  Returns (total,
    {loss, focal, loc})."""
    logits = out["scores"]
    p = torch.sigmoid(logits)
    ce = -labels * F.logsigmoid(logits) - (1 - labels) * F.logsigmoid(-logits)
    pt = labels * p + (1 - labels) * (1 - p)
    alpha = labels * cfg.focal_alpha + (1 - labels) * (1 - cfg.focal_alpha)
    focal = (alpha * (1 - pt) ** cfg.focal_gamma * ce).mean() * labels.shape[-1]

    diff = (out["loc"] - loc_tgt) / spec.input_size
    dim_w = torch.cat([torch.ones(4, device=diff.device),
                       torch.full((12,), float(kp_weight),
                                  device=diff.device)])
    delta = cfg.huber_delta
    hub = torch.where(diff.abs() <= delta, 0.5 * diff ** 2 / delta,
                      diff.abs() - 0.5 * delta)
    loc = ((labels[..., None] * dim_w * hub).sum()
           / (labels.sum() * (4 + 12 * (kp_weight > 0)) + 1e-6))
    total = focal + cfg.loc_weight * loc
    return total, {"loss": total, "focal": focal, "loc": loc}


def fit_detector(spec: BlazeFace, images_u8, boxes, mask,
                 cfg: DetectorFitConfig = DetectorFitConfig(),
                 *, keypoints=None, kp_weight: float = 0.0,
                 channel_order: str = "bgr",
                 init_params: Params | None = None,
                 on_sync: OnSync | None = None,
                 device: str | torch.device | None = None,
                 ) -> tuple[Params, dict[str, np.ndarray]]:
    """Supervised SSD training of a BlazeFace spec from ground-truth boxes
    (images_u8 (N, H, W, 3) at any resolution, preprocessed through the
    production path; boxes (N, K, 4) normalized corners; mask (N, K)).
    Adam under a warmup-cosine schedule.  Returns (params, history
    {loss, focal, loc})."""
    return _fit_detector(spec, images_u8, boxes, mask, cfg,
                         keypoints=keypoints, kp_weight=kp_weight,
                         channel_order=channel_order,
                         init_params=init_params, on_sync=on_sync,
                         device=device)


def _fit_detector(spec, images_u8, boxes, mask, cfg, *, keypoints=None,
                  kp_weight=0.0, channel_order="bgr", init_params=None,
                  on_sync=None, device=None, indices=None, stop=None):
    """fit_detector, with `_train`'s `indices` and `stop`."""
    single_pass = single_pass_of(cfg.precision)
    device = resolve_device(device)
    imgs = _on(images_u8, device)
    labels, loc_tgt = ssd_targets(
        spec, _on(boxes, device, torch.float32), mask,
        None if keypoints is None else _on(keypoints, device, torch.float32),
        cfg.scale_split)
    params = (init_params if init_params is not None
              else spec.init(_generator(cfg.seed, 0)))
    net = _net(spec, params, device)
    opt = Adam(net.parameters(), _schedule(cfg))

    def step(idx):
        x = preprocess(imgs[idx], spec.input_size, channel_order,
                       single_pass)
        loss, m = ssd_loss(spec, net(x, single_pass=single_pass),
                           labels[idx], loc_tgt[idx], cfg, kp_weight)
        _update(opt, loss)
        return torch.stack([m[k].detach() for k in FIT_KEYS])

    history = _train(step, FIT_KEYS, imgs.shape[0], cfg, device, on_sync,
                     indices, stop)
    return params_to_jax(spec, net.state_dict()), history


# ------------------------------------------------------------ distillation
@torch.no_grad()
def distill_targets(teacher_spec: BlazeFace, teacher_params: Params,
                    images_u8, *, chunk: int = 128,
                    channel_order: str = "bgr",
                    device: str | torch.device | None = None,
                    ) -> tuple[dict[str, torch.Tensor],
                               dict[str, torch.Tensor]]:
    """One exact (fp32, TF32 off) teacher forward over the training images,
    in chunks of `chunk` → the targets {feat88, feat96, scores, loc,
    loc_prob} and the global second moments the loss normalizes by, all
    on the device."""
    device = resolve_device(device)
    imgs = _on(images_u8, device)
    net = _net(teacher_spec, teacher_params, device).eval()
    keys = ("feat88", "feat96", "scores", "loc")
    chunks = []
    with fp32_exact():
        for i in range(0, imgs.shape[0], chunk):
            out = net(preprocess(imgs[i:i + chunk], teacher_spec.input_size,
                                 channel_order))
            chunks.append([out[k] for k in keys])
    tgt = {k: torch.cat([c[j] for c in chunks]) for j, k in enumerate(keys)}
    probs = torch.sigmoid(tgt["scores"])                       # (N, A)
    norms = {
        "feat88": (tgt["feat88"] ** 2).mean() + 1e-6,
        "feat96": (tgt["feat96"] ** 2).mean() + 1e-6,
        # loc is supervised only where the teacher sees a face
        "loc": ((probs[..., None] * tgt["loc"] ** 2).sum()
                / (probs.sum() * tgt["loc"].shape[-1] + 1e-6) + 1e-6),
    }
    tgt["loc_prob"] = probs
    return tgt, norms


def warmstart_params(student_spec: BlazeFace, teacher_spec: BlazeFace,
                     teacher_params: Params, key: torch.Generator | None = None
                     ) -> Params:
    """Student init from teacher weights wherever block shapes align.

    Blocks are aligned from the END (the shared suffix of the front→back
    ladder); an unmatched leading student block borrows the first teacher
    block with identical weight shapes; stem and SSD heads copy directly
    when their shapes match.  Everything else keeps the random init drawn
    from `key`, a CPU torch.Generator (None: seeded 0).  Copied leaves are
    the teacher's values bit for bit."""
    init = student_spec.init(key if key is not None
                             else torch.Generator().manual_seed(0))

    def shapes(b):
        return {k: tuple(np.shape(v)) for k, v in b.items()}

    def copy(b):
        return {k: np.array(v, np.float32) for k, v in b.items()}

    t_blocks = teacher_params["blocks"]
    out = dict(init)
    for name in ("stem", "cls_front", "cls_back", "loc_front", "loc_back"):
        if shapes(teacher_params[name]) == shapes(init[name]):
            out[name] = copy(teacher_params[name])
    offset = len(student_spec.block_channels) - len(teacher_spec.block_channels)
    blocks = []
    for k, blk in enumerate(init["blocks"]):
        j = k - offset
        if 0 <= j < len(t_blocks) and shapes(t_blocks[j]) == shapes(blk):
            src = t_blocks[j]
        else:
            src = next((tb for tb in t_blocks if shapes(tb) == shapes(blk)),
                       None)
        blocks.append(copy(src) if src is not None else blk)
    out["blocks"] = blocks
    return out


def _squash(x: torch.Tensor, s: float) -> torch.Tensor:
    return s * torch.tanh(x / s)


def _distill_loss(out: dict, tgt: dict, norms: dict, loc_scale: float,
                  cfg: DetectorDistillConfig):
    """The distillation objective on the student's outputs `out` and the
    batch's targets `tgt` (JAX's _distill_loss after its forward)."""
    s = cfg.logit_squash
    if "w88" in tgt:                 # per-cell weighting (feat_cell_eps)
        def wmse(k, wk):
            w = tgt[wk]
            return ((w * (out[k] - tgt[k]) ** 2).sum()
                    / (w.sum() * tgt[k].shape[-1] + 1e-6)) / norms[k]

        feat = wmse("feat88", "w88") + wmse("feat96", "w96")
    else:
        feat = (((out["feat88"] - tgt["feat88"]) ** 2).mean() / norms["feat88"]
                + ((out["feat96"] - tgt["feat96"]) ** 2).mean()
                / norms["feat96"])
    score = (((_squash(out["scores"], s) - _squash(tgt["scores"], s)) ** 2)
             .mean() / (s * s * 0.25))
    w = tgt["loc_prob"][..., None]
    loc = ((w * (out["loc"] - loc_scale * tgt["loc"]) ** 2).sum()
           / (w.sum() * tgt["loc"].shape[-1] + 1e-6)
           / (loc_scale ** 2 * norms["loc"]))
    total = (cfg.feat_weight * feat + cfg.score_weight * score
             + cfg.loc_weight * loc)
    return total, {"loss": total, "feat": feat, "score": score, "loc": loc}


def distill_detector(student_spec: BlazeFace, teacher_spec: BlazeFace,
                     teacher_params: Params, images_u8,
                     cfg: DetectorDistillConfig = DetectorDistillConfig(),
                     *, channel_order: str = "bgr",
                     init_params: Params | None = None,
                     on_sync: OnSync | None = None,
                     device: str | torch.device | None = None,
                     ) -> tuple[Params, dict[str, np.ndarray]]:
    """Train `student_spec` to reproduce the teacher on `images_u8` (N, H,
    W, 3 uint8, teacher-resolution frames; the student sees them through
    the production preprocess at its own input size).  Adam under a
    warmup-cosine schedule after a global-norm clip.  Returns (params,
    history {loss, feat, score, loc})."""
    return _distill_detector(student_spec, teacher_spec, teacher_params,
                             images_u8, cfg, channel_order=channel_order,
                             init_params=init_params, on_sync=on_sync,
                             device=device)


def _distill_detector(student_spec, teacher_spec, teacher_params, images_u8,
                      cfg, *, channel_order="bgr", init_params=None,
                      on_sync=None, device=None, indices=None, stop=None):
    """distill_detector, with `_train`'s `indices` and `stop`."""
    single_pass = single_pass_of(cfg.precision)
    device = resolve_device(device)
    loc_scale = student_spec.input_size / teacher_spec.input_size
    imgs = _on(images_u8, device)
    tgt, norms = distill_targets(teacher_spec, teacher_params, imgs,
                                 channel_order=channel_order, device=device)
    if cfg.feat_cell_eps > 0:
        # per-cell weights of the feature losses: eps + the teacher's
        # largest face probability over the cell's anchors, one map per
        # tap grid; the normalizers recomputed under the same weighting
        g1, g2, pc1, pc2 = ssd_grids(teacher_spec)
        p = tgt["loc_prob"]
        n_front = g1 * g1 * pc1
        tgt["w88"] = cfg.feat_cell_eps + p[:, :n_front].reshape(
            -1, g1, g1, pc1).amax(-1)[..., None]
        tgt["w96"] = cfg.feat_cell_eps + p[:, n_front:].reshape(
            -1, g2, g2, pc2).amax(-1)[..., None]
        for k, wk in (("feat88", "w88"), ("feat96", "w96")):
            norms[k] = ((tgt[wk] * tgt[k] ** 2).sum()
                        / (tgt[wk].sum() * tgt[k].shape[-1] + 1e-6) + 1e-6)
    params = (init_params if init_params is not None
              else student_spec.init(_generator(cfg.seed, 0)))
    net = _net(student_spec, params, device)
    opt = Adam(net.parameters(), _schedule(cfg), clip_norm=cfg.clip_norm)

    def step(idx):
        x = preprocess(imgs[idx], student_spec.input_size, channel_order,
                       single_pass)
        loss, m = _distill_loss(net(x, single_pass=single_pass),
                                {k: v[idx] for k, v in tgt.items()},
                                norms, loc_scale, cfg)
        _update(opt, loss)
        return torch.stack([m[k].detach() for k in DISTILL_KEYS])

    history = _train(step, DISTILL_KEYS, imgs.shape[0], cfg, device, on_sync,
                     indices, stop)
    return params_to_jax(student_spec, net.state_dict()), history


def _prefix_loss(net: BlazeFaceNet, student_tap: int, teacher: BlazeFaceNet,
                 teacher_tap: int, batch: torch.Tensor, channel_order: str,
                 single_pass: bool = False) -> torch.Tensor:
    """The stage-wise objective on a batch of uint8 frames: the student's
    tap map against the teacher's (computed without autograd), MSE over
    the teacher map's second moment; `single_pass` runs both taps so, as
    JAX computes both inside one `default_matmul_precision` block."""
    with torch.no_grad():
        tgt = teacher.tap(preprocess(batch, teacher.spec.input_size,
                                     channel_order, single_pass),
                          (teacher_tap,),
                          single_pass)[f"block{teacher_tap}_out"]
    out = net.tap(preprocess(batch, net.spec.input_size, channel_order,
                             single_pass),
                  (student_tap,), single_pass)[f"block{student_tap}_out"]
    return ((out - tgt) ** 2).mean() / ((tgt ** 2).mean() + 1e-6)


def distill_prefix(student_spec: BlazeFace, student_tap: int,
                   teacher_spec: BlazeFace, teacher_tap: int,
                   teacher_params: Params, images_u8,
                   cfg: DetectorDistillConfig = DetectorDistillConfig(),
                   *, trainable_blocks: tuple[int, ...] = (0,),
                   train_stem: bool = True, channel_order: str = "bgr",
                   init_params: Params | None = None,
                   on_sync: OnSync | None = None,
                   device: str | torch.device | None = None,
                   ) -> tuple[Params, dict[str, np.ndarray]]:
    """Stage-wise distillation: train only a leading slice of the student
    (the stem if `train_stem`, and `trainable_blocks`) so that its
    `student_tap` map reproduces the teacher's `teacher_tap` map (-1 = the
    stem output).  Loss = MSE normalized by the teacher map's second
    moment.  Every other leaf is frozen: the optimizer holds the slice
    only (the clip's norm is over it), and a frozen leaf comes back bit
    for bit.  Neither network runs past its tap (no later block, no SSD
    head), and the teacher runs without autograd.  Returns (params,
    history {loss})."""
    return _distill_prefix(student_spec, student_tap, teacher_spec,
                           teacher_tap, teacher_params, images_u8, cfg,
                           trainable_blocks=trainable_blocks,
                           train_stem=train_stem, channel_order=channel_order,
                           init_params=init_params, on_sync=on_sync,
                           device=device)


def _distill_prefix(student_spec, student_tap, teacher_spec, teacher_tap,
                    teacher_params, images_u8, cfg, *, trainable_blocks=(0,),
                    train_stem=True, channel_order="bgr", init_params=None,
                    on_sync=None, device=None, indices=None, stop=None):
    """distill_prefix, with `_train`'s `indices` and `stop`."""
    single_pass = single_pass_of(cfg.precision)
    device = resolve_device(device)
    imgs = _on(images_u8, device)
    params = (init_params if init_params is not None
              else student_spec.init(_generator(cfg.seed, 0)))
    net = _net(student_spec, params, device)
    teacher = _net(teacher_spec, teacher_params, device).eval()
    teacher.requires_grad_(False)
    blocks = {f"blocks.{i}." for i in trainable_blocks}

    def trained(name: str) -> bool:
        if name.startswith("stem."):
            return train_stem
        return any(name.startswith(b) for b in blocks)

    opt = Adam(freeze(net.named_parameters(), trained), _schedule(cfg),
               clip_norm=cfg.clip_norm)

    def step(idx):
        loss = _prefix_loss(net, student_tap, teacher, teacher_tap,
                            imgs[idx], channel_order, single_pass)
        _update(opt, loss)
        return loss.detach()[None]

    history = _train(step, PREFIX_KEYS, imgs.shape[0], cfg, device, on_sync,
                     indices, stop)
    return params_to_jax(student_spec, net.state_dict()), history
