"""Precision calibration, PyTorch edition: distill the exact fp32 network
into its bf16 islands.

Port of headpose_tpu/train/calibrate.py.  An island's convs round both
operands to bf16 (the "turbo" and "max" modes, models/blazeface.py), and
those per-weight rounding residuals propagate deterministically through
the un-normalized conv stack.  Calibration fine-tunes the backbone weights
W so that the island forward with W matches the exact fp32 forward with the
ORIGINAL weights W0 on synthetic images: the pose heads stay frozen
(gradients flow through them into the feature maps), and the targets are
the deployed outputs (pose maps, post-sigmoid scores, raw loc).

The student is `UnifiedPoseNet.forward(dense=True, fast_blocks=...,
simulate_fast=True)`: the island convs take bf16-rounded operands and
multiply them in fp32, and autograd rounds the cotangent through each cast
to bf16 (the transpose of JAX's astype).  JAX runs the non-island stages
at the ambient "high" precision, which is fp32 on its CPU; the port runs
them, and the targets, in fp32 with TF32 off, the backward included.

Entry points run on the card (`device=None`) unless the caller passes
`device="cpu"`.  The images are drawn from a CPU generator seeded from
`seed`, so the card and the CPU calibrate on the same draws; the
upsampling and the mixing run on the device, so the two sides' images may
differ in their last bits.  `_calibrate(images=...)` takes given images
instead, bitwise the same on both.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..core.single_pass import fp32_exact
from ..models.params import params_from_jax, params_to_jax
from ..models.unified import UnifiedPoseModel, UnifiedPoseNet
from ..utils.device import resolve_device
from .optim import Adam, cosine_decay_schedule, freeze

__all__ = ["synthesize_images", "calibrate_fast_params", "ALL_BLOCKS"]

Params = dict[str, Any]

ALL_BLOCKS = tuple(range(16))

HISTORY_KEYS = ("loss", "pose_front", "pose_back", "scores", "loc")


def synthesize_images(generator: torch.Generator, n: int, size: int = 128,
                      *, device: str | torch.device | None = None
                      ) -> torch.Tensor:
    """Random calibration frames in [-1, 1], (n, size, size, 3), on the
    device.

    Each image is a random convex mixture of uniform noise fields at
    several spatial scales (pixel, 4px, 16px, 64px, bilinearly upsampled)
    and a flat color, with Dirichlet(1, 1, 1, 1, 1) weights, times 2 and
    clipped.  Every draw comes from `generator` (a CPU generator), in this
    order: the per-pixel field, the fields at size/4, size/16 and size/64
    (at least 1 pixel each), the flat color, then the weights as five
    Exp(1) draws -log(1 - U) normalised (torch.distributions samplers take
    no generator); the upsampling and the mixing run on the device."""
    device = resolve_device(device)

    def uniform(shape):
        return torch.empty(shape).uniform_(-1.0, 1.0, generator=generator)

    fields = [uniform((n, r, r, 3)) for r in (
        size, max(size // 4, 1), max(size // 16, 1), max(size // 64, 1))]
    flat = uniform((n, 1, 1, 3))
    e = -torch.log1p(-torch.rand((n, 5), generator=generator))
    w = (e / e.sum(1, keepdim=True)).to(device)

    comps = [_upsample(f.to(device), size) for f in fields]
    comps.append(flat.to(device).expand(n, size, size, 3))
    img = sum(c * w[:, j, None, None, None] for j, c in enumerate(comps))
    return torch.clamp(img * 2.0, -1.0, 1.0)


def _upsample(v: torch.Tensor, size: int) -> torch.Tensor:
    """(n, r, r, C) → (n, size, size, C) bilinear, half-pixel centers: the
    upsampling of jax.image.resize(..., "bilinear") (within 2e-7 of it)."""
    if v.shape[1] == size:
        return v
    return F.interpolate(v.permute(0, 3, 1, 2), size=(size, size),
                         mode="bilinear",
                         align_corners=False).permute(0, 2, 3, 1)


def calibrate_fast_params(model: UnifiedPoseModel, params: Params, *,
                          steps: int = 2000, batch: int = 64,
                          learning_rate: float = 1e-4,
                          fast_blocks: tuple[int, ...] = ALL_BLOCKS,
                          seed: int = 0,
                          loss_weights: tuple[float, float, float, float]
                          = (1.0, 1.0, 10.0, 0.1),
                          device: str | torch.device | None = None,
                          ) -> tuple[Params, dict[str, np.ndarray]]:
    """Fine-tune the backbone of (model, params) so that the bf16-island
    forward (islands `fast_blocks`) matches the exact fp32 forward of the
    original params.

    Returns (new_params, history): new_params holds the calibrated backbone
    and the original pose heads (the given arrays, unchanged); history
    holds the per-step loss and its terms pose_front, pose_back, scores
    (post-sigmoid) and loc, weighted by `loss_weights`.  Adam under a
    cosine decay of `learning_rate` over `steps`; one batch of `batch`
    synthetic images a step; the metrics are read once, at the end."""
    return _calibrate(model, params, steps=steps, batch=batch,
                      learning_rate=learning_rate, fast_blocks=fast_blocks,
                      seed=seed, loss_weights=loss_weights, device=device)


def _calibration_loss(student: UnifiedPoseNet, teacher: UnifiedPoseNet,
                      x: torch.Tensor, fast_blocks, loss_weights):
    """(loss, [pose_front, pose_back, scores, loc]) of one batch: the
    island forward of `student` against the exact forward of `teacher`
    (computed without autograd), each term a weighted MSE."""
    w_pf, w_pb, w_sc, w_loc = loss_weights
    with torch.no_grad():
        ref = teacher(x)
    out = student(x, dense=True, fast_blocks=fast_blocks, simulate_fast=True)
    terms = [w_pf * ((out["pose_front"] - ref["pose_front"]) ** 2).mean(),
             w_pb * ((out["pose_back"] - ref["pose_back"]) ** 2).mean(),
             w_sc * ((torch.sigmoid(out["scores"])
                      - torch.sigmoid(ref["scores"])) ** 2).mean(),
             w_loc * ((out["loc"] - ref["loc"]) ** 2).mean()]
    return sum(terms), terms


def _calibrate(model, params, *, steps, batch, learning_rate, fast_blocks,
               seed, loss_weights, device, images=None, stop=None):
    """calibrate_fast_params; `images` (steps, batch, S, S, 3) replaces the
    synthesized batches, and `stop` ends the run after that many steps
    (the schedule still spans `steps`)."""
    device = resolve_device(device)
    size = model.backbone.input_size
    state = params_from_jax(model, params)
    teacher = UnifiedPoseNet(model, device=device).eval()
    teacher.load_state_dict(state)
    teacher.requires_grad_(False)
    student = UnifiedPoseNet(model, device=device)
    student.load_state_dict(state)
    opt = Adam(freeze(student.named_parameters(),
                      lambda name: name.startswith("backbone.")),
               cosine_decay_schedule(learning_rate, steps))
    gen = torch.Generator().manual_seed(seed)
    n = steps if stop is None else min(stop, steps)
    rows = []
    with fp32_exact():
        for i in range(n):
            x = (synthesize_images(gen, batch, size, device=device)
                 if images is None else
                 torch.as_tensor(np.asarray(images[i], np.float32)).to(device))
            loss, terms = _calibration_loss(student, teacher, x, fast_blocks,
                                            loss_weights)
            opt.zero_grad()
            loss.backward()
            opt.step()
            rows.append(torch.stack([loss, *terms]).detach())
    hist = (torch.stack(rows).cpu().numpy() if rows
            else np.zeros((0, len(HISTORY_KEYS)), np.float32))
    calibrated = params_to_jax(model.backbone, {
        k[len("backbone."):]: v for k, v in student.state_dict().items()
        if k.startswith("backbone.")})
    return (dict(params, backbone=calibrated),
            {k: hist[:, j] for j, k in enumerate(HISTORY_KEYS)})
