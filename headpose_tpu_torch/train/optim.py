"""The port's own copy of the optax pieces detector training uses.

The JAX trainers (train/detector.py, train/calibrate.py) build their
optimizers from optax; the port may not import it, so this module keeps
what they use, in optax's arithmetic:

  * `warmup_cosine_decay_schedule` and `cosine_decay_schedule`, functions
    of the update count.  The optimizer evaluates its schedule at the count
    BEFORE the update (optax's scale_by_schedule), so with a warmup from 0
    the first update is exactly zero.  (`torch.optim.Adam` with a
    `LambdaLR` steps its schedule after the update: one step off.)
  * `Adam`: b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias-corrected, after
    an optional `clip_by_global_norm` (optax.chain(clip, adam)).
  * The train/freeze partition, the counterpart of
    optax.multi_transform({"train": inner, "freeze": set_to_zero()}): the
    optimizer holds the trained leaves only, so the clip's global norm is
    over them alone, and a frozen leaf is never written (it stays bitwise
    at its start value).  `freeze` also stops autograd from computing the
    frozen leaves' gradients, which no update reads.

Every step is a few `torch._foreach_*` ops over the flat list of trained
leaves (one launch a line on the card, none a leaf), and reads nothing back
from the device: the learning rate is a host float of the host's count.
"""
from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch

__all__ = ["warmup_cosine_decay_schedule", "cosine_decay_schedule",
           "clip_by_global_norm_", "Adam", "freeze"]

Schedule = Callable[[int], float]


def cosine_decay_schedule(init_value: float, decay_steps: int) -> Schedule:
    """optax.cosine_decay_schedule (alpha 0): init_value · 0.5 (1 +
    cos(pi · min(count, decay_steps) / decay_steps))."""
    if decay_steps <= 0:
        raise ValueError(f"decay_steps must be > 0, got {decay_steps}")

    def schedule(count: int) -> float:
        count = min(count, decay_steps)
        return init_value * (0.5 * (1.0 + math.cos(math.pi * count
                                                   / decay_steps)))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule (end_value 0): linear from
    init_value to peak_value over warmup_steps, then a cosine decay to 0
    over the remaining decay_steps - warmup_steps (decay_steps INCLUDES the
    warmup)."""
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps)

    def schedule(count: int) -> float:
        if count >= warmup_steps:
            return cosine(count - warmup_steps)
        frac = 1.0 - max(count, 0) / warmup_steps
        return (init_value - peak_value) * frac + peak_value

    return schedule


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g / ‖g‖ · max_norm for every leaf
    when the global norm ‖g‖ (over these leaves) is >= max_norm, else g
    unchanged (divided and multiplied by exactly 1).  Returns ‖g‖, a 0-d
    device tensor."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


def _correction(decay: float, count: int) -> float:
    """1 - decay^count in float32, as optax computes the bias correction
    (float32 decay, float32 power): 1 - 0.999^t loses most of its digits
    to cancellation, so the float64 value would differ from optax's by
    up to 1e-5 of itself."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Adam:
    """optax.adam(schedule) (optionally chained after
    clip_by_global_norm(clip_norm)) over a flat list of trained leaves,
    with optax's defaults B1, B2, EPS (eps_root 0):

      mu = (1 - B1) g + B1 mu;  nu = (1 - B2) g² + B2 nu;  t += 1
      p += -lr(t - 1) · (mu / (1 - B1^t)) / (sqrt(nu / (1 - B2^t)) + EPS)

    A leaf without a gradient (one the loss does not reach) takes g = 0,
    as JAX's gradient of it is."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, params: Iterable[torch.Tensor], schedule: Schedule,
                 *, clip_norm: float = 0.0):
        self.params = list(params)
        self.schedule = schedule
        self.clip_norm = clip_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.clip_norm > 0:
            clip_by_global_norm_(grads, self.clip_norm)
        lr = self.schedule(self.count)          # the count before the step
        self.count += 1
        b1, b2 = self.B1, self.B2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - b2))
        denom = torch._foreach_div(self.nu, _correction(b2, self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.EPS)
        u = torch._foreach_div(torch._foreach_div(
            self.mu, _correction(b1, self.count)), denom)
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(self.params, u)


def freeze(named: Iterable[tuple[str, torch.nn.Parameter]],
           train: Callable[[str], bool]) -> list[torch.nn.Parameter]:
    """The train/freeze partition of a module's named parameters: the
    leaves `train(name)` accepts are returned (give them to `Adam`); every
    other leaf gets requires_grad False and is never updated."""
    trained = []
    for name, p in named:
        p.requires_grad_(bool(train(name)))
        if p.requires_grad:
            trained.append(p)
    return trained
