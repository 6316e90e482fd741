"""The unified network through the fused kernels.

`fused_network(net, x)` computes what `UnifiedPoseNet.forward` computes
(feat88, feat96, scores, loc, pose_front, pose_back) as the JAX package's
kernel entry points compose:

  ops.kernels.backbone_forward   the stem and every BlazeBlock (TPU kernel
                                 ops/pallas/backbone.py::backbone_forward),
                                 fp32, at precision="highest";
  ops.kernels.apply_fused        or, at precision="fast", the stem and
                                 block 11 in fp32 and the other blocks with
                                 a 3-pass split-bf16 pointwise (TPU kernel
                                 ops/pallas/backbone2.py::run_segment);
                                 at "turbo" and "max" the same plan with
                                 the island's blocks (`island_of`) cut out
                                 and run as single-pass bf16 dense blocks
                                 through ops.kernels.dense_bf16 (a block
                                 alone, or a run on the small maps as one
                                 chain launch; no TPU kernel: XLA's conv
                                 at Precision.DEFAULT)
  the four SSD 1x1 heads         matrix products on the NHWC taps, flattened
                                 anchor-major (cell, then anchor), as XLA
                                 computes them outside any kernel in JAX;
                                 with a non-empty island, of bf16-rounded
                                 operands in fp32 (single-pass, as JAX)
  `head_forward`                 both pose heads over every map cell: an
                                 `MLPHeadNet` through ops.kernels.
                                 mlp_head_forward (TPU kernel
                                 ops/pallas/head_mlp.py), an
                                 `SETransformerHeadNet` through ops.kernels.
                                 se_transformer_forward (TPU kernel
                                 ops/pallas/se_attention.py), each while its
                                 spec lies in the kernel's domain
                                 (`head_route`); any other head (the
                                 residual, skip and SE-MLP families,
                                 ensembles, and heads outside a kernel's
                                 domain) as its module, as the JAX package
                                 runs them through XLA

On a CUDA device the kernels launch (or the call raises); on the CPU their
plain versions run.  `FaceDetector.detect_fused` serves it end to end, and
`FaceDetector.detect` too when the detector's precision is "high", "fast",
"turbo" or "max" ("high", JAX's pass-through string for the TPU's 3-pass
split-bf16, runs the "fast" network: `fused_network` takes it as "fast");
under the
survivors head profile the detector calls it with `heads=False` and runs
`head_forward` on the survivors' rows.
"""
from __future__ import annotations

import torch

from ..core.single_pass import bf16_round, fp32_exact
from ..models.blazeface import BlazeFace, turbo_fast_blocks
from ..models.heads import MLPHeadNet, SETransformerHeadNet
from ..models.unified import UnifiedPoseNet
from ..ops.kernels.backbone import backbone_forward
from ..ops.kernels.backbone2 import apply_fused
from ..ops.kernels import head_mlp, se_attention
from ..ops.kernels.head_mlp import mlp_head_forward
from ..ops.kernels.packing import packed
from ..ops.kernels.se_attention import se_transformer_forward
from ..utils.profiling import span

__all__ = ["fused_network", "head_forward", "head_route", "island_of",
           "PRECISIONS", "SERVED_PRECISIONS"]

# the detector modes, the choices of the serving and export CLIs (JAX's
# http.py and aot.py offer these four): fp32; split-bf16 segment pointwise;
# and that with a single-pass bf16 island of the trailing blocks, or of
# every block
PRECISIONS = ("highest", "fast", "turbo", "max")
# every string FaceDetector serves: the modes, and the two strings JAX's
# detector passes through to jax.default_matmul_precision, "high" (the
# TPU's 3 bf16 passes: the "fast" network) and "default" (one pass: every
# conv and product of bf16-rounded operands, core/single_pass.py)
SERVED_PRECISIONS = ("highest", "high", "fast", "turbo", "max", "default")


def island_of(spec: BlazeFace, precision: str,
              turbo_island=None) -> tuple[int, ...]:
    """The blocks that run at single-pass bf16 at `precision`, as the JAX
    detector chooses them: at "turbo" `turbo_island` when given (() is the
    "fast" function), else `turbo_fast_blocks(spec)`; at "max" every block;
    none otherwise."""
    if precision == "turbo":
        return (tuple(turbo_island) if turbo_island is not None
                else turbo_fast_blocks(spec))
    if precision == "max":
        return tuple(range(len(spec.block_channels)))
    return ()


def _rounded_weight(conv: torch.nn.Conv2d):
    """A 1x1 head's weight rounded to bf16, (C, out), in fp32: built once
    per module by `packing.packed`."""
    yield bf16_round(conv.weight[:, :, 0, 0].t())


def _ssd(conv: torch.nn.Conv2d, feat: torch.Tensor,
         w: torch.Tensor | None = None) -> torch.Tensor:
    """A 1x1 conv head on an NHWC map, flattened (B, cells * channels).
    Given `w` (the head's weights rounded to bf16, (C, out)) and a feat
    rounded to bf16, the product is single-pass: exact products, fp32 sums
    (TF32 off), the JAX function at Precision.DEFAULT, bias unrounded."""
    f = feat.reshape(-1, feat.shape[-1])
    if w is None:
        y = f @ conv.weight[:, :, 0, 0].t() + conv.bias
    else:
        with fp32_exact():
            y = f @ w + conv.bias
    return y.reshape(feat.shape[0], -1)


def _ssd_outputs(bb, f88: torch.Tensor, f96: torch.Tensor,
                 single_pass: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores (B, 896), loc (B, 896, 16)) of the four SSD heads; with
    `single_pass`, each tap rounded to bf16 once and the heads' rounded
    weights from their pack."""
    heads = (bb.cls_front, bb.cls_back, bb.loc_front, bb.loc_back)
    ws = [None] * 4
    if single_pass:
        ws = [packed(h, _rounded_weight).weights.view(h.in_channels, -1)
              for h in heads]
        f88, f96 = bf16_round(f88), bf16_round(f96)
    B = f88.shape[0]
    scores = torch.cat([_ssd(heads[0], f88, ws[0]),
                        _ssd(heads[1], f96, ws[1])], 1)
    loc = torch.cat([_ssd(heads[2], f88, ws[2]),
                     _ssd(heads[3], f96, ws[3])], 1).reshape(B, -1, 16)
    return scores, loc


def head_route(head: torch.nn.Module) -> str:
    """How `head_forward` runs `head`: "kernel" for an `MLPHeadNet` or an
    `SETransformerHeadNet` whose spec lies in its kernel's domain (the
    predicate the kernel's wrapper checks), "module" for any other head.
    Decided from the spec alone, before any launch."""
    if isinstance(head, MLPHeadNet):
        problem = head_mlp.domain_error(head)
    elif isinstance(head, SETransformerHeadNet):
        problem = se_attention.domain_error(head)
    else:
        return "module"
    return "kernel" if problem is None else "module"


def head_forward(head: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A pose head over (B, H, W, C) maps or (N, C) rows: through its kernel
    where `head_route` says so, else as its module."""
    if head_route(head) == "module":
        return head(x)
    if isinstance(head, MLPHeadNet):
        rows = mlp_head_forward(head, x.reshape(-1, x.shape[-1]))
        return rows.reshape(*x.shape[:-1], rows.shape[-1])
    if x.ndim == 2:                  # each row a 1x1 map
        return se_transformer_forward(head, x[:, None, None, :])[:, 0, 0]
    return se_transformer_forward(head, x)


@torch.no_grad()
def fused_network(net: UnifiedPoseNet, x: torch.Tensor,
                  precision: str = "highest", heads: bool = True,
                  island=None) -> dict[str, torch.Tensor]:
    """x (B, S, S, 3) float32 NHWC in [-1, 1] → the dict of
    `UnifiedPoseNet.forward`, through the fused kernels; `precision` (one
    of `PRECISIONS`, or "high", which is "fast") chooses the backbone;
    `island` overrides the "turbo" island (`island_of`); `heads=False`
    leaves out the pose maps.  The pose heads run in fp32 in every mode,
    both inside the span `detect.heads`."""
    if precision == "high":
        precision = "fast"
    if precision not in PRECISIONS:
        raise ValueError(f"fused_network computes the precisions "
                         f"{PRECISIONS} and 'high', got {precision!r}")
    if island is not None and precision != "turbo":
        raise ValueError(f"an island is the \"turbo\" mode's option, not "
                         f"{precision!r}'s")
    bb = net.backbone
    x = x.contiguous()                # the resize's output is a strided view
    if precision == "highest":
        f88, f96 = backbone_forward(bb, x)
        single_pass = False
    else:
        blocks = island_of(bb.spec, precision, island)
        f88, f96 = apply_fused(bb, x, blocks)
        single_pass = bool(blocks)
    scores, loc = _ssd_outputs(bb, f88, f96, single_pass)
    out = {"feat88": f88, "feat96": f96, "scores": scores, "loc": loc}
    if heads:
        with span("detect.heads"):
            if net.head88 is not None:
                out["pose_front"] = head_forward(net.head88, f88)
            if net.head96 is not None:
                out["pose_back"] = head_forward(net.head96, f96)
    return out
