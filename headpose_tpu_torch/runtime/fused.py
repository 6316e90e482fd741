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
                                 ops/pallas/backbone2.py::run_segment)
  the four SSD 1x1 heads         matrix products on the NHWC taps, flattened
                                 anchor-major (cell, then anchor), as XLA
                                 computes them outside any kernel in JAX
  `head_forward`                 both pose heads over every map cell: an
                                 `MLPHeadNet` through ops.kernels.
                                 mlp_head_forward (TPU kernel
                                 ops/pallas/head_mlp.py), an
                                 `SETransformerHeadNet` through ops.kernels.
                                 se_transformer_forward (TPU kernel
                                 ops/pallas/se_attention.py), any other head
                                 (the residual, skip and SE-MLP families,
                                 ensembles) as its module, as the JAX
                                 package runs them through XLA

On a CUDA device the kernels launch (or the call raises); on the CPU their
plain versions run.  `FaceDetector.detect_fused` serves it end to end, and
`FaceDetector.detect` too when the detector's precision is "fast"; under the
survivors head profile the detector calls it with `heads=False` and runs
`head_forward` on the survivors' rows.
"""
from __future__ import annotations

import torch

from ..models.heads import MLPHeadNet, SETransformerHeadNet
from ..models.unified import UnifiedPoseNet
from ..ops.kernels.backbone import backbone_forward
from ..ops.kernels.backbone2 import apply_fused
from ..ops.kernels.head_mlp import mlp_head_forward
from ..ops.kernels.se_attention import se_transformer_forward

__all__ = ["fused_network", "head_forward", "PRECISIONS"]

PRECISIONS = ("highest", "fast")   # fp32; split-bf16 segment pointwise


def _ssd(conv: torch.nn.Conv2d, feat: torch.Tensor) -> torch.Tensor:
    """A 1x1 conv head on an NHWC map, flattened (B, cells * channels)."""
    w = conv.weight[:, :, 0, 0]
    y = feat.reshape(-1, feat.shape[-1]) @ w.t() + conv.bias
    return y.reshape(feat.shape[0], -1)


def head_forward(head: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A pose head over (B, H, W, C) maps or (N, C) rows, through its kernel
    where the head has one."""
    if isinstance(head, MLPHeadNet):
        rows = mlp_head_forward(head, x.reshape(-1, x.shape[-1]))
        return rows.reshape(*x.shape[:-1], rows.shape[-1])
    if isinstance(head, SETransformerHeadNet):
        if x.ndim == 2:              # each row a 1x1 map
            return se_transformer_forward(head, x[:, None, None, :])[:, 0, 0]
        return se_transformer_forward(head, x)
    return head(x)


@torch.no_grad()
def fused_network(net: UnifiedPoseNet, x: torch.Tensor,
                  precision: str = "highest",
                  heads: bool = True) -> dict[str, torch.Tensor]:
    """x (B, S, S, 3) float32 NHWC in [-1, 1] → the dict of
    `UnifiedPoseNet.forward`, through the fused kernels; `precision` (one
    of `PRECISIONS`) chooses the backbone; `heads=False` leaves out the pose
    maps."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got "
                         f"{precision!r}")
    bb = net.backbone
    backbone = apply_fused if precision == "fast" else backbone_forward
    f88, f96 = backbone(bb, x.contiguous())   # the resize's output is a
                                              # strided view
    B = x.shape[0]
    out = {"feat88": f88, "feat96": f96,
           "scores": torch.cat([_ssd(bb.cls_front, f88),
                                _ssd(bb.cls_back, f96)], 1),
           "loc": torch.cat([_ssd(bb.loc_front, f88),
                             _ssd(bb.loc_back, f96)], 1).reshape(B, -1, 16)}
    if heads and net.head88 is not None:
        out["pose_front"] = head_forward(net.head88, f88)
    if heads and net.head96 is not None:
        out["pose_back"] = head_forward(net.head96, f96)
    return out
