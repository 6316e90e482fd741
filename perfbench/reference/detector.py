"""The reference detector: frames in, per-image detections out.

`Reference(config, params_path, device)` builds the network from the
configuration's spec and the weights file, and the anchor table from the
configuration's anchor options; `detect(frames)` runs preprocess, network
and postprocess in blocks of rows, in float32 with TF32 off.  `tf32_mode`
is also how the runners switch TF32 on for the control of a float32
configuration.

The heads run over every cell of their maps, and each face takes the pose
of its anchor's cell: the program's "map" head profile.  Where a head
couples a map's cells, the program's "survivors" profile (each face's
feature vector alone, a 1x1 map) computes something else, so a
configuration with such a head has to state `"detector": {"head_eval":
"map"}`; the reference refuses it otherwise."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..harness.cells import PERFBENCH
from . import image, model, postprocess


@contextlib.contextmanager
def tf32_mode(on: bool):
    """TF32 in cuBLAS and cuDNN on or off for the block, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Reference:
    def __init__(self, config: dict, params_path: str, device="cpu",
                 root: str = PERFBENCH):
        self.config = config
        self.device = torch.device(device)
        self.size = config["spec"]["backbone"]["input_size"]
        self.net = model.Network(config["spec"], params_path, self.device,
                                 root)
        profile = config.get("detector", {}).get("head_eval", "auto")
        if self.net.coupled and profile != "map":
            raise ValueError(
                f"perfbench: {self.net.coupled} couple their maps' cells, "
                "and the reference computes the 'map' head profile only; "
                f"this configuration's head_eval is {profile!r} (state "
                '"detector": {"head_eval": "map"})')
        self.anchors = postprocess.anchors(config["anchors"])

    @torch.no_grad()
    def outputs(self, frames: np.ndarray) -> dict:
        """The network's outputs (NumPy) for frames (B, H, W, 3) uint8."""
        with tf32_mode(False):
            x = image.preprocess(torch.from_numpy(np.ascontiguousarray(
                frames)).to(self.device), self.size)
            out = self.net(x)
        return {k: v.float().cpu().numpy() for k, v in out.items()}

    def detect(self, frames: np.ndarray, block: int = 256) -> list[dict]:
        results = []
        for i in range(0, len(frames), block):
            results += postprocess.postprocess(
                self.outputs(frames[i:i + block]), self.anchors, self.size,
                score_threshold=self.config["score_threshold"],
                iou_threshold=self.config["iou_threshold"],
                max_faces=self.config["max_faces"])
        return results
