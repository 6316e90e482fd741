"""The one frame generator.  A traffic mix is data
(`perfbench/traffic/<name>.json`): a ring of `ring` batches of `batch`
frames, each frame an image of the corpus drawn with replacement by the
seed, flipped left-right when the seed says so, scaled up `scale` times
(nearest), and, with a `canvas` [h, w], pasted at a seed-drawn offset into a
canvas of seed-drawn noise.  Every seed gives the same sizes; only the
contents differ."""
from __future__ import annotations

import hashlib
import os

import numpy as np

from .cells import ROOT


def corpus(traffic: dict, root: str = ROOT) -> np.ndarray:
    """The corpus images, after checking the file's sha256 against the
    traffic's: a changed corpus must fail loudly, not move the yardstick."""
    spec = traffic["corpus"]
    path = os.path.join(root, spec["file"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != spec["sha256"]:
        raise ValueError(f"{spec['file']}: sha256 {digest}, the traffic "
                         f"{spec['sha256']}; the corpus changed")
    return np.load(path)[spec["key"]]


def frame_shape(traffic: dict, images: np.ndarray) -> tuple[int, int]:
    canvas = traffic["frame"].get("canvas")
    if canvas:
        return int(canvas[0]), int(canvas[1])
    s = int(traffic["frame"]["scale"])
    return images.shape[1] * s, images.shape[2] * s


def ring(traffic: dict, seed: int, images: np.ndarray) -> list[np.ndarray]:
    """The traffic's ring of (batch, H, W, 3) uint8 BGR batches for `seed`."""
    rng = np.random.default_rng(seed)
    fr = traffic["frame"]
    s = int(fr["scale"])
    B = int(traffic["batch"])
    out = []
    for _ in range(int(traffic["ring"])):
        f = images[rng.integers(0, len(images), B)]
        if fr.get("flip"):
            flip = rng.random(B) < 0.5
            f[flip] = f[flip, :, ::-1]
        if s > 1:
            f = f.repeat(s, axis=1).repeat(s, axis=2)
        canvas = fr.get("canvas")
        if canvas:
            h, w = int(canvas[0]), int(canvas[1])
            c = rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)
            ys = rng.integers(0, h - f.shape[1] + 1, B)
            xs = rng.integers(0, w - f.shape[2] + 1, B)
            for b in range(B):
                c[b, ys[b]:ys[b] + f.shape[1], xs[b]:xs[b] + f.shape[2]] = f[b]
            f = c
        out.append(np.ascontiguousarray(f))
    return out
