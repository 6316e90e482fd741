"""Write the seeded SE-Transformer model as a native model directory.

The model is the flagship's backbone and SSD weights (`unified-stoqa9pt-
hrchr82r`, unchanged) with `SETransformerHead(88)` and
`SETransformerHead(96)` at their published fields (the reference's
se_transformer_regr_head, Maaz77/Head-Pose-Estimation-Model
Model-88/attention_model.py:16-80).  No trained weights of this head
exist, so each head's weights come from `SETransformerHead.init` with a
torch generator seeded by its width (88, 96), and every leaf is then moved
by N(0, 0.05) noise from numpy's generator seeded the same, so that biases
and LayerNorm offsets are not zero.  The same seeds give the same arrays.

    python -m headpose_tpu_torch.tools.seed_se_model OUT_DIR

writes OUT_DIR/spec.json and OUT_DIR/params.npz through
`tools.export.save_model`; `FaceDetector.from_native(OUT_DIR)` serves it.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models.heads import SETransformerHead
from ..models.params import flatten_params, unflatten_params
from ..models.unified import UnifiedPoseModel
from ..pretrained import FLAGSHIP, load_pretrained
from .export import save_model

__all__ = ["NOISE", "seeded_head", "seeded_model"]

NOISE = 0.05                 # std of the noise added to every leaf

METADATA = {
    "source": f"{FLAGSHIP}'s backbone and SSD weights with two "
              "SETransformerHead heads (se_transformer_regr_head, "
              "Maaz77/Head-Pose-Estimation-Model "
              "Model-88/attention_model.py:16-80)",
    "weights": "seeded, untrained: the heads' init at seeds 88 and 96, "
               f"every leaf moved by N(0, {NOISE}) noise from the same seed",
    "quality": "seeded, untrained",
}


def seeded_head(spec: SETransformerHead, seed: int) -> dict:
    """The head's params in JAX layout: its init from a torch generator
    seeded by `seed`, every leaf (in path order) moved by N(0, NOISE) from
    numpy's generator seeded the same."""
    params = spec.init(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    return unflatten_params({
        path: (leaf + rng.normal(0.0, NOISE, leaf.shape)).astype(np.float32)
        for path, leaf in sorted(flatten_params(params).items())})


def seeded_model() -> tuple[UnifiedPoseModel, dict]:
    """(spec, params in JAX layout) of the seeded SE-Transformer model,
    each head seeded by its width."""
    spec, params = load_pretrained(FLAGSHIP)
    heads = {f"head{c}": SETransformerHead(c) for c in (88, 96)}
    model = UnifiedPoseModel(backbone=spec.backbone, **heads)
    return model, {"backbone": params["backbone"],
                   **{name: seeded_head(head, head.in_features)
                      for name, head in heads.items()}}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir")
    save_model(ap.parse_args(argv).out_dir, *seeded_model(),
               metadata=METADATA)


if __name__ == "__main__":
    main()
