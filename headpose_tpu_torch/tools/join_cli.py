"""Join CLI: compose a detector with two trained pose heads → a unified
native model directory.

Port of headpose_tpu/tools/join_cli.py (the reference's JoinModels.py
workflow as a command):

    python -m headpose_tpu_torch.tools.join_cli \
        --detector joined.h5 --reg1 stoqa9pt.h5 --reg2 hrchr82r.h5 \
        --out UnifiedNative/

Heads may be reference H5s or native model directories (tools.export
format).  The output directory is named reg1-{id1}-reg2-{id2}, the
reference's naming scheme, and one forward of the joined network checks the
6-output contract before it is saved: on the card unless `--device cpu`.
"""
from __future__ import annotations

import argparse
import os

import torch

from ..models.blazeface import blazeface_from_h5
from ..models.heads import head_from_h5
from ..models.params import params_from_jax
from ..models.unified import UnifiedPoseNet, join_models
from ..utils.device import resolve_device
from .export import load_model, save_model

__all__ = ["extract_id_from_path", "join_and_save"]


def extract_id_from_path(path: str) -> str:
    """Model id from '.../<id>.h5' or a native model dir '.../<id>/'."""
    base = os.path.basename(os.path.normpath(path))
    return base[:-3] if base.endswith(".h5") else base


def _load_head(path: str):
    if os.path.isdir(path):
        return load_model(path)
    return head_from_h5(path)


def join_and_save(detector_path, reg1_path: str, reg2_path: str,
                  out_dir: str, metadata: dict | None = None, *,
                  device: str | torch.device | None = None) -> str:
    """Join the backbone of `detector_path` (any unified H5, or its ModelDef
    parsed already, as the loaders take) with the two heads; returns the
    saved model directory.  The contract check, one zero frame giving six
    outputs of the reference's shapes, runs on `device` (None: the card)."""
    for p in (detector_path, reg1_path, reg2_path):
        if isinstance(p, str) and not os.path.exists(p):
            raise FileNotFoundError(f"model not found: {p}")
    device = resolve_device(device)

    backbone_spec, backbone_params = blazeface_from_h5(detector_path)
    h88, p88 = _load_head(reg1_path)
    h96, p96 = _load_head(reg2_path)
    model, params = join_models(backbone_spec, backbone_params,
                                h88, p88, h96, p96)

    # the 6-output contract of the reference's unified model
    net = UnifiedPoseNet(model, device=device).eval()
    net.load_state_dict(params_from_jax(model, params))
    with torch.inference_mode():
        outs = net.reference_outputs(torch.zeros((1, 128, 128, 3),
                                                 device=device))
    shapes = [tuple(o.shape) for o in outs]
    expected = [(1, 512, 1), (1, 384, 1), (1, 512, 16), (1, 384, 16),
                (1, 16, 16, 3), (1, 8, 8, 3)]
    if shapes != expected:
        raise RuntimeError(f"unified contract violated: {shapes}")

    name = (f"reg1-{extract_id_from_path(reg1_path)}"
            f"-reg2-{extract_id_from_path(reg2_path)}")
    out_path = os.path.join(out_dir, name)
    save_model(out_path, model, params, metadata={
        "detector": (os.path.abspath(detector_path)
                     if isinstance(detector_path, str) else detector_path.name),
        "reg1": os.path.abspath(reg1_path),
        "reg2": os.path.abspath(reg2_path),
        **(metadata or {})})
    return out_path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--detector", required=True,
                   help="H5 with the BlazeFace backbone (any unified H5 works)")
    p.add_argument("--reg1", required=True,
                   help="88-feature head (H5 or native dir)")
    p.add_argument("--reg2", required=True,
                   help="96-feature head (H5 or native dir)")
    p.add_argument("--out", required=True, help="output directory")
    p.add_argument("--device", default=None,
                   help="device of the contract check (default: the card)")
    args = p.parse_args(argv)
    out = join_and_save(args.detector, args.reg1, args.reg2, args.out,
                        device=args.device)
    print(f"unified model saved to {out}")


if __name__ == "__main__":
    main()
