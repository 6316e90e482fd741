"""The conversion of reference H5 heads into native model directories.

Port of headpose_tpu/tools/convert.py, the reference's
InputShapeConvertor rethought: a reference head H5 is imported as a native
head (`models.head_from_h5`, shape-polymorphic, so no input-shape surgery)
and its equivalence proved against the H5's own graph (`core.graph`) on
random vectors and maps, at the reference's bar np.allclose(rtol=1e-5,
atol=1e-5): `validate_conversion`, `convert_head`, `batch_convert` and the
CLI

    python -m headpose_tpu_torch.tools.convert <h5 or dir> <out dir>

The native model directory it writes, and the weight bridge between the
JAX layout and the port, are models/params.py's.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import re

import numpy as np
import torch

from ..models.params import params_from_jax

__all__ = ["ConversionReport", "validate_conversion", "convert_head",
           "batch_convert"]


# ------------------------------------------------ reference H5 conversion
@dataclasses.dataclass
class ConversionReport:
    source: str
    output: str | None
    converted: bool
    validated: bool
    max_abs_error: float | None
    error: str | None = None


def validate_conversion(h5_path, spec, params, num_samples: int = 8,
                        rtol: float = 1e-5, atol: float = 1e-5,
                        device: str | torch.device | None = None) -> float:
    """Numeric equivalence of the native head (spec, params in JAX layout)
    and the original H5 graph (a path, or a ModelDef parsed already) on
    random inputs: a batch of vectors and, where the graph takes one, a
    spatial map; both in fp32 with TF32 off on `device` (None: the card).
    Returns the max abs error; raises AssertionError on a mismatch."""
    from ..core.graph import load_graph_model
    from ..core.single_pass import fp32_exact
    from ..models.heads import head_net
    from ..utils.device import resolve_device

    device = resolve_device(device)
    ref = load_graph_model(h5_path, device=device)
    net = head_net(spec, device=device).eval()
    net.load_state_dict(params_from_jax(spec, params))
    rng = np.random.default_rng(0)
    c = spec.in_features

    def run(module, x):
        with fp32_exact(), torch.inference_mode():
            return module(torch.tensor(x, device=device)).cpu().numpy()

    x = rng.normal(size=(num_samples, 1, 1, c)).astype(np.float32) * 3.0
    ref_out = run(ref, x).reshape(num_samples, -1)
    ours = run(net, x.reshape(num_samples, c))
    max_err = float(np.abs(ref_out - ours).max())
    np.testing.assert_allclose(ours, ref_out, rtol=rtol, atol=atol)

    xm = rng.normal(size=(2, 4, 4, c)).astype(np.float32)
    try:
        # only the reference graph may be excused (fixed-shape Flatten
        # variants reject spatial inputs); the native head failing or the
        # comparison failing propagates
        ref_map = run(ref, xm)
    except Exception:
        ref_map = None
    if ref_map is not None:
        ours_map = run(net, xm)
        if ref_map.shape == ours_map.shape:  # fixed-shape H5s can't do maps
            max_err = max(max_err, float(np.abs(ref_map - ours_map).max()))
            np.testing.assert_allclose(ours_map, ref_map, rtol=rtol,
                                       atol=atol)
    return max_err


def convert_head(h5_path: str, out_dir: str, validate: bool = True,
                 device: str | torch.device | None = None
                 ) -> ConversionReport:
    """One reference head H5 → a native model directory under `out_dir`
    (named by the file, less a 'model_runid_' prefix), validated first."""
    from ..models.heads import head_from_h5
    from .export import save_model

    name = re.sub(r"^model_runid_", "", os.path.basename(h5_path))[:-3]
    out_path = os.path.join(out_dir, name)
    try:
        spec, params = head_from_h5(h5_path)
    except Exception as e:
        return ConversionReport(h5_path, None, False, False, None, str(e))
    max_err = None
    if validate:
        try:
            max_err = validate_conversion(h5_path, spec, params,
                                          device=device)
        except Exception as e:
            return ConversionReport(h5_path, None, True, False, None, str(e))
    save_model(out_path, spec, params,
               metadata={"source_h5": os.path.abspath(h5_path)})
    return ConversionReport(h5_path, out_path, True, validate, max_err)


def batch_convert(src_dir: str, out_dir: str, pattern: str = "*.h5",
                  validate: bool = True, verbose: bool = True,
                  device: str | torch.device | None = None
                  ) -> list[ConversionReport]:
    """Convert a directory of head H5s; print the reference-style
    summary."""
    os.makedirs(out_dir, exist_ok=True)
    reports = []
    files = sorted(glob.glob(os.path.join(src_dir, pattern)))
    for i, path in enumerate(files):
        rep = convert_head(path, out_dir, validate, device=device)
        reports.append(rep)
        if verbose:
            status = ("ok" if rep.validated or (rep.converted and not validate)
                      else "FAILED")
            print(f"[{i + 1}/{len(files)}] {os.path.basename(path)}: {status}"
                  + (f" (max_err {rep.max_abs_error:.2e})"
                     if rep.max_abs_error is not None else "")
                  + (f" — {rep.error}" if rep.error else ""))
    converted = sum(r.converted for r in reports)
    validated = sum(r.validated for r in reports)
    failed = len(reports) - sum(bool(r.output) for r in reports)
    if verbose:
        print(f"\nSummary: {len(reports)} files, {converted} converted, "
              f"{validated} validated, {failed} failed")
    return reports


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help="H5 file or directory of H5 heads")
    p.add_argument("out", help="output directory for native models")
    p.add_argument("--pattern", default="*.h5")
    p.add_argument("--no_validate", action="store_true")
    p.add_argument("--device", default=None,
                   help="'cpu' to validate on the CPU; default: the card")
    args = p.parse_args(argv)
    if os.path.isdir(args.src):
        batch_convert(args.src, args.out, args.pattern,
                      validate=not args.no_validate, device=args.device)
    else:
        rep = convert_head(args.src, args.out, validate=not args.no_validate,
                           device=args.device)
        print(rep)


if __name__ == "__main__":
    main()
