"""TFLite export — the edge-deployment format of the reference's ecosystem.

Port of headpose_tpu/tools/tflite.py.  The reference's detector is a Keras
port of MediaPipe BlazeFace, whose canonical distribution format is
`.tflite`.  This module closes the loop in the other direction: any native
head, any native unified model, and any reference-format H5 artifact export
to a float32 `.tflite` with a named `serving_default` signature, numerically
validated against the port's own CPU forward before the artifact leaves the
build host (the reference's own validation idiom —
InputShapeConvertor.py:129-218).

Route: `tools.h5export` writes the reference-format Keras-2 graph (all five
head families, ensembles, and the 6-output unified contract), tf-keras
loads it, and TF's converter freezes it through a SavedModel so the named
inputs/outputs survive into the TFLite SignatureDef.  tensorflow and
tf_keras are imported inside the functions that need them; the module
imports without them.

The exported artifact expects the same input as its source model — for
unified models the preprocessed [-1, 1] (B, 128, 128, 3) image; decode/NMS
stay host-side, exactly like the reference (and MediaPipe) deployments
(runtime.edge serves the artifact with the native C++ postprocess).
TFLite graphs are static-shape; pick `batch` at export time (edge default
1) or `Interpreter.resize_tensor_input` at load time.

    from headpose_tpu_torch.pretrained import load_flagship
    from headpose_tpu_torch.tools.tflite import (export_unified_tflite,
                                                 TFLiteModel)
    model, params = load_flagship()
    export_unified_tflite(model, params, "flagship.tflite")
    out = TFLiteModel("flagship.tflite")(image=x)   # dict of 6 named outputs

CLI:  python -m headpose_tpu_torch.tools.tflite \
          --model unified-stoqa9pt-hrchr82r --out m.tflite

(`unified-best` carries SE-gated ensemble heads, whose map-grafted pose maps
diverge from the calibrated per-vector function — export_unified_tflite
refuses them by default and the error spells out the per-face alternative.)
"""
from __future__ import annotations

import os
import tempfile

import numpy as np

__all__ = ["export_head_tflite", "export_unified_tflite", "export_h5_tflite",
           "TFLiteModel", "UNIFIED_OUTPUT_NAMES"]

# the reference unified contract, in graph output order (JoinModels.py:152-158)
UNIFIED_OUTPUT_NAMES = ("cls_front", "cls_back", "loc_front", "loc_back",
                        "pose_front", "pose_back")


def _require_tf():
    try:
        import tensorflow as tf
        import tf_keras
    except ImportError as e:  # pragma: no cover - baked into this container
        raise ImportError(
            "TFLite export needs tensorflow + tf_keras on the build host "
            "(the serving host only needs the .tflite runtime)") from e
    return tf, tf_keras


def _convert_keras(keras_model, input_specs: dict, output_names) -> bytes:
    """Freeze a loaded tf-keras model into TFLite flatbuffer bytes.

    Goes through a SavedModel (not from_concrete_functions) so the
    `serving_default` SignatureDef carries the given input/output NAMES —
    raw concrete-function conversion emits no signature at all and leaves
    callers matching anonymous `Identity_k` tensors by shape.
    """
    tf, _ = _require_tf()

    mod = tf.Module()
    mod.keras_model = keras_model  # track variables for saved_model.save
    names = list(output_names)

    def fwd(*xs):
        out = keras_model(xs[0] if len(xs) == 1 else list(xs))
        outs = out if isinstance(out, (list, tuple)) else [out]
        if len(outs) != len(names):
            raise ValueError(f"model emits {len(outs)} outputs, "
                             f"{len(names)} names given")
        return dict(zip(names, outs))

    sig = [tf.TensorSpec(shape, tf.float32, name=n)
           for n, shape in input_specs.items()]
    mod.fwd = tf.function(fwd, input_signature=sig, autograph=False)
    with tempfile.TemporaryDirectory() as d:
        tf.saved_model.save(
            mod, d, signatures={"serving_default":
                                mod.fwd.get_concrete_function()})
        conv = tf.lite.TFLiteConverter.from_saved_model(d)
        return conv.convert()


class TFLiteModel:
    """Tiny runner over a converted artifact's `serving_default` signature.

    Call with named arrays, get named arrays back:
        TFLiteModel("head.tflite")(features=x)["pose"]
    """

    def __init__(self, src: str | bytes):
        # running an artifact back needs only the interpreter — not
        # tf_keras, not the converter (the "serving host only needs the
        # .tflite runtime" claim above)
        try:
            import tensorflow as tf
        except ImportError as e:  # pragma: no cover
            raise ImportError("TFLiteModel needs a TFLite interpreter "
                              "(tensorflow, or the tflite-runtime wheel "
                              "with this class's two calls)") from e
        if isinstance(src, bytes):
            self._interp = tf.lite.Interpreter(model_content=src)
        else:
            self._interp = tf.lite.Interpreter(model_path=src)
        self._runner = self._interp.get_signature_runner("serving_default")

    @property
    def input_names(self) -> list[str]:
        return sorted(self._runner.get_input_details())

    @property
    def output_names(self) -> list[str]:
        return sorted(self._runner.get_output_details())

    def input_shape(self, name: str) -> tuple[int, ...]:
        """The artifact's baked shape for input `name` (TFLite graphs are
        static-shape, so this is the one shape the artifact serves)."""
        details = self._runner.get_input_details()
        if name not in details:
            raise KeyError(f"no input {name!r} (has {sorted(details)})")
        return tuple(int(d) for d in details[name]["shape"])

    def __call__(self, **inputs) -> dict[str, np.ndarray]:
        arrs = {k: np.ascontiguousarray(v, dtype=np.float32)
                for k, v in inputs.items()}
        return {k: np.asarray(v) for k, v in self._runner(**arrs).items()}


def _head_forward(spec, params, x: np.ndarray) -> np.ndarray:
    """The port's CPU forward of a head (JAX-layout params) over x."""
    import torch

    from ..models.heads import head_net
    from .convert import params_from_jax

    net = head_net(spec, device="cpu").eval()
    net.load_state_dict(params_from_jax(spec, params))
    with torch.no_grad():
        return net(torch.from_numpy(x)).numpy()


def _unified_outputs(model, params, x: np.ndarray) -> list[np.ndarray]:
    """The port's CPU forward of a unified model: the 6 reference outputs
    (`UnifiedPoseNet.reference_outputs`) of the preprocessed images x."""
    import torch

    from ..models.unified import UnifiedPoseNet
    from .convert import params_from_jax

    net = UnifiedPoseNet(model, device="cpu").eval()
    net.load_state_dict(params_from_jax(model, params))
    with torch.no_grad():
        return [t.numpy() for t in net.reference_outputs(torch.from_numpy(x))]


def _validate(blob: bytes, inputs: dict, want: dict, atol: float) -> dict:
    """Run the flatbuffer on the build host and gate on |tflite - native|,
    the port's own CPU forward."""
    got = TFLiteModel(blob)(**inputs)
    report = {}
    for name, w in want.items():
        w = np.asarray(w, np.float32)
        if name not in got:
            raise ValueError(f"converted model lost output {name!r} "
                             f"(has {sorted(got)})")
        if got[name].shape != w.shape:
            raise ValueError(f"output {name!r} shape {got[name].shape} != "
                             f"native {w.shape}")
        err = float(np.abs(got[name] - w).max())
        if not err <= atol:  # catches NaN too
            raise ValueError(f"TFLite output {name!r} diverges from the "
                             f"native forward: maxerr {err:.3e} > {atol:.0e}")
        report[name] = err
    return report


def export_head_tflite(spec, params, path: str, *, batch: int = 1,
                       input_shape: tuple[int, ...] | None = None,
                       validate: bool = True, atol: float = 5e-5) -> dict:
    """Export a native pose head (any family save_head_h5 supports) to a
    float32 .tflite with signature `features -> pose`.

    `input_shape` defaults to the per-face vector shape (batch, 1, 1, C) —
    the dataset/training semantics (train_96.py:134-140); pass (B, H, W, C)
    to bake a map-shaped variant instead (an explicit shape wins over
    `batch`).  Returns a report dict with the artifact size and, when
    `validate`, the max |tflite - native| per output, against the port's
    CPU forward of the head (`head(x)`).  The default atol is
    f32 accumulation-order noise (wide softsign chains reach ~2e-5),
    four orders below the 0.1° pose parity budget.
    """
    _, tf_keras = _require_tf()
    from .h5export import save_head_h5

    if input_shape is None:
        c = getattr(spec, "in_features", None)
        if c is None:
            raise ValueError(f"{type(spec).__name__} declares no "
                             "in_features; pass input_shape explicitly")
        input_shape = (batch, 1, 1, int(c))
    with tempfile.TemporaryDirectory() as d:
        h5 = os.path.join(d, "head.h5")
        save_head_h5(spec, params, h5)
        m = tf_keras.models.load_model(h5, compile=False)
        blob = _convert_keras(m, {"features": input_shape}, ["pose"])
    report = {"bytes": len(blob), "input_shape": tuple(input_shape)}
    if validate:
        x = np.random.default_rng(0).normal(size=input_shape).astype(
            np.float32)
        want = _head_forward(spec, params, x)
        report["maxerr"] = _validate(blob, {"features": x},
                                     {"pose": want}, atol)["pose"]
    with open(path, "wb") as f:
        f.write(blob)
    return report


def export_unified_tflite(model, params, path: str, *, batch: int = 1,
                          validate: bool = True, atol: float = 2e-4,
                          allow_spatial_heads: bool = False) -> dict:
    """Export a native UnifiedPoseModel to .tflite with the reference's
    6-output contract as named signature outputs (`image` in, cls/loc/pose
    front+back out — JoinModels.py:152-158).

    Input is the preprocessed [-1, 1] image, like the source H5; the default
    atol matches the importer's own golden budget (test_models.py, ≤2e-4 vs
    the executing reference).

    Heads with spatial context (SE gating, attention — anything declaring
    ``spatial_context``) are REFUSED by default: the 6-output contract bakes
    map-grafted pose maps, which for such heads diverge p50 3.9° / max 26.5°
    from the calibrated per-vector function they were scored on
    (docs/headeval_divergence.json; the serving stack runs them
    ``head_eval='survivors'`` for the same reason).  Per-cell heads (the
    flagship's) are unaffected — map and vector semantics are identical.
    """
    _, tf_keras = _require_tf()
    from .h5export import save_unified_h5

    spatial = [n for n, h in (("head88", model.head88),
                              ("head96", model.head96))
               if h is not None and getattr(h, "spatial_context", False)]
    if spatial and not allow_spatial_heads:
        raise ValueError(
            f"{', '.join(spatial)} declare spatial context: the unified "
            "TFLite graph would bake MAP-grafted pose maps, which diverge "
            "p50 3.9° / max 26.5° from the per-vector function "
            "these heads were calibrated on (docs/headeval_divergence."
            "json).  Export a per-cell unified model (e.g. the flagship "
            "'unified-stoqa9pt-hrchr82r') — or ship the head separately "
            "via export_head_tflite (input (1, 1, 1, C) IS the per-vector "
            "function) and gather survivor feature vectors host-side.  "
            "Pass allow_spatial_heads=True to bake map semantics anyway.")
    size = int(model.backbone.input_size)
    with tempfile.TemporaryDirectory() as d:
        h5 = os.path.join(d, "unified.h5")
        save_unified_h5(model, params, h5)
        m = tf_keras.models.load_model(h5, compile=False)
        if len(m.outputs) != len(UNIFIED_OUTPUT_NAMES):
            raise ValueError(f"unified H5 emits {len(m.outputs)} outputs, "
                             f"expected {len(UNIFIED_OUTPUT_NAMES)}")
        blob = _convert_keras(m, {"image": (batch, size, size, 3)},
                              UNIFIED_OUTPUT_NAMES)
    report = {"bytes": len(blob), "input_shape": (batch, size, size, 3)}
    if validate:
        x = np.random.default_rng(0).uniform(
            -1, 1, (batch, size, size, 3)).astype(np.float32)
        want = dict(zip(UNIFIED_OUTPUT_NAMES,
                        _unified_outputs(model, params, x)))
        report["maxerr"] = _validate(blob, {"image": x}, want, atol)
    with open(path, "wb") as f:
        f.write(blob)
    return report


def export_h5_tflite(h5_path: str, path: str, *, batch: int = 1,
                     input_shape: tuple[int, ...] | None = None,
                     validate: bool = True, atol: float = 2e-4) -> dict:
    """Export a reference-format H5 artifact (any graph tf_keras loads) to
    .tflite, validated against this framework's own graph compiler
    (`core.load_graph_model`) on the same input.

    Dynamic dims resolve to `batch` on the batch axis and 1 elsewhere
    unless `input_shape` pins them.  Signature names follow the Keras
    graph: its input names in, its output layer names out.  Validated
    against the port's graph compiler (`core.load_graph_model`) on the
    CPU.
    """
    _, tf_keras = _require_tf()

    m = tf_keras.models.load_model(h5_path, compile=False)
    if len(m.inputs) != 1:
        raise ValueError(f"{h5_path} has {len(m.inputs)} inputs; only "
                         "single-input artifacts export")
    if input_shape is None:
        dims = list(m.inputs[0].shape)
        input_shape = tuple(int(d) if d is not None else (batch if i == 0
                            else 1) for i, d in enumerate(dims))
    in_name = m.inputs[0].name.split(":")[0]
    out_names = [t.name.split("/")[0].split(":")[0] for t in m.outputs]
    blob = _convert_keras(m, {in_name: input_shape}, out_names)
    report = {"bytes": len(blob), "input_shape": tuple(input_shape),
              "inputs": [in_name], "outputs": out_names}
    if validate:
        import torch

        from ..core.graph import load_graph_model
        gm = load_graph_model(h5_path, device="cpu")
        x = np.random.default_rng(0).normal(size=input_shape).astype(
            np.float32)
        with torch.no_grad():
            native = gm(torch.from_numpy(x))
        native = native if isinstance(native, (list, tuple)) else [native]
        want = {n: v.numpy() for n, v in zip(out_names, native)}
        report["maxerr"] = _validate(blob, {in_name: x}, want, atol)
    with open(path, "wb") as f:
        f.write(blob)
    return report


def main(argv=None) -> None:
    import argparse

    from ..pretrained import resolve_model_path

    p = argparse.ArgumentParser(
        description="Export a model to TFLite (float32, named "
                    "serving_default signature), validated against the "
                    "port's CPU forward.")
    p.add_argument("--model", required=True,
                   help="pretrained registry name (e.g. unified-best, "
                        "distill96), native model dir, or reference-format "
                        "H5 path")
    p.add_argument("--out", required=True, help="output .tflite path")
    p.add_argument("--batch", type=int, default=1,
                   help="static batch size to bake (edge default 1)")
    p.add_argument("--no-validate", action="store_true")
    args = p.parse_args(argv)

    path = resolve_model_path(args.model)
    validate = not args.no_validate
    if path is not None and os.path.isdir(path):
        from .export import load_model
        spec, params = load_model(path)
    elif path is not None and path.endswith((".h5", ".hdf5")):
        # (.keras archives are Keras 3's zip format — neither tf-keras nor
        # the validation reader consumes them; re-save as H5 first)
        report = export_h5_tflite(path, args.out, batch=args.batch,
                                  validate=validate)
        print(f"wrote {args.out}: {report}")
        return
    else:
        from ..pretrained import load_pretrained
        spec, params = load_pretrained(args.model)
    if hasattr(spec, "backbone"):
        report = export_unified_tflite(spec, params, args.out,
                                       batch=args.batch, validate=validate)
    else:
        report = export_head_tflite(spec, params, args.out,
                                    batch=args.batch, validate=validate)
    print(f"wrote {args.out}: {report}")


if __name__ == "__main__":
    main()
