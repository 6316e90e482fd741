"""Hand-written CUDA kernels of the port, each with its wrapper.

Importing a module here builds nothing: each kernel is compiled with nvcc on
its first launch (utils.build).  Every kernel that `FaceDetector.detect`
launches is a `torch.library` op of `library` (the `headpose_tpu_torch::`
namespace), which imports no model code; the wrappers check, pack and plan
on the host and launch through those ops.

Exports resolve lazily (PEP 562), so loading the op library (an exported
program's replay, tools/aot.py) does not import the wrappers and the models
they read."""
import importlib

_EXPORTS = {
    "apply_fused": ".backbone2",
    "backbone_forward": ".backbone",
    "dense_block": ".dense_bf16",
    "mlp_head_forward": ".head_mlp",
    "postprocess_kernel": ".postprocess",
    "se_transformer_forward": ".se_attention",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__), name)
        globals()[name] = value           # cache: __getattr__ runs once
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(__all__) | set(globals()))
