"""headpose_tpu_torch — the PyTorch/CUDA port of headpose_tpu.

BlazeFace face detection with grafted yaw/pitch/roll regression heads, served
through `runtime.FaceDetector.detect` on an NVIDIA GPU.  Plain tensor code is
PyTorch; the detection postprocess (threshold, greedy NMS, survivor
extraction) is a hand-written CUDA kernel (`csrc/postprocess.cu`) with a
plain PyTorch twin that the CPU path and the tests use.

The package imports `torch` and numpy only: never `jax`, and nothing of the
`headpose_tpu` package.  Public functions keep that package's NHWC layout so
the two can be compared like for like.

Submodules load lazily (PEP 562): `import headpose_tpu_torch` costs nothing
beyond this file.
"""
import importlib

__version__ = "0.1.0"

_SUBMODULES = ("core", "models", "ops", "data", "utils", "runtime", "train",
               "tools", "pretrained", "compat", "parallel")

__all__ = [*_SUBMODULES, "__version__"]


def __getattr__(name: str):
    if name in _SUBMODULES:
        module = importlib.import_module(f".{name}", __name__)
        globals()[name] = module          # cache: __getattr__ runs once
        return module
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(__all__)
