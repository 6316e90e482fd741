"""Hand-written CUDA kernels of the port, each with its wrapper.

Importing a module here builds nothing: each kernel is compiled with nvcc on
its first launch (utils.build)."""
from .postprocess import postprocess_kernel

__all__ = ["postprocess_kernel"]
