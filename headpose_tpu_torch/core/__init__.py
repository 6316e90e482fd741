"""Core infrastructure of the port: the Keras activation table, the
single-pass bf16 arithmetic, the H5 reader and the graph → PyTorch
compiler.

Exports resolve lazily (PEP 562): the model modules import the activation
table and the single-pass arithmetic, and load no H5 code for it."""
import importlib

_EXPORTS = {
    "ACTIVATIONS": ".activations", "get_activation": ".activations",
    "LayerDef": ".h5io", "ModelDef": ".h5io", "read_model": ".h5io",
    "GraphModel": ".graph", "TrainableGraphHead": ".graph",
    "compile_model": ".graph", "load_graph_model": ".graph",
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
