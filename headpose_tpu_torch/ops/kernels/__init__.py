"""Hand-written CUDA kernels of the port, each with its wrapper.

Importing a module here builds nothing: each kernel is compiled with nvcc on
its first launch (utils.build)."""
from .backbone import backbone_forward
from .backbone2 import apply_fused
from .dense_bf16 import dense_block
from .head_mlp import mlp_head_forward
from .postprocess import postprocess_kernel
from .se_attention import se_transformer_forward

__all__ = ["apply_fused", "backbone_forward", "dense_block",
           "mlp_head_forward",
           "postprocess_kernel", "se_transformer_forward"]
