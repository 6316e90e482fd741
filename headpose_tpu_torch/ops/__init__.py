from .bicubic import bicubic_matrix
from .detection import MAX_FACES, postprocess
from .image import preprocess, resize_bicubic
from .kernels import postprocess_kernel

__all__ = ["bicubic_matrix", "MAX_FACES", "postprocess", "preprocess",
           "resize_bicubic", "postprocess_kernel"]
