from .detector import FaceDetector
from .results import BatchResults, Results

__all__ = ["FaceDetector", "BatchResults", "Results"]
