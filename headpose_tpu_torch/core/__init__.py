from .activations import ACTIVATIONS, get_activation

__all__ = ["ACTIVATIONS", "get_activation"]
