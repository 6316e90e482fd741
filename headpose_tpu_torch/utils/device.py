"""Device resolution for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """`None` means the card: it resolves to "cuda" and raises when no CUDA
    device is present.  The port never carries on quietly on the CPU; a
    caller that wants the CPU asks for it (`device="cpu"`)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}; use 'cuda' or 'cpu'")
    return device
