"""Device selection for the port's entry points.

The port serves on the CUDA card. A caller that wants the CPU (the tests,
a laptop) says so with device="cpu"; nothing falls back to the CPU
quietly when the card is missing.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """None -> the current CUDA device, or RuntimeError when there is none.

    An explicit device is returned as given, a CUDA one with its index
    filled in (and it still has to exist)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not "
                               f"available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
