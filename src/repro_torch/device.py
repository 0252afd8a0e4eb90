"""The device an entry point of the port runs on."""
from __future__ import annotations

import torch


def device_of(name: str | torch.device) -> torch.device:
    """The device an entry point runs on; raises if it asks for CUDA where
    there is none, rather than falling back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(name)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev
