"""The device an entry point of the port runs on, and the second CUDA
stream that its overlapped collectives use there."""
from __future__ import annotations

import contextlib
from typing import Iterator

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


@contextlib.contextmanager
def overlapped(device: torch.device, *buffers: torch.Tensor) -> Iterator[torch.cuda.Stream]:
    """Yields a side stream of ``device`` (one of PyTorch's pooled streams)
    for work that runs beside the current stream. It first waits for the
    current stream's work so far (which made ``buffers``); each buffer is
    recorded as in use by the side stream, so that the caching allocator
    does not hand its memory out before the side stream's work on it ends;
    on exit the current stream waits for the side stream."""
    main = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device=device)
    side.wait_stream(main)
    for buf in buffers:
        buf.record_stream(side)
    try:
        yield side
    finally:
        main.wait_stream(side)
