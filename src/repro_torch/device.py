"""The device an entry point of the port runs on, and the second CUDA
stream that its overlapped work (the prefetched gathers, concurrent AG/RS's
gather) uses there."""
from __future__ import annotations

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


# the side stream of each device, made once: the caching allocator keeps a
# pool of blocks per stream, and a new stream each call (PyTorch hands out
# its pooled streams in turn) would start from an empty pool every time
_SIDE_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


class SideStream:
    """The side stream of ``device`` for work that is issued ahead of the
    current stream's use of it (the training path's prefetched gathers,
    concurrent AG/RS's gather), and the events that join it there. On
    creation the side stream waits for the current stream's work so far.
    On the CPU there is no stream: ``issue`` runs the work in place and
    ``join`` waits for nothing."""

    def __init__(self, device: torch.device):
        self.stream = None
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            if device not in _SIDE_STREAMS:
                _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
            self.stream = _SIDE_STREAMS[device]
            self.stream.wait_stream(torch.cuda.current_stream(device))

    def issue(self, fn, *args):
        """``fn(*args)`` on the side stream. Returns its result and an event
        recorded on the side stream after it (None on the CPU). Every
        tensor of the result is recorded as in use by the current stream,
        which reads it after ``join``, so that the caching allocator does not
        hand its memory out before that stream's work on it ends."""
        if self.stream is None:
            return fn(*args), None
        main = torch.cuda.current_stream(self.stream.device)
        with torch.cuda.stream(self.stream):
            out = fn(*args)
            done = torch.cuda.Event()
            done.record(self.stream)
        for t in _tensors(out):
            t.record_stream(main)
        return out, done

    def join(self, done: torch.cuda.Event | None) -> None:
        """The current stream waits for the work that ``done`` (from
        ``issue``) marks."""
        if done is not None:
            torch.cuda.current_stream(self.stream.device).wait_event(done)


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
