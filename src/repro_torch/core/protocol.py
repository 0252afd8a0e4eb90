"""Reliable Broadcast protocol: segmentation, bitmap sizing, and the
engine-backed timing facade.

Port of the parts of ``src/repro/core/protocol.py`` the packet Broadcast
uses: ``MTU``, ``segment``, ``bitmap_bytes`` and ``broadcast_time``; and
``reassemble``, a leaf's receive datapath replayed on the chunk reassembly
kernel in the order a Broadcast delivered them. The logical state machines (``LeafReceiver``, ``StagingRing``, ``Bitmap``),
``allgather_time`` and the closed-form ``analytic_*`` oracle are queued in
ROADMAP.md.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import chunk_reassembly

MTU = 4096
PSN_BITS = 24           # of the 32-bit CQE immediate (rest: collective id, Fig 7)


def segment(buffer, mtu: int = MTU) -> torch.Tensor:
    """Fragment a root buffer into MTU chunks (§III-A): row i is the chunk
    with PSN i, as a ``(n_chunks, mtu)`` uint8 tensor; the last chunk is
    zero-padded to the MTU. ``buffer`` is bytes or a 1-D uint8 array or
    tensor; a tensor keeps its device."""
    if isinstance(buffer, torch.Tensor):
        flat = buffer.reshape(-1)
    else:
        flat = torch.from_numpy(np.frombuffer(bytes(buffer), dtype=np.uint8).copy())
    if flat.dtype != torch.uint8:
        raise TypeError(f"segment takes a byte buffer, got {flat.dtype}")
    n = flat.numel()
    n_chunks = -(-n // mtu)
    if n_chunks >= 1 << PSN_BITS:
        raise ValueError("the PSN must fit the immediate (Fig 7)")
    out = torch.zeros((n_chunks, mtu), dtype=torch.uint8, device=flat.device)
    out.view(-1)[:n] = flat
    return out


def reassemble(result, chunks: torch.Tensor, leaf: int,
               user: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's receive datapath: the root's ``chunks`` (from ``segment``),
    staged in the order the leaf's staging ring took them in
    (``result.delivery_order[leaf]`` of a Broadcast run with
    ``collect_delivery=True``), scattered into ``user`` by PSN on the chunk
    reassembly kernel (``kernels/chunk_reassembly.py``). ``user`` defaults
    to a zeroed buffer like ``chunks``. Returns (user, bitmap); after a
    completed Broadcast every bit is set and ``user`` equals ``chunks``."""
    if leaf not in result.delivery_order:
        raise ValueError(f"no delivery order for leaf {leaf}: run the Broadcast with "
                         "collect_delivery=True")
    psn = torch.from_numpy(result.delivery_order[leaf]).to(chunks.device)
    if user is None:
        user = torch.zeros_like(chunks)
    return chunk_reassembly.chunk_reassembly(chunks[psn], psn, user)


def bitmap_bytes(buffer_bytes: int, mtu: int = MTU) -> int:
    """Fig 7 / §III-D: one bit per chunk."""
    return (-(-buffer_bytes // mtu) + 7) // 8


def broadcast_time(p: int, n_bytes: int, fabric=None, workers=None, *,
                   fidelity: str = "packet", seed: int = 0, device=None,
                   **kw) -> float:
    """Completion time of one reliable Broadcast rooted at rank 0, from the
    packet engine (``core/packet.simulate_packet_broadcast``) with a
    generator seeded by ``seed``, as the reference resolves
    ``broadcast_time`` -> ``simulate_broadcast`` -> ``sched_ir.execute``.
    Other keywords go to the packet engine. The leaves' receive datapath
    runs on ``device`` (default ``cuda``)."""
    from repro_torch.core import engine, packet   # deferred: packet imports us

    if fidelity != "packet":
        raise NotImplementedError(
            f"fidelity={fidelity!r}: the fluid and analytic fidelities are not "
            "ported yet (ROADMAP.md, module queue)")
    if kw.pop("dpa", None) is not None:
        raise NotImplementedError(
            "dpa=: the event-level DPA is not ported yet (ROADMAP.md, module queue)")
    return packet.simulate_packet_broadcast(
        p, n_bytes, fabric or engine.FabricParams(), workers or engine.WorkerParams(),
        np.random.default_rng(seed), device=device, **kw).time
