"""Reliable Broadcast protocol: segmentation, bitmap sizing, and the
engine-backed timing facade.

Port of the parts of ``src/repro/core/protocol.py`` the Broadcast and
Allgather use: ``MTU``, ``segment``, ``bitmap_bytes``, ``cutoff_time``,
``broadcast_time`` and ``allgather_time``; the closed-form oracle of the
analytic fidelity (``analytic_rnr_barrier``, ``analytic_bcast_time``,
``analytic_allgather_time``, ``analytic_ring_allgather_time``,
``analytic_ring_reduce_scatter_time``, reference protocol.py:216-299); and
``reassemble``, a leaf's receive datapath replayed on the chunk reassembly
kernel in the order a Broadcast delivered them. The logical state machines
(``LeafReceiver``, ``StagingRing``, ``Bitmap``) and the closed forms of the
composite collectives are queued in ROADMAP.md.
"""
from __future__ import annotations

import math

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


def cutoff_time(n_bytes: int, b_link: float, alpha: float = 50e-6) -> float:
    """§III-C: timeout = N/B_link + alpha (RNR sync + network noise)."""
    return n_bytes / b_link + alpha


def broadcast_time(p: int, n_bytes: int, fabric=None, workers=None, *,
                   fidelity: str = "packet", seed: int = 0, device=None,
                   **kw) -> float:
    """Completion time of one reliable Broadcast rooted at rank 0, from the
    engine of ``fidelity`` (the packet engine by default, or the fluid one)
    with a generator seeded by ``seed``, as the reference resolves it:
    ``broadcast_time`` -> ``simulator.simulate_broadcast`` ->
    ``sched_ir.execute``. Other keywords go to the packet engine. The
    leaves' receive datapath runs on ``device`` (default ``cuda``)."""
    from repro_torch.core import engine, simulator   # deferred: packet imports us

    _no_event_dpa(kw)
    return simulator.simulate_broadcast(
        p, n_bytes, fabric or engine.FabricParams(), workers or engine.WorkerParams(),
        np.random.default_rng(seed), fidelity=fidelity, device=device, **kw).time


def allgather_time(p: int, n_bytes: int, fabric=None, workers=None, *,
                   n_chains: int = 1, fidelity: str = "packet", seed: int = 0,
                   device=None, **kw) -> float:
    """Completion time of one reliable M-chain Allgather (reference
    protocol.py:193), from ``simulator.simulate_allgather`` at ``fidelity``
    with a generator seeded by ``seed``; as ``broadcast_time`` otherwise."""
    from repro_torch.core import engine, simulator   # deferred: packet imports us

    _no_event_dpa(kw)
    return simulator.simulate_allgather(
        p, n_bytes, fabric or engine.FabricParams(), workers or engine.WorkerParams(),
        np.random.default_rng(seed), n_chains, fidelity=fidelity, device=device, **kw).time


def _no_event_dpa(kw: dict) -> None:
    if kw.pop("dpa", None) is not None:
        raise NotImplementedError(
            "dpa=: the event-level DPA is not ported yet (ROADMAP.md §1, item 7)")


# ----------------------------------------------- closed-form cross-check oracle


def analytic_rnr_barrier(p: int, latency: float, rnr_hop: float = 1.5e-6) -> float:
    """§V-A recursive-doubling RNR barrier (the engines' own)."""
    return math.ceil(math.log2(max(p, 2))) * (latency + rnr_hop)


def analytic_bcast_time(p: int, n_bytes: int, b_link: float, latency: float, *,
                        pool_rate: float | None = None, depth: int = 1,
                        rnr_hop: float = 1.5e-6) -> float:
    """Lossless closed form of the Broadcast: RNR barrier + the stream at the
    slower of wire and worker pool + per-hop latency + final handshake."""
    rate = b_link if pool_rate is None else min(b_link, pool_rate)
    return (analytic_rnr_barrier(p, latency, rnr_hop)
            + n_bytes / rate + depth * latency + latency)


def analytic_allgather_time(p: int, n_bytes: int, b_link: float, latency: float, *,
                            n_chains: int = 1, pool_rate: float | None = None,
                            rnr_hop: float = 1.5e-6) -> float:
    """Lossless closed form (a lower bound) of the Allgather: RNR barrier +
    the (P-1)N gathered bytes at the slower of wire and worker pool + one
    activation hop a generation (R = ceil(P/M)) + the final handshake."""
    rate = b_link if pool_rate is None else min(b_link, pool_rate)
    rounds = -(-p // n_chains)
    return (analytic_rnr_barrier(p, latency, rnr_hop)
            + (p - 1) * n_bytes / rate + rounds * latency + latency)


def analytic_ring_allgather_time(p: int, n_bytes: int, b_link: float,
                                 latency: float) -> float:
    """Closed form of the ring Allgather: P-1 generations, each forwarding an
    N-byte shard on the full-duplex NIC plus one hop."""
    return (p - 1) * (n_bytes / b_link + latency)


def analytic_ring_reduce_scatter_time(p: int, n_bytes: int, b_link: float,
                                      latency: float) -> float:
    """Closed form of the ring Reduce-Scatter of an N-byte buffer a rank:
    P-1 generations of the N/P shard (reduction at line rate)."""
    return (p - 1) * (n_bytes / p / b_link + latency)
