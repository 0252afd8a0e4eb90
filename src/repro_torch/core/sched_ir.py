"""Shared pieces of the collective schedule IR that the packet Broadcast uses.

Port of ``PhaseBreakdown``, ``_chunking`` and ``_rnr_barrier``
(src/repro/core/sched_ir.py:79-129). The rest of that module (the typed
schedule graph, its builders, and the fluid, analytic and packet lowerings
of Allgather, ring, reduce-scatter and all-reduce schedules) is queued in
ROADMAP.md; a Broadcast rooted at 0 lowers straight to
``core/packet.simulate_packet_broadcast``, as ``sched_ir.execute`` does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.engine import FabricParams, WorkerParams


@dataclass
class PhaseBreakdown:
    rnr_sync: float = 0.0
    multicast: float = 0.0
    reliability: float = 0.0
    handshake: float = 0.0

    def total(self) -> float:
        return self.rnr_sync + self.multicast + self.reliability + self.handshake


def _chunking(n_bytes: int, mtu: int) -> tuple[int, int]:
    n_chunks = max(-(-n_bytes // mtu), 1)
    chunk = min(mtu, n_bytes) if n_bytes else mtu
    return n_chunks, chunk


def _rnr_barrier(p: int, fabric: FabricParams, workers: WorkerParams) -> float:
    """The RNR barrier: recursive doubling (paper §V-A)."""
    rounds = int(np.ceil(np.log2(max(p, 2))))
    return rounds * (fabric.latency + workers.rnr_barrier_hop)
