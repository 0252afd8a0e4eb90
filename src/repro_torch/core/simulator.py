"""Protocol-level timing simulators: the facades over the schedule IR.

Port of ``src/repro/core/simulator.py``. ``simulate_broadcast`` and
``simulate_allgather`` (:74, :95) build the schedule graph
(``sched_ir.build_broadcast_tree`` / ``build_allgather``) and hand it to
``sched_ir.execute``, with the reference's signatures and its default
``fidelity="fluid"``:

  "fluid"  (default) the fluid lowering: drops thin the arrival stream and
           recovery is the closed-form fetch-ring term;
  "packet" the packet lowering (``core/packet.py``): MTU packets, per-leaf
           loss models (``loss=``), NACK aggregation and retransmission
           rounds; at loss 0 it reproduces the fluid times. Its DPA has two
           fidelities (``dpa_fidelity="scalar"|"event"``, forwarded): the
           scalar worker pool (``workers_from_dpa``, re-exported here, sizes
           it from the calibrated model), or the event-level progress
           engine of ``core/dpa_engine.py`` (``dpa=``).

With ``topology=`` (``core/topology.py``: ``FatTree``, ``IslandFatTree``,
``Torus2D``; fluid fidelity) the ranks sit on hosts (``hosts=``, default
0..P-1) and every transfer is a routed flow: each chain root's stream is one
multicast tree flow, limited by the most contended link it crosses, and the
result's ``link_bytes`` holds the same engine run's per-link bytes (Fig.
12). Build the topology with ``b_host=fabric.b_link``. The engine's
vectorized max-min solve and the leaves' receive datapath run on ``device``
(default ``cuda``). ``sweep_phase_breakdown`` (:120) is Fig. 10.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import sched_ir
from repro_torch.core.engine import (FabricParams, WorkerParams,  # noqa: F401 (re-exported)
                                     workers_from_dpa)

FIDELITIES = ("fluid", "packet")


def _check(fidelity: str) -> None:
    if fidelity not in FIDELITIES:
        raise ValueError(f"fidelity must be one of {FIDELITIES}, got {fidelity!r}")


def simulate_broadcast(p: int, n_bytes: int, fabric: FabricParams, workers: WorkerParams,
                       rng: np.random.Generator, root: int = 0, *, topology=None, hosts=None,
                       fidelity: str = "fluid", loss=None, device=None, **packet_kw):
    """Reliable multicast Broadcast: ``build_broadcast_tree`` + ``execute``
    (reference simulator.py:74)."""
    _check(fidelity)
    sched = sched_ir.build_broadcast_tree(p, n_bytes, root)
    return sched_ir.execute(sched, fabric, workers, rng, fidelity=fidelity, topology=topology,
                            hosts=hosts, loss=loss, device=device, **packet_kw)


def simulate_allgather(p: int, n_bytes: int, fabric: FabricParams, workers: WorkerParams,
                       rng: np.random.Generator, n_chains: int = 1, *, topology=None,
                       hosts=None, fidelity: str = "fluid", loss=None, device=None,
                       **packet_kw):
    """Allgather = R generations of up to M concurrent Broadcasts (§IV-A):
    ``build_allgather`` + ``execute`` (reference simulator.py:95)."""
    _check(fidelity)
    sched = sched_ir.build_allgather(p, n_bytes, n_chains)
    return sched_ir.execute(sched, fabric, workers, rng, fidelity=fidelity, topology=topology,
                            hosts=hosts, loss=loss, device=device, **packet_kw)


def sweep_phase_breakdown(sizes: list[int], nodes: list[int],
                          fabric: FabricParams | None = None,
                          workers: WorkerParams | None = None, seed: int = 0, *,
                          device=None) -> list[dict]:
    """Fig. 10: the share of the protocol's time in each phase, across scale
    and message size (fluid Allgathers, one generator for the sweep)."""
    fabric = fabric or FabricParams(b_link=56e9 / 8)   # UCC testbed: 56 Gbit CX-3
    workers = workers or WorkerParams(n_recv_workers=1, thread_tput=9.0 * (1 << 30))
    out = []
    rng = np.random.default_rng(seed)
    for p in nodes:
        for n in sizes:
            res = simulate_allgather(p, n, fabric, workers, rng, device=device)
            ph = res.phases
            tot = ph.total()
            out.append({
                "nodes": p, "bytes": n,
                "rnr_frac": ph.rnr_sync / tot,
                "mcast_frac": ph.multicast / tot,
                "reliability_frac": ph.reliability / tot,
                "handshake_frac": ph.handshake / tot,
                "time": res.time,
            })
    return out
