"""Protocol-level timing simulators: the facades over the schedule IR.

Port of ``simulate_broadcast`` and ``simulate_allgather``
(src/repro/core/simulator.py:74,95). Each builds the schedule graph
(``sched_ir.build_broadcast_tree`` / ``build_allgather``) and hands it to
``sched_ir.execute``. They keep the reference's signatures, its default
``fidelity="fluid"`` included; the port has only the packet fidelity yet,
and the fluid one raises ``NotImplementedError`` (ROADMAP.md §1, item 5).
The leaves' receive datapath runs on ``device`` (default ``cuda``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import sched_ir
from repro_torch.core.engine import FabricParams, WorkerParams

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
