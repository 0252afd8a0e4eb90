"""The port's phase profiler (``core/profiling.py``) on the CPU: the
reference's switches, phases and report keys; every instrumented path's
results bitwise the same with the profiler on and off (and equal to the
reference's), the generators left in one state; each phase's calls where
the port does that work: ``engine_solve`` once a max-min solve
(``engine.counts["solves"]``), ``pool_solve`` once a pool pass (the row
passes that launch the pool kernel on a card and the 1-D host scans),
``rng`` and ``packing`` wherever the runs draw and pack. Disabled, nothing
is recorded. Every comparison is exact.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import engine as ref_engine
from repro.core import packet as ref_packet
from repro.core import profiling as ref_profiling
from repro.core import sched_ir as ref_ir
from repro.core import simulator as ref_sim
from repro.core import topology as ref_topo
from repro_torch.core import engine, packet, profiling, sched_ir, sched_search, simulator, \
    topology
from repro_torch.kernels import pool
from test_torch_allreduce import assert_same


@pytest.fixture
def profiler():
    profiling.disable()
    profiling.reset()
    yield profiling
    profiling.disable()
    profiling.reset()


def test_surface_matches_reference(profiler):
    assert profiling.PHASES == ref_profiling.PHASES
    assert not profiling.ENABLED
    for mod in (profiling, ref_profiling):
        mod.reset()
        mod.record("rng", 0.25)
        mod.record("rng", 0.5)
        mod.record("packing", 1.0 / 3.0)
        with mod.phase("pool_solve"):          # disabled: a no-op
            pass
    assert profiling.report() == ref_profiling.report() == {
        "packing": {"wall_s": 0.3333, "calls": 1}, "rng": {"wall_s": 0.75, "calls": 2}}
    ref_profiling.reset()
    profiling.enable()
    with profiling.phase("engine_solve"):
        pass
    assert profiling.report()["engine_solve"]["calls"] == 1
    profiling.reset()
    assert profiling.report() == {}


def _counting(monkeypatch):
    """Count the pool passes: the row passes (``pool.pool_completion_rows``)
    and the 1-D host scans (``engine._pool_1d``)."""
    calls = {"rows": 0, "1d": 0}
    rows, one = pool.pool_completion_rows, engine._pool_1d

    def count_rows(*a, **kw):
        calls["rows"] += 1
        return rows(*a, **kw)

    def count_1d(*a, **kw):
        calls["1d"] += 1
        return one(*a, **kw)

    monkeypatch.setattr(pool, "pool_completion_rows", count_rows)
    monkeypatch.setattr(engine, "_pool_1d", count_1d)
    return calls


# name: (port call, reference call) of one seed's run; each returns a result
CASES = {
    "packet_broadcast": (
        lambda rng: packet.simulate_packet_broadcast(
            16, 1 << 18, engine.FabricParams(), engine.WorkerParams(n_recv_workers=4), rng,
            loss=0.02, device="cpu"),
        lambda rng: ref_packet.simulate_packet_broadcast(
            16, 1 << 18, ref_engine.FabricParams(), ref_engine.WorkerParams(n_recv_workers=4),
            rng, loss=0.02)),
    "packet_allgather": (
        lambda rng: packet.simulate_packet_allgather(
            12, 1 << 16, engine.FabricParams(), engine.WorkerParams(), rng, 4, loss=0.01,
            device="cpu"),
        lambda rng: ref_packet.simulate_packet_allgather(
            12, 1 << 16, ref_engine.FabricParams(), ref_engine.WorkerParams(), rng, 4,
            loss=0.01)),
    "routed_allgather": (
        lambda rng: simulator.simulate_allgather(
            16, 1 << 16, engine.FabricParams(), engine.WorkerParams(n_recv_workers=8), rng, 4,
            topology=topology.FatTree(k=8, n_hosts=16), fidelity="packet", loss=0.005,
            device="cpu"),
        lambda rng: ref_sim.simulate_allgather(
            16, 1 << 16, ref_engine.FabricParams(), ref_engine.WorkerParams(n_recv_workers=8),
            rng, 4, topology=ref_topo.FatTree(k=8, n_hosts=16), fidelity="packet",
            loss=0.005)),
    "fluid_broadcast": (
        lambda rng: simulator.simulate_broadcast(
            32, 1 << 20, engine.FabricParams(p_drop=1e-3), engine.WorkerParams(), rng,
            topology=topology.FatTree(k=8, n_hosts=32), device="cpu"),
        lambda rng: ref_sim.simulate_broadcast(
            32, 1 << 20, ref_engine.FabricParams(p_drop=1e-3), ref_engine.WorkerParams(), rng,
            topology=ref_topo.FatTree(k=8, n_hosts=32))),
    "fluid_allgather": (
        lambda rng: simulator.simulate_allgather(
            64, 1 << 16, engine.FabricParams(), engine.WorkerParams(n_recv_workers=16), rng,
            n_chains=64, topology=topology.FatTree(k=8, n_hosts=64), device="cpu"),
        lambda rng: ref_sim.simulate_allgather(
            64, 1 << 16, ref_engine.FabricParams(), ref_engine.WorkerParams(n_recv_workers=16),
            rng, n_chains=64, topology=ref_topo.FatTree(k=8, n_hosts=64))),
    "hier_packet": (
        lambda rng: sched_ir.execute(
            sched_ir.build_hierarchical_allgather(32, 1 << 18, 4, 2), engine.FabricParams(),
            engine.WorkerParams(n_recv_workers=8), rng, fidelity="packet",
            topology=topology.IslandFatTree(8, 32, island_size=4), loss=0.01, device="cpu"),
        lambda rng: ref_ir.execute(
            ref_ir.build_hierarchical_allgather(32, 1 << 18, 4, 2), ref_engine.FabricParams(),
            ref_engine.WorkerParams(n_recv_workers=8), rng, fidelity="packet",
            topology=ref_topo.IslandFatTree(8, 32, island_size=4), loss=0.01)),
    "allreduce_packet": (
        lambda rng: sched_ir.execute(
            sched_ir.build_pipelined_allreduce(8, 1 << 20, 8, n_segments=2),
            engine.FabricParams(), engine.WorkerParams(n_recv_workers=8), rng,
            fidelity="packet", loss=0.01, device="cpu"),
        lambda rng: ref_ir.execute(
            ref_ir.build_pipelined_allreduce(8, 1 << 20, 8, n_segments=2),
            ref_engine.FabricParams(), ref_engine.WorkerParams(n_recv_workers=8), rng,
            fidelity="packet", loss=0.01)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_profiled_runs_bitwise_unprofiled_and_counted(name, profiler, monkeypatch):
    port, ref = CASES[name]
    rng_off, rng_on, rng_ref = (np.random.default_rng(4) for _ in range(3))
    off = port(rng_off)
    assert profiling.report() == {}                      # disabled: nothing recorded
    calls = _counting(monkeypatch)
    solves0 = engine.counts["solves"]
    profiling.enable()
    on = port(rng_on)
    profiling.disable()
    rep = profiling.report()
    assert_same(on, off, name)
    assert_same(on, ref(rng_ref), name)
    assert rng_on.random() == rng_off.random() == rng_ref.random()
    assert set(rep) <= set(profiling.PHASES)
    assert rep.get("engine_solve", {}).get("calls", 0) == engine.counts["solves"] - solves0
    assert rep.get("pool_solve", {}).get("calls", 0) == calls["rows"] + calls["1d"] > 0
    assert rep["engine_solve"]["calls"] > 0
    assert all(v["wall_s"] >= 0.0 for v in rep.values())
    assert rep["rng"]["calls"] > 0                       # every case draws jitter or loss
    recovers = name in ("packet_broadcast", "packet_allgather", "routed_allgather",
                        "hier_packet", "allreduce_packet")
    if recovers:
        assert rep["packing"]["calls"] > 0 and calls["1d"] + calls["rows"] > 0


def test_profiled_search_bitwise_unprofiled(profiler):
    """A hierarchical search with packet validation under loss: the same
    SearchResult (the wall clock aside) with the profiler on and off."""
    def run():
        return sched_search.search("allgather", 16, 1 << 18,
                                   topology=topology.IslandFatTree(4, 16, island_size=4),
                                   hosts=list(range(16)), loss=0.01, device="cpu")

    off = run()
    profiling.enable()
    on = run()
    profiling.disable()
    assert_same(on, off, skip=("wall_s",))
    assert {"engine_solve", "pool_solve", "rng", "packing"} <= set(profiling.report())


def test_disabled_records_nothing(profiler):
    res = CASES["packet_allgather"][0](np.random.default_rng(1))
    assert res.completed and profiling.report() == {}
    assert dataclasses.is_dataclass(res)
