"""The port's packet-level M-chain Allgather and its schedule IR against the
JAX package's, on the CPU: the same arguments and the same numpy generator
seed go into both ``simulate_packet_allgather``s, and every field that the
reference's ``assert_ag_equal`` compares (tests/test_packet_vectorized.py)
must be equal exactly, every RoundTrace included, with the generators left
in one state. The schedule builders, ``rounds()``, ``canonical_key`` and
``validate`` are held against ``repro.core.schedule`` and
``repro.core.sched_ir`` for P = 1..33 and every M <= P.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import dpa as ref_dpa
from repro.core import dpa_engine as ref_de
from repro.core import engine as ref_engine
from repro.core import packet as ref_packet
from repro.core import protocol as ref_protocol
from repro.core import sched_ir as ref_ir
from repro.core import schedule as ref_seq
from repro.core import simulator as ref_sim
from repro_torch.core import dpa, dpa_engine, engine, packet, protocol, sched_ir, schedule, \
    simulator
from repro_torch.kernels import bitmap, pool

FAB = dict(jitter=0.0)
FABJ = dict()                             # default jitter 1e-6
WK = dict(n_recv_workers=8)               # pool rate > wire rate: no RNR
WK1 = dict()                              # 1 worker
WKS = dict(staging_chunks=16)             # a short staging ring: RNR drops
GE = ("ge", 0.01, 8.0)                    # GilbertElliottLoss.from_rate(0.01, mean_burst=8)


def _loss(spec, mod):
    return mod.GilbertElliottLoss.from_rate(spec[1], mean_burst=spec[2]) \
        if isinstance(spec, tuple) else spec


def run_both(p, n, m, fab, wk, seed, loss=None, *, dpa_ref=None, **kw):
    """(port, reference) results, and both generators afterwards; ``dpa=``
    goes to the port, ``dpa_ref=`` to the reference."""
    rng_t, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    got = packet.simulate_packet_allgather(
        p, n, engine.FabricParams(**fab), engine.WorkerParams(**wk), rng_t, m,
        loss=_loss(loss, packet), device="cpu", **kw)
    kw["dpa"] = dpa_ref
    want = ref_packet.simulate_packet_allgather(
        p, n, ref_engine.FabricParams(**fab), ref_engine.WorkerParams(**wk), rng_r, m,
        loss=_loss(loss, ref_packet), **kw)
    return got, want, rng_t, rng_r


def assert_ag_equal(a, b, ctx=""):
    """Every observable of PacketAllgatherResult, exactly (the reference's
    ``assert_ag_equal``, across the two packages' dataclasses)."""
    assert (a.time, a.completed) == (b.time, b.completed), ctx
    assert dataclasses.astuple(a.phases) == dataclasses.astuple(b.phases), ctx
    for name in ("recovered", "rnr_drops", "retransmit_wire_bytes", "bytes_fast",
                 "bytes_recovery", "bytes_total", "per_rank_recv_tput", "link_bytes"):
        assert getattr(a, name) == getattr(b, name), (ctx, name)
    assert [dataclasses.astuple(t) for t in a.rounds] == \
        [dataclasses.astuple(t) for t in b.rounds], ctx


def _launches() -> tuple:
    return pool.launches, bitmap.pack_launches, bitmap.or_launches, bitmap.popcount_launches


# the abstract-fabric rows of the JAX package's AG_GRID
# (tests/test_packet_vectorized.py: routed=False), then uneven chains, M = 1,
# M = P, staging-ring drops with and without jitter, heavy and bursty loss
AG_GRID = [
    # (p, n_bytes, m, fab, wk, loss, seed)
    (4, 1 << 16, 1, FAB, WK, None, 0),
    (8, 1 << 17, 2, FABJ, WK, None, 1),
    (16, 1 << 17, 2, FAB, WK, 0.01, 0),
    (16, 1 << 17, 4, FABJ, WK1, 0.01, 2),
    (16, 1 << 17, 2, FABJ, WK, GE, 0),
    (16, 1 << 16, 4, FAB, WK1, None, 3),
    (10, 1 << 16, 4, FABJ, WK1, 0.02, 5),     # uneven chains: 3, 3, 2, 2
    (10, 1 << 17, 4, FAB, WKS, 0.02, 3),      # uneven, RNR at jitter 0
    (5, 1 << 15, 1, FABJ, WK, 0.05, 8),       # M = 1
    (6, 1 << 15, 6, FABJ, WK1, 0.05, 7),      # M = P: one generation
    (16, 1 << 18, 4, FAB, WKS, None, 0),      # lossless RNR: exact ties between chains
    (16, 1 << 18, 4, FABJ, WKS, 0.01, 1),     # RNR + loss + jitter
    (16, 1 << 18, 16, FABJ, WKS, GE, 4),      # M = P, bursty, RNR
    (33, 1 << 16, 5, FABJ, WKS, 0.2, 5),      # heavy loss, many rounds
    (3, 100, 2, FABJ, WK, 0.1, 2),            # one short chunk
    (1, 1 << 12, 1, FABJ, WK, 0.1, 1),        # one rank: nothing to send
]


@pytest.mark.parametrize("p,n,m,fab,wk,loss,seed", AG_GRID)
def test_allgather_matches_reference(p, n, m, fab, wk, loss, seed):
    before = _launches()
    got, want, rng_t, rng_r = run_both(p, n, m, fab, wk, seed, loss)
    assert _launches() == before          # CPU tensors take the plain versions
    assert_ag_equal(got, want, ctx=f"p={p} m={m} loss={loss}")
    assert rng_t.random() == rng_r.random()     # the generators end in one state


def _dpa(spec, pair):
    """``dpa=`` in one package: None, a DpaConfig or an EventDpaParams."""
    dpa_mod, de_mod = pair
    if spec is None:
        return None
    if spec[0] == "config":
        return dpa_mod.DpaConfig(*spec[1:])
    if spec[0] == "host":
        return de_mod.EventDpaParams.host_cpu(spec[1])
    return de_mod.EventDpaParams.from_table1(*spec[1:])


# the event-level DPA (dpa_fidelity="event"): a persistent pool a host, the
# chain roots' NACK service and retransmit posting on the pools that receive
# the other chains; n_chains 1, 3 and P, i.i.d. and bursty loss, jitter 0
# and 1 us, aggregation on and off, the staging ring overflowing
EVENT_AG_GRID = [
    # (p, n_bytes, m, fab, wk, loss, seed, dpa, aggregate_nacks)
    (16, 1 << 18, 4, FABJ, dict(n_recv_workers=16), 1e-3, 0, None, True),
    (12, 1 << 16, 3, FAB, WK, 0.05, 1, ("config", "UD", 16), True),
    (9, 1 << 16, 1, FABJ, WK1, 0.05, 2, ("params", "UC", 4), False),
    (8, 1 << 16, 8, FABJ, WK, GE, 3, ("params", "UD", 8), True),          # M = P
    (10, 1 << 17, 4, FAB, WKS, 0.02, 4, ("host", 2), True),               # RNR, jitter 0
    (16, 1 << 17, 16, FABJ, WKS, 0.01, 5, ("params", "UD", 2), False),    # M = P, RNR
    (16, 1 << 17, 3, FAB, WK, None, 6, ("config", "UC", 8), True),        # lossless
]


@pytest.mark.parametrize("p,n,m,fab,wk,loss,seed,spec,agg", EVENT_AG_GRID)
def test_event_dpa_allgather_matches_reference(p, n, m, fab, wk, loss, seed, spec, agg):
    before = _launches()
    got, want, rng_t, rng_r = run_both(p, n, m, fab, wk, seed, loss, aggregate_nacks=agg,
                                       dpa_fidelity="event", dpa=_dpa(spec, (dpa, dpa_engine)),
                                       dpa_ref=_dpa(spec, (ref_dpa, ref_de)))
    assert _launches() == before
    assert_ag_equal(got, want, ctx=f"event p={p} m={m} loss={loss} dpa={spec}")
    assert rng_t.random() == rng_r.random()
    assert got.completed
    if wk is WKS:
        assert got.rnr_drops > 0
    if loss is not None:
        assert got.recovered > 0


def test_grid_exercises_recovery_and_the_staging_ring():
    """The grid is not vacuous: recovery rounds and staging-ring drops
    happen, at jitter 0 too, and a truncated run is seen below."""
    heavy, _, _, _ = run_both(33, 1 << 16, 5, FABJ, WKS, 5, 0.2)
    ties, _, _, _ = run_both(16, 1 << 18, 4, FAB, WKS, 0)
    assert len(heavy.rounds) > 2 * 7 and heavy.rnr_drops > 0 and heavy.completed
    assert ties.rnr_drops > 0 and ties.recovered > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_unaggregated_nacks_match(seed):
    got, want, rng_t, rng_r = run_both(16, 1 << 17, 4, FABJ, WK1, seed, 0.02,
                                       aggregate_nacks=False)
    assert any(r.root_nack_msgs > 1 for r in got.rounds)
    assert_ag_equal(got, want, ctx=f"noagg seed={seed}")
    assert rng_t.random() == rng_r.random()


@pytest.mark.parametrize("wk,loss", [(WKS, None), (WK1, 0.3)])
def test_truncated_by_max_rounds_matches(wk, loss):
    """Heavy loss (or a short staging ring) cut off by max_rounds=2:
    completed=False with the same counts, the shortfall in bytes_fast."""
    got, want, rng_t, rng_r = run_both(16, 1 << 18, 4, FABJ, wk, 9, loss, max_rounds=2)
    assert not got.completed
    assert got.bytes_fast + got.bytes_recovery < got.bytes_total
    assert_ag_equal(got, want, ctx="max_rounds=2")
    assert rng_t.random() == rng_r.random()


def test_allgather_time_and_simulate_allgather_match():
    for kw in (dict(), dict(n_chains=4, loss=0.01, seed=3),
               dict(n_chains=2, workers=engine.WorkerParams(**WKS), seed=1)):
        ref_kw = dict(kw)
        if "workers" in kw:
            ref_kw["workers"] = ref_engine.WorkerParams(**WKS)
        assert protocol.allgather_time(16, 1 << 17, device="cpu", **kw) == \
            ref_protocol.allgather_time(16, 1 << 17, **ref_kw)
    args = (12, 1 << 16)
    got = simulator.simulate_allgather(*args, engine.FabricParams(), engine.WorkerParams(),
                                       np.random.default_rng(4), 3, fidelity="packet",
                                       loss=0.05, device="cpu")
    want = ref_sim.simulate_allgather(*args, ref_engine.FabricParams(),
                                      ref_engine.WorkerParams(), np.random.default_rng(4), 3,
                                      fidelity="packet", loss=0.05)
    assert_ag_equal(got, want)
    got = simulator.simulate_broadcast(*args, engine.FabricParams(), engine.WorkerParams(),
                                       np.random.default_rng(4), 2, fidelity="packet",
                                       loss=0.05, device="cpu")
    want = ref_sim.simulate_broadcast(*args, ref_engine.FabricParams(),
                                      ref_engine.WorkerParams(), np.random.default_rng(4), 2,
                                      fidelity="packet", loss=0.05)
    np.testing.assert_array_equal(got.completion, want.completion)
    assert [dataclasses.astuple(t) for t in got.rounds] == \
        [dataclasses.astuple(t) for t in want.rounds]
    sched = sched_ir.build_allgather(10, 1 << 15, 4)
    got = sched_ir.execute(sched, fidelity="packet", loss=0.05, device="cpu")
    want = ref_ir.execute(ref_ir.build_allgather(10, 1 << 15, 4), fidelity="packet",
                          loss=0.05)
    assert_ag_equal(got, want)


# ------------------------------------------------------- the schedule graph


def _ops(sched) -> list[tuple]:
    return [(type(op).__name__, *dataclasses.astuple(op)) for op in sched.ops]


def test_builders_match_reference_for_every_p_and_m():
    """P = 1..33, every M <= P: the sequencer's arithmetic, the allgather's
    ops, activation edges, generations and content key equal the
    reference's, and both packages' validators accept it."""
    for p in range(1, 34):
        for m in range(1, p + 1):
            assert schedule.allgather_schedule(p, m) == [
                schedule.BroadcastStep(s.index, s.roots)
                for s in ref_seq.allgather_schedule(p, m)]
            assert schedule.activation_edges(p, m) == ref_seq.activation_edges(p, m)
            assert schedule.chain_lengths(p, m) == ref_seq.chain_lengths(p, m)
            assert [schedule.chain_of(r, p, m) for r in range(p)] == \
                [ref_seq.chain_of(r, p, m) for r in range(p)]
            schedule.validate_schedule(p, m)
            got, want = sched_ir.build_allgather(p, 4096, m), ref_ir.build_allgather(p, 4096, m)
            assert _ops(got) == _ops(want) and got.activation == want.activation
            assert got.meta == want.meta and got.rounds() == want.rounds()
            assert got.n_rounds == want.n_rounds == schedule.n_rounds(p, m)
            assert sched_ir.canonical_key(got) == ref_ir.canonical_key(want)
            assert sched_ir.payload_bytes(got) == ref_ir.payload_bytes(want)
            sched_ir.validate(got)
            ref_ir.validate(want)
        for root in {0, p - 1}:
            got, want = sched_ir.build_broadcast_tree(p, 77, root), \
                ref_ir.build_broadcast_tree(p, 77, root)
            assert _ops(got) == _ops(want)
            assert sched_ir.canonical_key(got) == ref_ir.canonical_key(want)


def test_sequencer_helpers_match_reference():
    for p in range(1, 20):
        for m in range(1, p + 1):
            for c in range(m):
                assert schedule.chain_members(c, p, m) == ref_seq.chain_members(c, p, m)
        for g in range(1, 6):
            assert schedule.subgroup_assignment(g, p) == ref_seq.subgroup_assignment(g, p)
            assert schedule.worker_split(g, p) == ref_seq.worker_split(g, p)
    for p, m in ((4, 0), (4, 5), (0, 1)):
        with pytest.raises(ValueError):
            ref_seq.n_rounds(p, m)
        with pytest.raises(ValueError):
            schedule.n_rounds(p, m)
    with pytest.raises(ValueError):
        schedule.active_group(3, 9, 3)


def _both(build):
    """The same hand-built schedule in both packages."""
    return build(sched_ir), build(ref_ir)


@pytest.mark.parametrize("build", [
    # a generation with no activation predecessor
    lambda ir: ir.Schedule("allgather", 2, 8, (ir.Multicast(0, (0, 1), 8),
                                               ir.Multicast(1, (0, 1), 8)), ((0, 1), (1, 0)),
                           meta={"n_chains": 1}),
    # a rank that never broadcasts
    lambda ir: ir.Schedule("allgather", 3, 8, (ir.Multicast(0, (0, 1, 2), 8),
                                               ir.Multicast(0, (0, 1, 2), 8)), ((0, 1),),
                           meta={"n_chains": 1}),
    # roots out of the Appendix-A order
    lambda ir: ir.Schedule("allgather", 2, 8, (ir.Multicast(1, (0, 1), 8),
                                               ir.Multicast(0, (0, 1), 8)), ((0, 1),),
                           meta={"n_chains": 1}),
    # a rank outside 0..P-1, a negative size, an unknown kind or transport
    lambda ir: ir.Schedule("broadcast", 2, 8, (ir.Multicast(0, (0, 2), 8),)),
    lambda ir: ir.Schedule("broadcast", 2, 8, (ir.Multicast(0, (0, 1), -1),)),
    lambda ir: ir.Schedule("gossip", 2, 8, (ir.Multicast(0, (0, 1), 8),)),
    lambda ir: ir.Schedule("broadcast", 2, 8, (ir.Multicast(0, (0, 1), 8, "island"),)),
    # a self edge
    lambda ir: ir.Schedule("broadcast", 2, 8, (ir.Multicast(0, (0, 1), 8),), ((0, 0),)),
])
def test_validate_raises_where_the_reference_does(build):
    got, want = _both(build)
    with pytest.raises(AssertionError):
        ref_ir.validate(want)
    with pytest.raises(ValueError, match="invariant"):
        sched_ir.validate(got)


def test_rounds_refuses_a_cycle_and_ring_ops_hash_like_the_reference():
    got, want = _both(lambda ir: ir.Schedule(
        "ring_allgather", 3, 8, (ir.Unicast(0, 1, 8), ir.Reduce(2, (0, 1), 8),
                                 ir.Unicast(1, 2, 8, "switched")), ((0, 1), (1, 2))))
    assert sched_ir.canonical_key(got) == ref_ir.canonical_key(want)
    assert got.rounds() == want.rounds() == [[0], [1], [2]]
    assert sched_ir.payload_bytes(got) == ref_ir.payload_bytes(want) == 24
    cyc = sched_ir.Schedule("allgather", 2, 8, got.ops[:2], ((0, 1), (1, 0)))
    with pytest.raises(ValueError, match="DAG"):
        cyc.rounds()


# ------------------------------------------------------------ the engine


def test_staggered_flows_share_one_link_like_the_reference():
    """Every chain's fast flow and every retransmission shares the link
    ``leaf.recv``: several flows that start and end at different times,
    some at the same instant, get the reference's max-min shares; their
    chunk times and ends are equal exactly."""
    starts = [0.0, 0.0, 1e-6, 2.5e-6, 2.5e-6, 7e-6, 40e-6]
    sizes = [1 << 20, 3 << 18, 4096, 5 << 16, 1 << 16, 123456, 8192]
    out = []
    for mod in (engine, ref_engine):
        eng = mod.Engine()
        link = eng.add_link("leaf.recv", 25e9)
        flows = [eng.submit(link, b, t_start=t) for t, b in zip(starts, sizes)]
        end = eng.run()
        out.append((end, [f.t_end for f in flows],
                    [f.chunk_times(-(-b // 4096), 4096) for f, b in zip(flows, sizes)]))
    (end_t, ends_t, chunks_t), (end_r, ends_r, chunks_r) = out
    assert end_t == end_r and ends_t == ends_r
    for x, y in zip(chunks_t, chunks_r):
        np.testing.assert_array_equal(x, y)


def test_unported_options_raise():
    """engine="reference" is not ported; the event DPA is, with the
    reference's guards on ``dpa=``."""
    args = (8, 1 << 16, engine.FabricParams(), engine.WorkerParams(), np.random.default_rng(0),
            2)
    with pytest.raises(NotImplementedError, match="Not queued"):
        packet.simulate_packet_allgather(*args, device="cpu", engine="reference")
    with pytest.raises(ValueError, match="dpa_fidelity"):
        packet.simulate_packet_allgather(*args, device="cpu", dpa=dpa.DpaConfig())
    with pytest.raises(TypeError):
        packet.simulate_packet_allgather(*args, device="cpu", dpa_fidelity="event",
                                         dpa=object())
    with pytest.raises(ValueError, match="engine"):
        packet.simulate_packet_allgather(*args, device="cpu", engine="fast")
    # topology= and hosts= are ported (the routed packet mode): equal to the
    # reference's; without a topology the hosts only name the ranks
    from repro.core import topology as ref_topo
    from repro_torch.core import topology

    for kw, ref_kw in ((dict(topology=topology.FatTree(k=4)),
                        dict(topology=ref_topo.FatTree(k=4))),
                       (dict(hosts=list(range(8, 0, -1))), dict(hosts=list(range(8, 0, -1))))):
        got = packet.simulate_packet_allgather(
            8, 1 << 16, engine.FabricParams(), engine.WorkerParams(), np.random.default_rng(0),
            2, loss=0.02, device="cpu", **kw)
        want = ref_packet.simulate_packet_allgather(
            8, 1 << 16, ref_engine.FabricParams(), ref_engine.WorkerParams(),
            np.random.default_rng(0), 2, loss=0.02, **ref_kw)
        assert_ag_equal(got, want, ctx=f"{sorted(kw)}")
    # the fluid fidelity is ported: equal to the reference's
    got = simulator.simulate_allgather(*args, device="cpu")          # fidelity="fluid"
    want = ref_sim.simulate_allgather(8, 1 << 16, ref_engine.FabricParams(),
                                      ref_engine.WorkerParams(), np.random.default_rng(0), 2)
    assert (got.time, dataclasses.astuple(got.phases)) == \
        (want.time, dataclasses.astuple(want.phases))
    assert protocol.allgather_time(8, 1 << 16, fidelity="fluid", device="cpu") == \
        ref_protocol.allgather_time(8, 1 << 16, fidelity="fluid")
    with pytest.raises(TypeError):
        protocol.allgather_time(8, 1 << 16, dpa=object(), device="cpu")
    assert protocol.allgather_time(8, 1 << 16, n_chains=2, dpa=dpa.DpaConfig("UC", 2),
                                   loss=0.05, device="cpu") == \
        ref_protocol.allgather_time(8, 1 << 16, n_chains=2, dpa=ref_dpa.DpaConfig("UC", 2),
                                    loss=0.05)
    # the ring kinds at packet fidelity are ported: equal to the reference's
    ring = sched_ir.Schedule("ring_allgather", 2, 8, (sched_ir.Unicast(0, 1, 8),))
    ref_ring = ref_ir.Schedule("ring_allgather", 2, 8, (ref_ir.Unicast(0, 1, 8),))
    got = sched_ir.execute(ring, fidelity="packet", loss=0.01, device="cpu")
    want = ref_ir.execute(ref_ring, fidelity="packet", loss=0.01)
    assert (got.time, got.bytes_recovery, got.n_rounds) == \
        (want.time, want.bytes_recovery, want.n_rounds)
    with pytest.raises(ValueError, match="fidelity"):
        simulator.simulate_allgather(*args, fidelity="analytic", device="cpu")
