"""The port's routed packet mode against the JAX package's, on the CPU: the
packet Broadcast and the packet Allgather on ``FatTree`` and ``Torus2D``
fabrics (per-link loss on the multicast trees, the retransmissions down the
trees pruned to the nackers), the ring schedules at packet fidelity (RC
goodput inflation), and the loss plumbing (``tree_paths``,
``_stacked_lost``, ``_link_models``, ``recovery_overlay``). The same
arguments, topologies and numpy generator seeds go into both packages, and
every field must be equal exactly, the round traces, ``link_bytes`` and the
generators' next draws included.
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
from repro.core import simulator as ref_sim
from repro.core import topology as ref_topo
from repro_torch.core import dpa, dpa_engine, engine, packet, protocol, sched_ir, simulator, \
    topology

WK = dict(n_recv_workers=8)
GE = ("ge", 0.01, 8.0)                    # GilbertElliottLoss.from_rate(0.01, mean_burst=8)


def _loss(spec, mod):
    return mod.GilbertElliottLoss.from_rate(spec[1], mean_burst=spec[2]) \
        if isinstance(spec, tuple) else spec


def _fabrics(kind, *args, **kw):
    """The same fabric built by both packages: (port, reference)."""
    return getattr(topology, kind)(*args, **kw), getattr(ref_topo, kind)(*args, **kw)


def assert_same(a, b, ctx=""):
    """Every field of two results (the packages' dataclasses), exactly."""
    assert type(a).__name__ == type(b).__name__, ctx
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, f.name)
        elif f.name == "rounds":
            assert [dataclasses.astuple(t) for t in x] == \
                [dataclasses.astuple(t) for t in y], ctx
        elif dataclasses.is_dataclass(y):
            assert dataclasses.astuple(x) == dataclasses.astuple(y), (ctx, f.name)
        elif isinstance(y, dict) and y and isinstance(next(iter(y.values())), np.ndarray):
            assert sorted(x) == sorted(y), (ctx, f.name)
            for k in y:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{ctx} {f.name} {k}")
        elif isinstance(y, dict):
            assert list(x.items()) == list(y.items()), (ctx, f.name)
        else:
            assert x == y, (ctx, f.name, x, y)


def bcast_both(p, n, fab, seed, topos, loss=None, **kw):
    """(port, reference) packet Broadcasts on the given fabrics, and both
    generators afterwards."""
    rng_t, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    got = packet.simulate_packet_broadcast(
        p, n, engine.FabricParams(**fab), engine.WorkerParams(**WK), rng_t,
        topology=topos[0], loss=_loss(loss, packet), device="cpu", **kw)
    want = ref_packet.simulate_packet_broadcast(
        p, n, ref_engine.FabricParams(**fab), ref_engine.WorkerParams(**WK), rng_r,
        topology=topos[1], loss=_loss(loss, ref_packet), **kw)
    return got, want, rng_t, rng_r


# --------------------------------------------------------- routed Broadcast

BCAST_GRID = [
    # (p, fabric params, loss, seed)
    (16, dict(jitter=0.0), None, 0),
    (32, dict(), None, 1),
    (16, dict(jitter=0.0), 0.02, 2),
    (32, dict(), 0.02, 3),
    (32, dict(jitter=0.0), GE, 4),
]


@pytest.mark.parametrize("p,fab,loss,seed", BCAST_GRID)
def test_routed_broadcast_matches_reference(p, fab, loss, seed):
    topos = _fabrics("FatTree", 8, n_hosts=p, b_host=25e9)
    got, want, rng_t, rng_r = bcast_both(p, 1 << 18, fab, seed, topos, loss,
                                         collect_delivery=True)
    assert_same(got, want, ctx=f"p={p} loss={loss}")
    assert got.link_bytes and got.completed
    assert rng_t.random() == rng_r.random()


@pytest.mark.parametrize("p", [16, 32])
def test_routed_lossless_broadcast_equals_the_routed_fluid_run(p):
    """At loss 0 the packet run is the routed fluid run (reference
    tests/test_packet.py:104): the same time and the same port counters."""
    fab = engine.FabricParams(jitter=0.0)
    topo = topology.FatTree(k=8, n_hosts=p, b_host=fab.b_link)
    a = simulator.simulate_broadcast(p, 1 << 20, fab, engine.WorkerParams(**WK),
                                     np.random.default_rng(0), topology=topo, device="cpu")
    b = simulator.simulate_broadcast(p, 1 << 20, fab, engine.WorkerParams(**WK),
                                     np.random.default_rng(0), topology=topo,
                                     fidelity="packet", device="cpu")
    assert b.time == pytest.approx(a.time, rel=1e-9)
    assert a.link_bytes == pytest.approx(b.link_bytes)
    assert b.recovered == 0 and b.completed


@pytest.mark.parametrize("aggregate", [True, False])
@pytest.mark.parametrize("p", [16, 32])
def test_routed_nack_aggregation_matches_reference(p, aggregate):
    topos = _fabrics("FatTree", 8, n_hosts=p, b_host=25e9)
    got, want, rng_t, rng_r = bcast_both(p, 1 << 18, dict(), 5, topos, 0.02,
                                         aggregate_nacks=aggregate)
    assert_same(got, want, ctx=f"aggregate={aggregate}")
    assert got.rounds
    if aggregate:
        assert all(tr.root_nack_msgs == 1 for tr in got.rounds)
    else:
        assert got.rounds[0].root_nack_msgs == got.rounds[0].nack_leaves > 1
    assert rng_t.random() == rng_r.random()


def test_routed_broadcast_on_placed_hosts_and_root_matches():
    """Ranks on hosts that are not 0..P-1 (host names sort as strings:
    "h10" before "h2"), a root other than 0."""
    hosts = [3, 17, 2, 30, 10, 21, 5, 12, 40, 1, 28, 9]
    topos = _fabrics("FatTree", 8, n_hosts=48, b_host=25e9)
    for root in (0, 7):
        got, want, _, _ = bcast_both(len(hosts), 1 << 18, dict(), 6, topos, 0.03,
                                     hosts=hosts, root=root, collect_delivery=True)
        assert_same(got, want, ctx=f"placed root={root}")


def test_attached_bursty_loss_carries_over_between_calls():
    """Gilbert-Elliott models armed on the links by ``attach_loss`` keep
    their burst state across two Broadcasts on one fabric."""
    topos = _fabrics("FatTree", 8, n_hosts=32, b_host=25e9)
    armed = [packet.attach_loss(topos[0], packet.GilbertElliottLoss.from_rate(0.02, 8.0),
                                np.random.default_rng(11)),
             ref_packet.attach_loss(topos[1], ref_packet.GilbertElliottLoss.from_rate(0.02, 8.0),
                                    np.random.default_rng(11))]
    assert armed[0] == armed[1] == len(topos[0].links())
    states = []
    for call in range(2):
        got, want, rng_t, rng_r = bcast_both(32, 1 << 18, dict(jitter=0.0), call, topos)
        assert_same(got, want, ctx=f"call {call}")
        assert got.recovered and rng_t.random() == rng_r.random()
        states.append([link.loss._bad for link in topos[0].links().values()])
        assert states[-1] == [link.loss._bad for link in topos[1].links().values()]
    assert states[0] != [False] * len(states[0]) or states[1] != states[0]


def test_torus_broadcast_matches_reference():
    topos = _fabrics("Torus2D", 4, 4, b_link=25e9)
    got, want, rng_t, rng_r = bcast_both(16, 1 << 18, dict(), 7, topos, 0.02,
                                         collect_delivery=True)
    assert_same(got, want, ctx="torus")
    assert rng_t.random() == rng_r.random()


# --------------------------------------------------------- routed Allgather

@pytest.mark.parametrize("jitter", [0.0, 1e-6])
@pytest.mark.parametrize("m", [1, 4, 16])
def test_routed_allgather_matches_reference(m, jitter):
    """FatTree(k=8) with 16 hosts: one loss process per physical link shared
    by every chain; at jitter 0 the jitter draws are still consumed, since
    later generations fork link models from the same generator."""
    p = 16
    topos = _fabrics("FatTree", 8, n_hosts=p, b_host=25e9)
    rng_t, rng_r = np.random.default_rng(m), np.random.default_rng(m)
    got = packet.simulate_packet_allgather(
        p, 1 << 16, engine.FabricParams(jitter=jitter), engine.WorkerParams(**WK), rng_t, m,
        topology=topos[0], loss=0.005, device="cpu")
    want = ref_packet.simulate_packet_allgather(
        p, 1 << 16, ref_engine.FabricParams(jitter=jitter), ref_engine.WorkerParams(**WK),
        rng_r, m, topology=topos[1], loss=0.005)
    assert_same(got, want, ctx=f"m={m} jitter={jitter}")
    assert got.recovered and got.completed and got.link_bytes
    assert rng_t.random() == rng_r.random()


def test_routed_allgather_with_attached_loss_and_placed_hosts_matches():
    topos = _fabrics("FatTree", 8, n_hosts=32, b_host=25e9)
    for mod, topo in ((packet, topos[0]), (ref_packet, topos[1])):
        mod.attach_loss(topo, mod.GilbertElliottLoss.from_rate(0.01, 4.0),
                        np.random.default_rng(2), predicate=lambda name: "e" in name)
    hosts = list(range(31, 7, -3))
    rng_t, rng_r = np.random.default_rng(9), np.random.default_rng(9)
    got = simulator.simulate_allgather(
        len(hosts), 1 << 16, engine.FabricParams(), engine.WorkerParams(), rng_t, 3,
        topology=topos[0], hosts=hosts, fidelity="packet", device="cpu")
    want = ref_sim.simulate_allgather(
        len(hosts), 1 << 16, ref_engine.FabricParams(), ref_engine.WorkerParams(), rng_r, 3,
        topology=topos[1], hosts=hosts, fidelity="packet")
    assert_same(got, want, ctx="attached, placed")
    assert rng_t.random() == rng_r.random()


# the event-level DPA on a routed fabric (dpa_fidelity="event")
EVENT_ROUTED = [
    # (kind, p, m, jitter, loss, seed, dpa, aggregate_nacks)
    ("bcast", 32, None, 0.0, 0.02, 0, "config", True),
    ("bcast", 16, None, 1e-6, GE, 1, "params", False),
    ("allgather", 16, 4, 1e-6, 0.005, 2, "config", True),
    ("allgather", 16, 16, 0.0, GE, 3, "params", False),
    ("allgather", 12, 1, 1e-6, 0.01, 4, None, True),
]


@pytest.mark.parametrize("kind,p,m,jitter,loss,seed,spec,agg", EVENT_ROUTED)
def test_routed_event_dpa_matches_reference(kind, p, m, jitter, loss, seed, spec, agg):
    topos = _fabrics("FatTree", 8, n_hosts=p, b_host=25e9)
    mine = {"config": dpa.DpaConfig("UD", 8), "params":
            dpa_engine.EventDpaParams.from_table1("UC", 3), None: None}[spec]
    ref = {"config": ref_dpa.DpaConfig("UD", 8), "params":
           ref_de.EventDpaParams.from_table1("UC", 3), None: None}[spec]
    rng_t, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    kw = dict(aggregate_nacks=agg, dpa_fidelity="event")
    args_t = (p, 1 << 16, engine.FabricParams(jitter=jitter), engine.WorkerParams(**WK), rng_t)
    args_r = (p, 1 << 16, ref_engine.FabricParams(jitter=jitter),
              ref_engine.WorkerParams(**WK), rng_r)
    if kind == "bcast":
        got = packet.simulate_packet_broadcast(*args_t, topology=topos[0], dpa=mine,
                                               loss=_loss(loss, packet), device="cpu",
                                               collect_delivery=True, **kw)
        want = ref_packet.simulate_packet_broadcast(*args_r, topology=topos[1], dpa=ref,
                                                    loss=_loss(loss, ref_packet),
                                                    collect_delivery=True, **kw)
    else:
        got = packet.simulate_packet_allgather(*args_t, m, topology=topos[0], dpa=mine,
                                               loss=_loss(loss, packet), device="cpu", **kw)
        want = ref_packet.simulate_packet_allgather(*args_r, m, topology=topos[1], dpa=ref,
                                                    loss=_loss(loss, ref_packet), **kw)
    assert_same(got, want, ctx=f"event {kind} p={p} m={m} loss={loss}")
    assert got.recovered and got.completed and got.link_bytes
    assert rng_t.random() == rng_r.random()


def test_protocol_facades_match_reference_on_a_topology():
    topos = _fabrics("FatTree", 8, n_hosts=16, b_host=25e9)
    assert protocol.broadcast_time(16, 1 << 18, topology=topos[0], loss=0.01, seed=3,
                                   device="cpu") == \
        ref_protocol.broadcast_time(16, 1 << 18, topology=topos[1], loss=0.01, seed=3)
    assert protocol.allgather_time(16, 1 << 16, n_chains=4, topology=topos[0], loss=0.01,
                                   seed=3, device="cpu") == \
        ref_protocol.allgather_time(16, 1 << 16, n_chains=4, topology=topos[1], loss=0.01,
                                    seed=3)


# ----------------------------------------------------- ring kinds at packet

RING_FABRICS = [None, ("FatTree", (8,), dict(n_hosts=16, b_host=25e9)),
                ("IslandFatTree", (4,), dict(n_hosts=16, island_size=4, b_host=25e9))]


@pytest.mark.parametrize("build", ["build_ring_allgather", "build_ring_reduce_scatter"])
@pytest.mark.parametrize("spec", range(len(RING_FABRICS)))
def test_ring_kinds_at_packet_fidelity_match_reference(build, spec):
    fab = RING_FABRICS[spec]
    topos = (None, None) if fab is None else _fabrics(fab[0], *fab[1], **fab[2])
    for loss in (None, 1e-3, packet.BernoulliLoss(0.02)):
        ref_loss = loss if not isinstance(loss, packet.LossModel) else ref_packet.BernoulliLoss(
            loss.rate)
        got = sched_ir.execute(getattr(sched_ir, build)(16, 1 << 20), fidelity="packet",
                               topology=topos[0], loss=loss, device="cpu")
        want = ref_ir.execute(getattr(ref_ir, build)(16, 1 << 20), fidelity="packet",
                              topology=topos[1], loss=ref_loss)
        assert_same(got, want, ctx=f"{build} {fab} {loss}")
        assert (got.bytes_recovery > 0) == (loss is not None)
    with pytest.raises(ValueError, match="RC transport"):
        sched_ir.execute(getattr(sched_ir, build)(4, 1 << 12), fidelity="packet",
                         max_rounds=2, device="cpu")


# ---------------------------------------------------------- the plumbing

def _tree(p=32, root=5):
    topos = _fabrics("FatTree", 8, n_hosts=p, b_host=25e9)
    out = []
    for topo in topos:
        tree = topo.multicast_tree(root, list(range(p)))
        names = [topo.host(h) for h in range(p) if h != root]
        out.append((topo, tree, names))
    return out


def test_tree_paths_and_link_models_match_reference():
    (t_topo, t_tree, names), (r_topo, r_tree, _) = _tree()
    tp = packet.tree_paths(t_tree, t_topo.host(5), names)
    rp = ref_packet.tree_paths(r_tree, r_topo.host(5), names)
    assert list(tp) == list(rp)
    assert {k: [link.name for link in v] for k, v in tp.items()} == \
        {k: [link.name for link in v] for k, v in rp.items()}
    with pytest.raises(ValueError, match="unreachable"):
        packet.tree_paths(t_tree, t_topo.host(5), ["nowhere"])
    rng_t, rng_r = np.random.default_rng(1), np.random.default_rng(1)
    cache_t, cache_r = {}, {}
    mt = packet._link_models(tp, packet.BernoulliLoss(0.1), rng_t, cache=cache_t)
    mr = ref_packet._link_models(rp, ref_packet.BernoulliLoss(0.1), rng_r, cache=cache_r)
    # the forks go in host-name order ("h10" before "h2"), a link once
    lt = {id(link): link.name for path in tp.values() for link in path}
    lr = {id(link): link.name for path in rp.values() for link in path}
    assert [lt[k] for k in mt] == [lr[k] for k in mr]
    assert [m.sample(64).tolist() for m in mt.values()] == \
        [m.sample(64).tolist() for m in mr.values()]
    again = packet._link_models(tp, packet.BernoulliLoss(0.1), rng_t, cache=cache_t)
    assert all(again[k] is mt[k] for k in mt)            # the cache shares the forks
    assert rng_t.random() == rng_r.random()


def test_stacked_lost_matches_reference_levels():
    (t_topo, t_tree, names), (r_topo, r_tree, _) = _tree()
    tp = packet.tree_paths(t_tree, t_topo.host(5), names)
    rp = ref_packet.tree_paths(r_tree, r_topo.host(5), names)
    mt = packet._link_models(tp, packet.BernoulliLoss(0.05), np.random.default_rng(4))
    mr = ref_packet._link_models(rp, ref_packet.BernoulliLoss(0.05), np.random.default_rng(4))
    for n, leaves in ((300, names), (77, names[3:20:2])):
        masks_t = packet._sample_link_round(packet._models_on_paths(tp, mt, leaves), n)
        masks_r = ref_packet._sample_link_round(ref_packet._models_on_paths(rp, mr, leaves), n)
        got = packet._stacked_lost(tp, masks_t, leaves, n)
        want = ref_packet._stacked_lost(rp, masks_r, leaves, n)
        np.testing.assert_array_equal(got.numpy(), want)
        for k, leaf in enumerate(leaves):
            np.testing.assert_array_equal(packet._leaf_lost(tp[leaf], masks_t, n), want[k])
        assert want.any() and not want.all()


@pytest.mark.parametrize("aggregate", [True, False])
def test_recovery_overlay_matches_reference(aggregate):
    (t_topo, t_tree, names), (r_topo, r_tree, _) = _tree(16, 0)
    tp = packet.tree_paths(t_tree, t_topo.host(0), names)
    rp = ref_packet.tree_paths(r_tree, r_topo.host(0), names)
    rng_t, rng_r = np.random.default_rng(8), np.random.default_rng(8)
    mt = packet._link_models(tp, packet.BernoulliLoss(0.02), rng_t)
    mr = ref_packet._link_models(rp, ref_packet.BernoulliLoss(0.02), rng_r)
    got = packet.recovery_overlay(tp, mt, 1024, 4096, 25e9, engine.FabricParams(),
                                  engine.WorkerParams(n_recv_workers=4), rng_t,
                                  aggregate_nacks=aggregate)
    want = ref_packet.recovery_overlay(rp, mr, 1024, 4096, 25e9, ref_engine.FabricParams(),
                                       ref_engine.WorkerParams(n_recv_workers=4), rng_r,
                                       aggregate_nacks=aggregate)
    assert got == want > 0
    assert packet.rc_goodput_inflation(1e-3, 4.5) == ref_packet.rc_goodput_inflation(1e-3, 4.5)


# ------------------------------------------------------------ still queued

def test_what_is_still_queued_raises():
    args = (8, 1 << 16, engine.FabricParams(), engine.WorkerParams(), np.random.default_rng(0))
    topo = topology.FatTree(k=4)
    # the event DPA is ported; a dpa= without it is refused, as the reference refuses it
    with pytest.raises(ValueError, match="dpa_fidelity"):
        packet.simulate_packet_broadcast(*args, topology=topo, dpa=dpa.DpaConfig(),
                                         device="cpu")
    with pytest.raises(ValueError, match="dpa_fidelity"):
        packet.simulate_packet_allgather(*args, 2, topology=topo, dpa=dpa.DpaConfig(),
                                         device="cpu")
    with pytest.raises(NotImplementedError, match="Not queued"):
        packet.simulate_packet_broadcast(*args, topology=topo, engine="reference",
                                         device="cpu")
    # the composite kinds run routed at packet fidelity, equal to the reference's
    ref_t = ref_topo.FatTree(k=4)
    for build, args in (("build_allreduce", (8, 1 << 16, 4)),
                        ("build_hierarchical_allgather", (8, 1 << 16, 2))):
        got = sched_ir.execute(getattr(sched_ir, build)(*args), fidelity="packet", loss=0.01,
                               topology=topo, device="cpu")
        want = ref_ir.execute(getattr(ref_ir, build)(*args), fidelity="packet", loss=0.01,
                              topology=ref_t)
        assert (got.time, got.link_bytes) == (want.time, want.link_bytes) and got.link_bytes
