"""The port's hierarchical Allgather against the JAX package's, on the CPU:
``build_hierarchical_allgather`` in both stripe modes and both
redistribution transports (ops, activation edges, meta and
``canonical_key`` equal), ``analytic_hier_allgather_time`` (bitwise),
``_stripe_contention_factor`` and ``sched_ir.execute`` of the kind at the
analytic, fluid and packet fidelities on the abstract fabric and on
IslandFatTree, FatTree and Torus2D fabrics, lossless and lossy, every field
of the results equal exactly and the generators left in one state; and
the reference's tests of tests/test_hier_fabric.py from :94 on (its three
``engine=`` tests aside: the per-leaf packet executor is not ported), each
on the port and equal to the reference. Every comparison is exact.
"""
import math

import numpy as np
import pytest

from repro.core import dpa as ref_dpa
from repro.core import engine as ref_engine
from repro.core import protocol as ref_protocol
from repro.core import sched_ir as ref_ir
from repro.core import sched_search as ref_search
from repro_torch.core import dpa, engine, protocol, sched_ir, sched_search, topology
from test_torch_allreduce import assert_run_same, assert_same, fabrics, run_both

FAB = dict(jitter=0.0)
WK = dict(n_recv_workers=8)
P, G, N = 16, 4, 1 << 20


def _island(**kw):
    """IslandFatTree(4, 16, island_size=4) of both packages."""
    return fabrics("IslandFatTree", 4, P, island_size=G, **kw)


def _contended():
    """k = 8 pods: the stripes' trees share agg / core uplinks."""
    return fabrics("IslandFatTree", 8, 32, island_size=4)


def _execute(mod, topo, sched, fidelity, seed=0, **kw):
    fab = (engine if mod is sched_ir else ref_engine).FabricParams(**FAB)
    wk = (engine if mod is sched_ir else ref_engine).WorkerParams(**WK)
    if mod is sched_ir:
        kw["device"] = "cpu"
    return mod.execute(sched, fab, wk, np.random.default_rng(seed), fidelity=fidelity,
                       topology=topo, **kw)


# ------------------------------------------------------------------ builder

BUILD_ARGS = [(8, 1 << 16, 2, 1, "mcast", "island"), (16, N, 4, 2, "mcast", "island"),
              (16, N, 4, 4, "mcast", "switched"), (16, N, 4, 1, "ring", "island"),
              (16, N, 8, 1, "ring", "switched"), (24, 1000, 3, 5, "mcast", "island"),
              (32, N, 4, 3, "mcast", "island")]


@pytest.mark.parametrize("args", BUILD_ARGS)
def test_hier_builder_matches_reference(args):
    p, n, g, m, mode, transport = args
    got = sched_ir.build_hierarchical_allgather(p, n, g, m, stripe_mode=mode,
                                                redistribute_transport=transport)
    want = ref_ir.build_hierarchical_allgather(p, n, g, m, stripe_mode=mode,
                                               redistribute_transport=transport)
    assert_same(got, want, f"hier{args}")
    assert sched_ir.canonical_key(got) == ref_ir.canonical_key(want)
    assert got.rounds() == want.rounds()
    sched_ir.validate(got)


def test_hier_builder_validates_and_pins_transports():
    """tests/test_hier_fabric.py:94, in the port."""
    sched = sched_ir.build_hierarchical_allgather(P, N, G, m=2)
    sched_ir.validate(sched)
    g = sched.meta["island_size"]
    mcasts = [op for op in sched.ops if isinstance(op, sched_ir.Multicast)]
    unis = [op for op in sched.ops if isinstance(op, sched_ir.Unicast)]
    assert mcasts and all(op.transport == "switched" for op in mcasts)
    ring = [op for op in unis if op.transport == "island"]
    assert ring and all(op.src // g == op.dst // g for op in ring)
    assert sched.meta["bundle_bytes"] == (P // G) * N
    alt = sched_ir.build_hierarchical_allgather(P, N, G, m=2, redistribute_transport="switched")
    sched_ir.validate(alt)
    assert sched_ir.canonical_key(alt) != sched_ir.canonical_key(sched)
    assert sched_ir.canonical_key(alt) == ref_ir.canonical_key(
        ref_ir.build_hierarchical_allgather(P, N, G, m=2, redistribute_transport="switched"))


@pytest.mark.parametrize("kw", [dict(island_size=3), dict(island_size=P),
                                dict(island_size=G, stripe_mode="bogus"),
                                dict(island_size=G, redistribute_transport="bogus")])
def test_hier_builder_rejects_degenerate_groupings(kw):
    """tests/test_hier_fabric.py:112: where the reference asserts, the port
    raises ValueError."""
    with pytest.raises(AssertionError):
        ref_ir.build_hierarchical_allgather(P, N, **kw)
    with pytest.raises(ValueError):
        sched_ir.build_hierarchical_allgather(P, N, **kw)


def test_hier_closed_form_bitwise():
    rng = np.random.default_rng(5)
    for _ in range(200):
        g = int(rng.integers(2, 9))
        p = g * int(rng.integers(2, 40))
        n = int(rng.integers(1, 1 << 26))
        b, lat = float(rng.uniform(1e9, 1e11)), float(rng.uniform(1e-7, 1e-5))
        kw = dict(island_size=g, m=[None, 1, int(rng.integers(1, p // g + 1))][rng.integers(3)],
                  stripe_mode=["mcast", "ring"][rng.integers(2)],
                  pool_rate=[None, float(rng.uniform(1e9, 1e11))][rng.integers(2)],
                  rnr_hop=float(rng.uniform(0.0, 3e-6)),
                  b_island=[None, float(rng.uniform(1e9, 1e12))][rng.integers(2)])
        assert protocol.analytic_hier_allgather_time(p, n, b, lat, **kw) == \
            ref_protocol.analytic_hier_allgather_time(p, n, b, lat, **kw)
    with pytest.raises(ValueError):
        protocol.analytic_hier_allgather_time(8, 1, 1e9, 1e-6, island_size=8)


def test_tiered_analytic_bound_monotone_in_island_rate():
    """tests/test_hier_fabric.py:202, in the port."""
    b, lat = engine.FabricParams().b_link, engine.FabricParams().latency
    slow = protocol.analytic_hier_allgather_time(P, N, b, lat, island_size=G, m=1, b_island=b)
    fast = protocol.analytic_hier_allgather_time(P, N, b, lat, island_size=G, m=1,
                                                 b_island=8 * b)
    assert fast < slow


# ------------------------------------------------------------------ execute

FABRIC_SPECS = {"abstract": None,
                "island": ("IslandFatTree", (4, 16), dict(island_size=4)),
                "fattree": ("FatTree", (8,), dict(n_hosts=16, oversubscription=4.0)),
                "torus": ("Torus2D", (4, 4), {})}
# (stripe mode, transport, m)
VARIANTS = [("mcast", "island", 2), ("mcast", "switched", 4), ("ring", "island", 1),
            ("ring", "switched", 1)]
EXEC_CASES = [(fab, var, fid) for fab in FABRIC_SPECS for var in VARIANTS
              for fid in [("fluid", None), ("packet", None), ("packet", 1e-3)]
              + ([("analytic", None)] if fab == "abstract" else [])]


@pytest.mark.parametrize("fab,variant,fid", EXEC_CASES,
                         ids=[f"{f}-{v[0]}-{v[1]}-{d[0]}-{d[1]}" for f, v, d in EXEC_CASES])
def test_hier_execute_matches_reference(fab, variant, fid):
    mode, transport, m = variant
    fidelity, loss = fid
    spec = FABRIC_SPECS[fab]
    topos = fabrics(spec[0], *spec[1], **spec[2]) if spec else (None, None)
    got, want, rng_t, rng_r = run_both(
        "build_hierarchical_allgather", (P, 1 << 18, G, m),
        dict(stripe_mode=mode, redistribute_transport=transport), fidelity=fidelity,
        topos=topos, loss=loss, fab=dict(jitter=1e-6), seed=3)
    assert_run_same(got, want, rng_t, rng_r, f"{fab} {variant} {fid}")
    if fidelity != "analytic":
        assert got.completed
        if spec:
            assert got.link_bytes


def test_hier_placed_hosts_match_reference():
    """Ranks on hosts of a 32-host island fabric in another order: a rank
    island on a physical island (the island tier joins only those), the
    islands and their members shuffled."""
    hosts = [4 * isl + r for isl in (1, 0, 6, 3) for r in (2, 0, 3, 1)]
    for fidelity, loss in (("fluid", None), ("packet", 0.01)):
        got, want, rng_t, rng_r = run_both(
            "build_hierarchical_allgather", (P, 1 << 18, G, 2), {}, fidelity=fidelity,
            topos=fabrics("IslandFatTree", 8, 32, island_size=4), hosts=hosts, loss=loss,
            fab=dict(), seed=8)
        assert_run_same(got, want, rng_t, rng_r, fidelity)


def test_hier_packet_options_go_to_the_multicast_stripe_only():
    """The packet options (the event DPA with ``dpa=``, ``aggregate_nacks``,
    ``max_rounds``) reach a multicast stripe leg and equal the reference's;
    a ring stripe takes none, and they are dropped as the reference drops
    them."""
    opts = dict(dpa_fidelity="event", dpa=(dpa.DpaConfig("UD", 16), ref_dpa.DpaConfig("UD", 16)),
                aggregate_nacks=False, max_rounds=4)
    for mode in ("mcast", "ring"):
        for topo_spec in (None, ("IslandFatTree", (4, 16), dict(island_size=4))):
            topos = fabrics(topo_spec[0], *topo_spec[1], **topo_spec[2]) if topo_spec \
                else (None, None)
            got, want, rng_t, rng_r = run_both(
                "build_hierarchical_allgather", (P, 1 << 18, G, 2), dict(stripe_mode=mode),
                fidelity="packet", topos=topos, loss=0.01, fab=dict(), seed=2, opts=opts)
            assert_run_same(got, want, rng_t, rng_r, f"{mode} {topo_spec}")


@pytest.mark.parametrize("stripe_mode", ["mcast", "ring"])
def test_hier_fidelity_ordering_abstract(stripe_mode):
    """tests/test_hier_fabric.py:122, in the port: one generator through the
    fluid and packet runs, as the reference test carries it."""
    out = {}
    for mod in (sched_ir, ref_ir):
        sched = mod.build_hierarchical_allgather(P, N, G, stripe_mode=stripe_mode)
        rng = np.random.default_rng(0)
        fab = (engine if mod is sched_ir else ref_engine).FabricParams(**FAB)
        wk = (engine if mod is sched_ir else ref_engine).WorkerParams(**WK)
        dev = dict(device="cpu") if mod is sched_ir else {}
        a = mod.execute(sched, fab, wk, fidelity="analytic")
        f = mod.execute(sched, fab, wk, rng, fidelity="fluid", **dev)
        p = mod.execute(sched, fab, wk, rng, fidelity="packet", **dev)
        out[mod.__name__] = (a, f, p, rng.random())
    (a, f, p, draw), (ra, rf, rp, rdraw) = out["repro_torch.core.sched_ir"], \
        out["repro.core.sched_ir"]
    assert a == ra and draw == rdraw
    assert_same(f, rf)
    assert_same(p, rp)
    assert math.isfinite(a) and a > 0
    assert a <= f.time + 1e-12 <= p.time + 1e-9
    assert p.completed


def test_hier_fluid_beats_flat_builders_on_island_fabric():
    """tests/test_hier_fabric.py:133, in the port."""
    topo, ref = _island()
    hosts = list(range(P))
    times = {}
    for name, args in (("hier", ("build_hierarchical_allgather", (P, N, G))),
                       ("flat", ("build_allgather", (P, N, P))),
                       ("ring", ("build_ring_allgather", (P, N)))):
        got = _execute(sched_ir, topo, getattr(sched_ir, args[0])(*args[1]), "fluid",
                       hosts=hosts)
        want = _execute(ref_ir, ref, getattr(ref_ir, args[0])(*args[1]), "fluid", hosts=hosts)
        assert_same(got, want, name)
        times[name] = got.time
    assert times["hier"] < times["flat"] and times["hier"] < times["ring"]


def test_hier_moves_bytes_onto_island_tier():
    """tests/test_hier_fabric.py:149, in the port."""
    topo, _ = _island()
    hosts = list(range(P))
    res = _execute(sched_ir, topo, sched_ir.build_hierarchical_allgather(P, N, G), "fluid",
                   hosts=hosts)
    split = topo.tier_split(res.link_bytes)
    topo.reset()
    flat = _execute(sched_ir, topo, sched_ir.build_allgather(P, N, P), "fluid", hosts=hosts)
    flat_split = topo.tier_split(flat.link_bytes)
    assert split.get("island", 0.0) > 0
    assert flat_split.get("island", 0.0) == 0
    assert split["switched"] < flat_split["switched"]


def test_hier_packet_island_redistribution_is_lossless():
    """tests/test_hier_fabric.py:168, in the port and equal to the
    reference: phase C all on the island tier runs lossless."""
    topo, ref = _island()
    hosts = list(range(P))
    sched = sched_ir.build_hierarchical_allgather(P, N, G)
    res = _execute(sched_ir, topo, sched, "packet", hosts=hosts, loss=0.02)
    assert_same(res, _execute(ref_ir, ref, ref_ir.build_hierarchical_allgather(P, N, G),
                              "packet", hosts=hosts, loss=0.02))
    assert res.completed
    topo.reset()
    clean = _execute(sched_ir, topo, sched, "packet", hosts=hosts)
    assert res.ring.time == pytest.approx(clean.ring.time)
    assert res.stripe.time >= clean.stripe.time


def test_hier_switched_redistribution_keeps_loss_model():
    """tests/test_hier_fabric.py:185, in the port and equal to the reference."""
    topo, ref = _island()
    hosts = list(range(P))
    kw = dict(redistribute_transport="switched")
    sched = sched_ir.build_hierarchical_allgather(P, N, G, **kw)
    res = _execute(sched_ir, topo, sched, "packet", hosts=hosts, loss=0.05)
    assert_same(res, _execute(ref_ir, ref, ref_ir.build_hierarchical_allgather(P, N, G, **kw),
                              "packet", hosts=hosts, loss=0.05))
    assert res.completed and math.isfinite(res.time)
    topo.reset()
    clean = _execute(sched_ir, topo, sched, "packet", hosts=hosts)
    assert res.ring.time > clean.ring.time


# ----------------------------------------------------------- the searcher's


def test_hier_candidates_only_on_island_fabrics():
    """tests/test_hier_fabric.py:212, in the port; the candidates equal the
    reference's (names, origins, schedules)."""
    assert sched_search.hier_candidates(P, N, topology.FatTree(4, P)) == []
    assert sched_search.hier_candidates(P, N, None) == []
    topo, ref = _island()
    cands = sched_search.hier_candidates(P, N, topo)
    assert_same(cands, ref_search.hier_candidates(P, N, ref))
    names = [c.name for c in cands]
    assert any(c.origin == "builder" and f"g={G}" in c.name for c in cands)
    assert any("g=2" in n for n in names)
    assert any("ring-stripe" in n for n in names)
    assert any("switched-redist" in n for n in names)
    assert any("fanout" in n for n in names)
    plain = sched_search.hier_candidates(P, N, topo, fanout_moves=False)
    assert_same(plain, ref_search.hier_candidates(P, N, ref, fanout_moves=False))
    assert not any("fanout" in c.name for c in plain)
    assert {c.name for c in plain} < {c.name for c in cands}
    for c in cands:
        sched_ir.validate(c.sched)


def test_hier_lower_bound_admissible():
    """tests/test_hier_fabric.py:234, in the port: every candidate's bound
    equal to the reference's and at most its fluid time."""
    topo, ref = _island()
    ctx = sched_search.EvalContext(engine.FabricParams(**FAB), engine.WorkerParams(**WK), topo,
                                   tuple(range(P)), "fluid", 0, "cpu")
    ref_ctx = ref_search.EvalContext(ref_engine.FabricParams(**FAB),
                                     ref_engine.WorkerParams(**WK), ref, tuple(range(P)),
                                     "fluid", 0)
    assert ctx.key() == ref_ctx.key()
    cache, ref_cache = sched_search.EvalCache(), ref_search.EvalCache()
    for cand, ref_cand in zip(sched_search.hier_candidates(P, N, topo),
                              ref_search.hier_candidates(P, N, ref)):
        bound = sched_search.lower_bound(cand.sched, ctx)
        assert bound == ref_search.lower_bound(ref_cand.sched, ref_ctx)
        res = cache.evaluate(cand.sched, ctx)
        assert_same(res, ref_cache.evaluate(ref_cand.sched, ref_ctx))
        assert bound[0] <= res.time + 1e-12, cand.name


def test_search_picks_mixed_transport_winner():
    """tests/test_hier_fabric.py:244, in the port; the SearchResult equal to
    the reference's (the wall clock aside)."""
    topo, ref = _island()
    r = sched_search.search("allgather", P, N, topology=topo, hosts=list(range(P)),
                            validate_packet=True, device="cpu")
    assert_same(r, ref_search.search("allgather", P, N, topology=ref, hosts=list(range(P)),
                                     validate_packet=True), skip=("wall_s",))
    assert r.winner.sched.kind == "hier_allgather"
    assert r.packet_validated
    assert r.certificate.ratio >= 1.0 - 1e-9
    flat_times = [row.time for row in r.table
                  if row.origin == "builder" and "hier" not in row.name and row.time is not None]
    assert flat_times and r.winner_time < min(flat_times)
    assert any("hier" in row.name for row in r.table)


# ------------------------------------------------------- stripe contention


def test_interstripe_contention_factor_measured_and_applied():
    """tests/test_hier_fabric.py:332, in the port: the factor equals the
    reference's and the fluid stripe is the solo stripe times it."""
    (topo, ref), p, g = _contended(), 32, 4
    hosts = list(range(p))
    sched = sched_ir.build_hierarchical_allgather(p, N, g)
    stripe_hosts = [j * g for j in range(p // g)]
    co = [[j * g + r for j in range(p // g)] for r in range(1, g)]
    factor = sched_ir._stripe_contention_factor(
        sched.meta["stripe_ag"], engine.FabricParams(**FAB), engine.WorkerParams(**WK), topo,
        stripe_hosts, co, device="cpu")
    ref_sched = ref_ir.build_hierarchical_allgather(p, N, g)
    assert factor == ref_ir._stripe_contention_factor(
        ref_sched.meta["stripe_ag"], ref_engine.FabricParams(**FAB),
        ref_engine.WorkerParams(**WK), ref, stripe_hosts, co)
    assert factor > 1.0
    solo = sched_ir._fluid_allgather(sched.meta["stripe_ag"], engine.FabricParams(**FAB),
                                     engine.WorkerParams(**WK), np.random.default_rng(0),
                                     topology=topo, hosts=stripe_hosts, device="cpu")
    res = _execute(sched_ir, topo, sched, "fluid", hosts=hosts)
    assert_same(res, _execute(ref_ir, ref, ref_sched, "fluid", hosts=hosts))
    assert res.stripe.time == pytest.approx(solo.time * factor, rel=1e-9)
    assert sched_ir._stripe_contention_factor(sched.meta["stripe_ag"], None, None, topo,
                                              stripe_hosts, []) == 1.0


def test_interstripe_contention_packet_scales_with_fluid_factor():
    """tests/test_hier_fabric.py:354, in the port and equal to the reference."""
    (topo, ref), p, g = _contended(), 32, 4
    hosts = list(range(p))
    fl = _execute(sched_ir, topo, sched_ir.build_hierarchical_allgather(p, N, g), "fluid",
                  hosts=hosts)
    topo.reset()
    pk_res = _execute(sched_ir, topo, sched_ir.build_hierarchical_allgather(p, N, g), "packet",
                      hosts=hosts)
    assert_same(pk_res, _execute(ref_ir, ref, ref_ir.build_hierarchical_allgather(p, N, g),
                                 "packet", hosts=hosts))
    assert fl.time <= pk_res.time + 1e-9
    assert pk_res.stripe.time >= fl.stripe.time - 1e-12


def test_interstripe_contention_preserves_link_bytes():
    """tests/test_hier_fabric.py:371, in the port."""
    (topo, _), p, g = _contended(), 32, 4
    hosts = list(range(p))
    sched = sched_ir.build_hierarchical_allgather(p, N, g)
    fl = _execute(sched_ir, topo, sched, "fluid", hosts=hosts)
    topo.reset()
    pk_res = _execute(sched_ir, topo, sched, "packet", hosts=hosts)
    assert set(fl.link_bytes) == set(pk_res.link_bytes)
    for name, v in fl.link_bytes.items():
        assert v == pytest.approx(pk_res.link_bytes[name], rel=1e-9), name


def test_fanout_moves_never_worsen_search_winner(monkeypatch):
    """tests/test_hier_fabric.py:389, in the port: the two searches equal
    the reference's."""
    topo, ref = _island()
    out = {}
    for mod, fab in ((sched_search, topo), (ref_search, ref)):
        cache = mod.EvalCache()
        real = mod.hier_candidates
        monkeypatch.setattr(mod, "hier_candidates",
                            lambda p, n, t, real=real: real(p, n, t, fanout_moves=False))
        dev = dict(device="cpu") if mod is sched_search else {}
        base = mod.search("allgather", P, N, topology=fab, hosts=list(range(P)),
                          validate_packet=False, cache=cache, **dev)
        monkeypatch.setattr(mod, "hier_candidates", real)
        full = mod.search("allgather", P, N, topology=fab, hosts=list(range(P)),
                          validate_packet=False, cache=cache, **dev)
        out[mod] = (base, full)
    for got, want in zip(out[sched_search], out[ref_search]):
        assert_same(got, want, skip=("wall_s",))
    base, full = out[sched_search]
    assert full.winner_time <= base.winner_time + 1e-15
    assert any("fanout" in row.name for row in full.table)
