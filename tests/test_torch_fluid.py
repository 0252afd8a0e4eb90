"""The port's fluid engine, its fluid and analytic lowerings and their
facades against the JAX package's, on the CPU. The same arguments and the
same numpy generator seed go into both packages, and every field must be
equal exactly: the engine's progress segments, ends, link bytes,
utilization and solve counters (incremental and global, on both solver
paths, rate caps included); the fluid Broadcast's and Allgather's results
on the abstract fabric and on routed ``FatTree``, ``IslandFatTree`` and
``Torus2D`` fabrics (with drops, jitter, staging-ring overflow, every chain
count, ``co_hosts``), with the generators left in one state; the ring
schedules; the analytic oracle; ``sweep_phase_breakdown`` and the protocol
facades. The reference's guards raise in the port too.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import protocol as ref_protocol
from repro.core import sched_ir as ref_ir
from repro.core import simulator as ref_sim
from repro.core import topology as ref_topo
from repro_torch.core import engine, protocol, sched_ir, simulator, topology
from repro_torch.kernels import pool


def assert_same(a, b, ctx="") -> None:
    """Every field of two results (the packages' dataclasses), exactly:
    arrays element for element, dicts key for key and in order."""
    assert type(a).__name__ == type(b).__name__, ctx
    for f in dataclasses.fields(b):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), (ctx, f.name)
        elif dataclasses.is_dataclass(y):
            assert dataclasses.astuple(x) == dataclasses.astuple(y), (ctx, f.name)
        elif isinstance(y, dict):
            assert list(x.items()) == list(y.items()), (ctx, f.name)
        else:
            assert x == y, (ctx, f.name, x, y)


# ------------------------------------------------------------------ the engine

_CAPS = (1.0, 2.0, 3.5, 5.0, 8.0, 10.0, 16.0)


def _scenario(seed: int, n_flows: int, max_route: int, n_links: int | None = None):
    """(link capacities, [(route link ids, bytes, start, rate cap)]): the
    random flow/link DAGs of tests/test_maxmin_incremental.py, drawn from a
    numpy generator: overlapping routes, start times shared by several flows
    (one event batch), occasional rate caps."""
    rng = np.random.default_rng(seed)
    n_links = n_links or int(rng.integers(2, 9))
    caps = [float(rng.choice(_CAPS)) for _ in range(n_links)]
    starts = [float(x) for x in rng.uniform(0.0, 3.0, 4)]
    flows = []
    for _ in range(n_flows):
        r_len = int(rng.integers(1, min(max_route, n_links) + 1))
        route = tuple(int(x) for x in rng.choice(n_links, size=r_len, replace=False))
        cap = (None, None, None, 1.5, 4.0)[int(rng.integers(5))]
        flows.append((route, float(rng.uniform(0.5, 20.0)), starts[int(rng.integers(4))], cap))
    return caps, flows


def _run(mod, caps, flows, mode, cut=None):
    eng = mod.Engine(device="cpu") if mod is engine else mod.Engine()
    eng._maxmin_mode = mode
    links = [eng.add_link(f"l{i}", c) for i, c in enumerate(caps)]
    out = []
    mid = len(flows) // 2 if cut is not None else len(flows)
    for route, n_bytes, t_start, cap in flows[:mid]:
        out.append(eng.submit([links[i] for i in route], n_bytes, t_start=t_start, rate_cap=cap))
    if cut is not None:
        eng.advance_to(cut)
        for route, n_bytes, t_start, cap in flows[mid:]:
            out.append(eng.submit([links[i] for i in route], n_bytes,
                                  t_start=max(t_start, eng.now), rate_cap=cap))
    eng.run()
    return eng, out


def _observed(eng, flows):
    return ([f.segments for f in flows], [f.t_end for f in flows], eng.now,
            list(eng.link_bytes().items()), list(eng.utilization().items()),
            eng.utilization(0.0), eng.maxmin_solves, eng.maxmin_flows_solved)


# (n_flows, max route): below 512 memberships the dict path, above the
# vectorized one (40 links, up to 6 on a route)
SIZES = {"dict": (12, 3, None), "vectorized": (240, 6, 40)}


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("mode", ["incremental", "reference"])
def test_engine_matches_reference(mode, seed, size):
    n_flows, max_route, n_links = SIZES[size]
    caps, flows = _scenario(seed, n_flows, max_route, n_links)
    solves0 = engine.counts["device_solves"]
    got = _observed(*_run(engine, caps, flows, mode))
    want = _observed(*_run(ref_engine, caps, flows, mode))
    assert got == want
    assert (engine.counts["device_solves"] > solves0) == (size == "vectorized")


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("seed", range(4))
def test_engine_incremental_equals_global_with_advance_to(seed, size):
    """The incremental solve equals the global one segment for segment,
    also when ``advance_to`` cuts the run, and both equal the reference's."""
    n_flows, max_route, n_links = SIZES[size]
    caps, flows = _scenario(100 + seed, n_flows, max_route, n_links)
    cut = 0.1 + seed
    runs = {mode: _run(engine, caps, flows, mode, cut) for mode in ("reference", "incremental")}
    (er, fr), (ei, fi) = runs["reference"], runs["incremental"]
    assert ei.now == er.now
    assert [f.segments for f in fi] == [f.segments for f in fr]
    assert [f.t_end for f in fi] == [f.t_end for f in fr]
    assert ei.maxmin_flows_solved <= er.maxmin_flows_solved
    want = _run(ref_engine, caps, flows, "incremental", cut)
    assert _observed(ei, fi) == _observed(*want)


def test_engine_component_locality_and_order():
    """An event in one component never solves another (the counters), and a
    component comes back in ``_active`` order."""
    for mod in (engine, ref_engine):
        counts = []
        for mode in ("incremental", "reference"):
            eng = mod.Engine()
            eng._maxmin_mode = mode
            la, lb = eng.add_link("a", 1.0), eng.add_link("b", 1.0)
            eng.submit(la, 100.0, t_start=0.0)
            for k in range(5):
                eng.submit(lb, 1.0, t_start=float(k))
            eng.run()
            counts.append((eng.maxmin_solves, eng.maxmin_flows_solved))
        assert counts[0][0] <= 10 and counts[0][1] <= 2 + 2 * 9
        assert counts[1][1] > counts[0][1]
        if mod is engine:
            mine = counts
    assert mine == counts
    eng = engine.Engine()
    l1, l2 = eng.add_link("x", 2.0), eng.add_link("y", 2.0)
    f1 = eng.submit([l1], 4.0, t_start=0.0)
    f2 = eng.submit([l1, l2], 4.0, t_start=0.0)
    f3 = eng.submit([l2], 4.0, t_start=0.0)
    eng.advance_to(0.5)
    assert eng._component([l2]) == [f1, f2, f3]


@pytest.mark.parametrize("seed", range(6))
def test_dict_and_vectorized_fillings(seed):
    """The two solver paths give the same allocation (within the
    reference's own 1e-9 between them), each bitwise its reference
    counterpart, with rate caps biting."""
    outs = {}
    for mod in (engine, ref_engine):
        r = np.random.default_rng(seed)
        links = [mod.Link(f"l{i}", float(r.integers(10, 200))) for i in range(12)]
        eng = mod.Engine()
        for _ in range(30 + 10 * seed):
            sel = r.choice(12, size=int(r.integers(1, 5)), replace=False)
            cap = float(r.uniform(1.0, 50.0)) if r.random() < 0.3 else None
            eng.submit([links[j] for j in sel], 1e6, rate_cap=cap)
        eng.advance_to(1e-9)
        py = mod._max_min_rates_py(eng._active)
        vec = (engine._max_min_rates_vec(eng._active, torch.device("cpu")) if mod is engine
               else ref_engine._max_min_rates_np(eng._active))
        outs[mod] = ([py[f] for f in eng._active], [vec[f] for f in eng._active])
    (py_t, vec_t), (py_r, vec_r) = outs[engine], outs[ref_engine]
    assert py_t == py_r and vec_t == vec_r
    assert vec_t == pytest.approx(py_t, rel=1e-9, abs=1e-12)


def test_rate_caps_and_routes_match_reference():
    """Water-filling with caps on a route and a tree: the capped flow keeps
    its cap, the rest share what it leaves; bytes charge every link."""
    got = []
    for mod in (engine, ref_engine):
        eng = mod.Engine()
        a, b, c = eng.add_link("a", 10.0), eng.add_link("b", 6.0), eng.add_link("c", 4.0)
        flows = [eng.submit([a, b], 30.0, rate_cap=1.0), eng.submit([a], 50.0),
                 eng.submit_route([b, c], 12.0), eng.submit_tree([a, b, c], 8.0, rate_cap=2.5),
                 eng.submit_route([], 5.0, t_start=0.5), eng.submit([c], 0.0, t_start=1.0)]
        t = eng.wait(*flows[:2])
        eng.run()
        got.append(([f.segments for f in flows], [f.t_end for f in flows], t,
                     list(eng.link_bytes().items()), list(eng.utilization(3.0).items()),
                     [f.chunk_times(7, 5.0).tolist() for f in flows[:4]], flows[0].link.name,
                     flows[4].link))
    assert got[0] == got[1]


def test_engine_guards():
    eng = engine.Engine(device="cpu")
    eng.add_link("l", 10.0)
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(["l", "l"], 1.0)
    other = engine.Link("l", 5.0)
    with pytest.raises(ValueError, match="collision"):
        eng.submit([other], 1.0)
    eng.advance_to(2.0)
    with pytest.raises(ValueError, match="before now"):
        eng.submit("l", 1.0, t_start=1.0)
    with pytest.raises(ValueError, match="capacity"):
        engine.Link("z", 0.0)
    f = eng.submit("l", 5.0)
    with pytest.raises(RuntimeError, match="run the engine"):
        f.chunk_times(1, 5.0)


def test_engine_maxmin_env_wiring(monkeypatch):
    monkeypatch.delenv("ENGINE_MAXMIN", raising=False)
    assert engine.Engine()._maxmin_mode == "incremental"
    monkeypatch.setenv("ENGINE_MAXMIN", "reference")
    assert engine.Engine()._maxmin_mode == "reference"
    monkeypatch.setenv("ENGINE_MAXMIN", "bogus")
    with pytest.raises(ValueError, match="ENGINE_MAXMIN"):
        engine.Engine()


# --------------------------------------------------------------- worker pools


@pytest.mark.parametrize("w,staging", [(1, 16), (2, 8192), (3, 5), (8, 64), (16, 1)])
def test_pool_rows_match_the_one_dimensional_pool(w, staging):
    """The row pass (ragged rows, +inf padding) equals the 1-D pool on each
    row's real prefix and the reference's row twin, bitwise, staging-ring
    overflow included; the loop oracle within the reference's own limits of
    them (rtol 1e-12), bitwise its reference copy."""
    rng = np.random.default_rng(w * 100 + staging)
    lens = [0, 1, 7, 40, 333, 500]
    service = 1e-3
    rows = np.full((len(lens), max(lens)), np.inf)
    for k, n in enumerate(lens):
        rows[k, :n] = np.sort(rng.uniform(0.0, 0.2, n))
    done, mask = engine.worker_pool_completion_rows(torch.from_numpy(rows), w, service,
                                                    staging)
    want_done, want_mask = ref_engine.worker_pool_completion_rows(rows, w, service, staging)
    assert np.array_equal(done.numpy(), want_done) and np.array_equal(mask.numpy(), want_mask)
    overflow = 0
    for k, n in enumerate(lens):
        d1, rnr1 = engine.worker_pool_completion(rows[k, :n], w, service, staging)
        d2, rnr2 = engine.worker_pool_completion_loop(rows[k, :n], w, service, staging)
        d3, rnr3 = ref_engine.worker_pool_completion_loop(rows[k, :n], w, service, staging)
        assert np.array_equal(done[k, :n].numpy(), d1) and np.array_equal(d2, d3)
        np.testing.assert_allclose(d1, d2, rtol=1e-12, atol=1e-15)
        assert int(mask[k].sum()) == rnr1 == rnr2 == rnr3
        assert np.array_equal(engine.staging_rnr_mask(d1, rows[k, :n], staging),
                              ref_engine.staging_rnr_mask(d1, rows[k, :n], staging))
        overflow += rnr1
    if staging < 100 and w < 8:
        assert overflow > 0
    with pytest.raises(ValueError):
        engine.worker_pool_completion_rows(torch.zeros(3), 1, 1.0, 1)


# ------------------------------------------------------- fluid Broadcast, Allgather

FAB0 = dict(jitter=0.0)
LOSSY = dict(p_drop=0.02)
WK8 = dict(n_recv_workers=8)
WKS = dict(staging_chunks=16)              # one worker, a short ring: RNR drops
WK2 = dict(n_recv_workers=2, thread_tput=9.0 * (1 << 30))


def _fabric(spec):
    """(port topology, reference topology, hosts) of a fabric spec."""
    if spec is None:
        return None, None, None
    kind, args, kw, hosts = spec
    return (getattr(topology, kind)(*args, **kw), getattr(ref_topo, kind)(*args, **kw),
            hosts)


FT8 = ("FatTree", (8,), dict(n_hosts=32, b_host=25e9), None)
FT8_THIN = ("FatTree", (8,), dict(n_hosts=24, b_host=25e9, oversubscription=4.0),
            list(range(23, -1, -1)))
ISL = ("IslandFatTree", (4,), dict(n_hosts=16, island_size=4, b_host=25e9), None)
TOR = ("Torus2D", (4, 4), dict(b_link=25e9), None)

BCAST_GRID = [  # (p, n_bytes, fabric kw, workers kw, fabric spec, root, seed)
    (8, 1 << 20, FAB0, WK8, None, 0, 0),
    (8, 1 << 20, {}, WK8, None, 3, 5),
    (16, 1 << 18, LOSSY, {}, None, 0, 1),
    (16, 1 << 18, dict(p_drop=0.3), WKS, None, 7, 2),
    (5, 1000, {}, {}, None, 4, 3),
    (2, 0, {}, {}, None, 1, 3),
    (12, 1 << 19, dict(p_drop=1.0), {}, None, 0, 4),       # every chunk dropped
    (16, 1 << 20, FAB0, WK8, FT8, 0, 0),
    (24, 1 << 19, LOSSY, WKS, FT8_THIN, 5, 6),
    (16, 1 << 18, {}, WK2, ISL, 9, 7),
    (16, 1 << 18, LOSSY, WK8, TOR, 6, 8),
]


@pytest.mark.parametrize("case", range(len(BCAST_GRID)))
def test_fluid_broadcast_matches_reference(case):
    p, n, fab, wk, spec, root, seed = BCAST_GRID[case]
    topo, ref_t, hosts = _fabric(spec)
    rng_t, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    got = simulator.simulate_broadcast(p, n, engine.FabricParams(**fab),
                                       engine.WorkerParams(**wk), rng_t, root, topology=topo,
                                       hosts=hosts, device="cpu")
    want = ref_sim.simulate_broadcast(p, n, ref_engine.FabricParams(**fab),
                                      ref_engine.WorkerParams(**wk), rng_r, root,
                                      topology=ref_t, hosts=hosts)
    assert_same(got, want, case)
    assert got.time == want.time
    assert rng_t.random() == rng_r.random()
    if topo is not None:
        assert dict(topo.counters.bytes_by_link) == dict(ref_t.counters.bytes_by_link)


def test_fluid_broadcast_leaves_in_one_pool_pass():
    """The P - 1 leaves' pools are one call of the pool kernel's wrapper,
    with the leaves' rows stacked (a CPU tensor: its plain version)."""
    calls = []
    real = pool.pool_completion_rows

    def counted(arrivals, *a):
        calls.append(tuple(arrivals.shape))
        return real(arrivals, *a)

    pool.pool_completion_rows = counted
    try:
        simulator.simulate_broadcast(20, 1 << 18, engine.FabricParams(p_drop=0.05),
                                     engine.WorkerParams(), np.random.default_rng(0), 3,
                                     device="cpu")
    finally:
        pool.pool_completion_rows = real
    assert calls == [(19, 64)]


AG_GRID = [  # (p, n_bytes, m, fabric kw, workers kw, fabric spec, seed)
    (4, 1 << 16, 1, FAB0, WK8, None, 0),
    (8, 1 << 17, 2, {}, WK8, None, 1),
    (16, 1 << 17, 4, LOSSY, {}, None, 2),
    (10, 1 << 16, 4, {}, WKS, None, 3),       # uneven chains, RNR drops
    (6, 1 << 15, 6, dict(p_drop=0.5), WK8, None, 4),
    (12, 1 << 16, 12, dict(p_drop=1.0), {}, None, 5),   # every chunk dropped
    (3, 100, 2, {}, {}, None, 6),
    (16, 1 << 18, 16, FAB0, WK8, FT8, 0),
    (16, 1 << 18, 2, FAB0, WK8, FT8, 7),
    (32, 1 << 16, 32, {}, WKS, FT8, 8),        # 32 trees: the vectorized solve
    (24, 1 << 17, 5, LOSSY, WK2, FT8_THIN, 9),
    (16, 1 << 16, 4, {}, WK8, ISL, 10),
    (16, 1 << 16, 16, LOSSY, {}, TOR, 11),
    (16, 1 << 16, 3, FAB0, WK8, TOR, 12),
]


@pytest.mark.parametrize("case", range(len(AG_GRID)))
def test_fluid_allgather_matches_reference(case):
    p, n, m, fab, wk, spec, seed = AG_GRID[case]
    topo, ref_t, hosts = _fabric(spec)
    rng_t, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    got = simulator.simulate_allgather(p, n, engine.FabricParams(**fab),
                                       engine.WorkerParams(**wk), rng_t, m, topology=topo,
                                       hosts=hosts, device="cpu")
    want = ref_sim.simulate_allgather(p, n, ref_engine.FabricParams(**fab),
                                      ref_engine.WorkerParams(**wk), rng_r, m,
                                      topology=ref_t, hosts=hosts)
    assert_same(got, want, case)
    assert rng_t.random() == rng_r.random()


@pytest.mark.parametrize("spec", [FT8, ISL])
def test_co_hosts_match_reference(spec):
    """Sibling stripes running the same schedule at once (``co_hosts``):
    their flows contend and their bytes count, in both lowerings."""
    topo, ref_t, _ = _fabric(spec)
    n = topo.n_hosts
    hosts = list(range(0, n, 2))
    co = [list(range(1, n, 2))]
    for build, lower, ref_lower in (
            (sched_ir.build_allgather, sched_ir._fluid_allgather, ref_ir._fluid_allgather),
            (sched_ir.build_ring_allgather, sched_ir._fluid_ring, ref_ir._fluid_ring)):
        args = (len(hosts), 1 << 16) + ((4,) if build is sched_ir.build_allgather else ())
        got = lower(build(*args), engine.FabricParams(), engine.WorkerParams(**WK8),
                    np.random.default_rng(0), topology=topo, hosts=hosts, co_hosts=co,
                    device="cpu")
        ref_build = getattr(ref_ir, build.__name__)
        want = ref_lower(ref_build(*args), ref_engine.FabricParams(),
                         ref_engine.WorkerParams(**WK8), np.random.default_rng(0),
                         topology=ref_t, hosts=hosts, co_hosts=co)
        assert_same(got, want, build.__name__)


# --------------------------------------------------------------- ring schedules


@pytest.mark.parametrize("p", [2, 3, 5, 8])
def test_ring_builders_match_reference(p):
    for build in ("build_ring_allgather", "build_ring_reduce_scatter"):
        got, want = getattr(sched_ir, build)(p, 1 << 12), getattr(ref_ir, build)(p, 1 << 12)
        assert sched_ir.canonical_key(got) == ref_ir.canonical_key(want)
        assert got.rounds() == want.rounds() and got.meta == want.meta
        assert sched_ir.payload_bytes(got) == ref_ir.payload_bytes(want)
        sched_ir.validate(got)


RINGS = [  # (builder, p, n_bytes, fabric kw, fabric spec)
    ("build_ring_allgather", 8, 1 << 20, {}, None),
    ("build_ring_reduce_scatter", 8, 1 << 20, dict(latency=5e-6), None),
    ("build_ring_allgather", 32, 1 << 18, {}, FT8),
    ("build_ring_reduce_scatter", 24, 3 << 18, {}, FT8_THIN),
    ("build_ring_allgather", 16, 1 << 18, {}, ISL),
    ("build_ring_reduce_scatter", 16, 1 << 18, {}, TOR),
]


@pytest.mark.parametrize("case", range(len(RINGS)))
def test_execute_ring_schedules_match_reference(case):
    build, p, n, fab, spec = RINGS[case]
    topo, ref_t, hosts = _fabric(spec)
    got = sched_ir.execute(getattr(sched_ir, build)(p, n), engine.FabricParams(**fab),
                           topology=topo, hosts=hosts, device="cpu")
    want = ref_ir.execute(getattr(ref_ir, build)(p, n), ref_engine.FabricParams(**fab),
                          topology=ref_t, hosts=hosts)
    assert_same(got, want, case)


# ------------------------------------------------------------ analytic fidelity


@pytest.mark.parametrize("wk", [{}, WK8, WK2])
def test_analytic_fidelity_matches_reference(wk):
    for p in (2, 5, 16, 188):
        for n in (1, 4096, 1 << 20):
            scheds = [("build_broadcast_tree", (p, n)), ("build_broadcast_tree", (p, n, 1)),
                      ("build_ring_allgather", (p, n)), ("build_ring_reduce_scatter", (p, n))]
            scheds += [("build_allgather", (p, n, m)) for m in sorted({1, min(3, p), p})]
            for build, args in scheds:
                got = sched_ir.execute(getattr(sched_ir, build)(*args),
                                       engine.FabricParams(latency=3e-6),
                                       engine.WorkerParams(**wk), fidelity="analytic")
                want = ref_ir.execute(getattr(ref_ir, build)(*args),
                                      ref_engine.FabricParams(latency=3e-6),
                                      ref_engine.WorkerParams(**wk), fidelity="analytic")
                assert got == want, (build, args)
    for name in ("analytic_rnr_barrier",):
        assert getattr(protocol, name)(188, 2e-6) == getattr(ref_protocol, name)(188, 2e-6)
    assert protocol.analytic_bcast_time(16, 1 << 20, 25e9, 2e-6, depth=3) == \
        ref_protocol.analytic_bcast_time(16, 1 << 20, 25e9, 2e-6, depth=3)
    assert protocol.cutoff_time(1 << 20, 25e9) == ref_protocol.cutoff_time(1 << 20, 25e9)


def test_phase_breakdown_and_protocol_facades_match_reference():
    got = simulator.sweep_phase_breakdown([4096, 1 << 17], [2, 16], seed=3, device="cpu")
    want = ref_sim.sweep_phase_breakdown([4096, 1 << 17], [2, 16], seed=3)
    assert got == want
    fab = engine.FabricParams(b_link=56e9 / 8)
    got = simulator.sweep_phase_breakdown([1 << 14], [4, 9], fab, engine.WorkerParams(**WKS),
                                          device="cpu")
    want = ref_sim.sweep_phase_breakdown([1 << 14], [4, 9], ref_engine.FabricParams(
        b_link=56e9 / 8), ref_engine.WorkerParams(**WKS))
    assert got == want
    for seed in (0, 4):
        assert protocol.broadcast_time(8, 1 << 16, fidelity="fluid", seed=seed,
                                       device="cpu") == \
            ref_protocol.broadcast_time(8, 1 << 16, fidelity="fluid", seed=seed)
        assert protocol.allgather_time(8, 1 << 16, n_chains=2, fidelity="fluid", seed=seed,
                                       device="cpu") == \
            ref_protocol.allgather_time(8, 1 << 16, n_chains=2, fidelity="fluid", seed=seed)
    # the default fidelity of the facades is the packet engine's, as the reference's
    assert protocol.broadcast_time(8, 1 << 16, device="cpu") == \
        ref_protocol.broadcast_time(8, 1 << 16)


def test_fluid_equals_packet_at_zero_loss():
    """At loss 0 the packet lowering reproduces the fluid times exactly, in
    the port as in the reference (tests/test_sched_ir.py's pins)."""
    wk, fab0 = engine.WorkerParams(**WK8), engine.FabricParams(jitter=0.0)
    fluid = simulator.simulate_broadcast(8, 1 << 20, fab0, wk, np.random.default_rng(0),
                                         device="cpu")
    packet = simulator.simulate_broadcast(8, 1 << 20, fab0, wk, np.random.default_rng(0),
                                          fidelity="packet", device="cpu")
    assert float(fluid.time) == float(packet.time) == 5.717663562800481e-05
    fluid = simulator.simulate_allgather(16, 1 << 18, fab0, wk, np.random.default_rng(0), 4,
                                         device="cpu")
    assert fluid.time == 0.0002027065425120192


# -------------------------------------------------------------------- guards


def test_guards_raise_like_the_reference():
    b = sched_ir.build_broadcast_tree(4, 1 << 12)
    ring = sched_ir.build_ring_allgather(4, 1 << 12)
    topo = topology.FatTree(k=4)
    for kw in (dict(loss=0.01), dict(max_rounds=3), dict(topology=topo),
               dict(hosts=[0, 1, 2, 3])):
        with pytest.raises(ValueError):
            sched_ir.execute(b, fidelity="analytic", **kw)
    for kw in (dict(loss=0.01), dict(max_rounds=3), dict(dpa_fidelity="event")):
        with pytest.raises(ValueError):
            sched_ir.execute(b, fidelity="fluid", device="cpu", **kw)
        with pytest.raises(ValueError):
            sched_ir.execute(ring, fidelity="fluid", device="cpu", **kw)
    with pytest.raises(ValueError, match="fidelity"):
        sched_ir.execute(b, fidelity="exact")
    with pytest.raises(ValueError, match="hosts"):
        sched_ir.execute(b, topology=topo, hosts=[0, 1], device="cpu")
    # the routed packet mode, the ring kinds at packet fidelity and the FSDP
    # step compute now, equal to the reference's
    ref_t = ref_topo.FatTree(k=4)
    got = sched_ir.execute(b, fidelity="packet", topology=topo, device="cpu")
    want = ref_ir.execute(ref_ir.build_broadcast_tree(4, 1 << 12), fidelity="packet",
                          topology=ref_t)
    assert (got.time, got.link_bytes) == (want.time, want.link_bytes) and got.link_bytes
    got = simulator.simulate_allgather(4, 1 << 12, engine.FabricParams(), engine.WorkerParams(),
                                       np.random.default_rng(0), 2, topology=topo,
                                       fidelity="packet", device="cpu")
    want = ref_sim.simulate_allgather(4, 1 << 12, ref_engine.FabricParams(),
                                      ref_engine.WorkerParams(), np.random.default_rng(0), 2,
                                      topology=ref_t, fidelity="packet")
    assert (got.time, got.link_bytes) == (want.time, want.link_bytes)
    got = sched_ir.execute(ring, fidelity="packet", loss=0.01, device="cpu")
    want = ref_ir.execute(ref_ir.build_ring_allgather(4, 1 << 12), fidelity="packet", loss=0.01)
    assert (got.time, got.bytes_recovery) == (want.time, want.bytes_recovery)
    fsdp = sched_ir.build_fsdp_step(p=4, n_layers=2, layer_bytes=1 << 20)
    for fidelity in ("fluid", "packet"):
        got = sched_ir.execute(fsdp, fidelity=fidelity, device="cpu")
        want = ref_ir.execute(ref_ir.build_fsdp_step(p=4, n_layers=2, layer_bytes=1 << 20),
                              fidelity=fidelity)
        assert (got.step_time, got.bubble_fraction) == (want.step_time, want.bubble_fraction)
    with pytest.raises(ValueError, match="fidelities"):
        sched_ir.execute(fsdp, fidelity="analytic", device="cpu")
    # the composite kinds compute at every fidelity, equal to the reference's
    for build, args in (("build_allreduce", (4, 1 << 12, 2)),
                        ("build_hierarchical_allgather", (4, 1 << 12, 2))):
        for fidelity in sched_ir.FIDELITIES:
            got = sched_ir.execute(getattr(sched_ir, build)(*args), fidelity=fidelity,
                                   device="cpu")
            want = ref_ir.execute(getattr(ref_ir, build)(*args), fidelity=fidelity)
            assert getattr(got, "time", got) == getattr(want, "time", want), (build, fidelity)
    bad = sched_ir.Schedule("ring_allgather", 2, 8, (sched_ir.Reduce(0, (0, 1), 8),))
    with pytest.raises(ValueError, match="single-source"):
        sched_ir.execute(bad, device="cpu")


def test_fluid_entry_points_default_to_cuda():
    """The fluid entry points run on CUDA unless given device='cpu'; without
    a card they raise instead of falling back to the CPU."""
    from repro_torch.core import cost_model

    fab, wk = engine.FabricParams(), engine.WorkerParams()
    calls = [
        lambda: simulator.simulate_broadcast(8, 1 << 16, fab, wk, np.random.default_rng(0)),
        lambda: simulator.simulate_allgather(8, 1 << 16, fab, wk, np.random.default_rng(0), 2),
        lambda: sched_ir.execute(sched_ir.build_ring_allgather(4, 1 << 12)),
        lambda: simulator.sweep_phase_breakdown([4096], [2]),
        lambda: protocol.allgather_time(8, 1 << 16, fidelity="fluid"),
        lambda: cost_model.routed_ring_allgather(topology.FatTree(k=4), 4, 1 << 12),
    ]
    if torch.cuda.is_available():
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_fluid_port_imports_neither_jax_nor_repro():
    """A routed fluid Allgather, Broadcast and ring, the cost model and the
    analytic oracle load no jax and no module of the JAX package."""
    import os
    import subprocess
    import sys

    code = (
        "import sys, numpy as np\n"
        "from repro_torch.core import cost_model, engine, sched_ir, simulator, topology\n"
        "t = topology.FatTree(k=8, n_hosts=32)\n"
        "r = simulator.simulate_allgather(32, 1 << 16, engine.FabricParams(),\n"
        "    engine.WorkerParams(), np.random.default_rng(0), 32, topology=t, device='cpu')\n"
        "assert r.link_bytes\n"
        "b = simulator.simulate_broadcast(16, 1 << 16, engine.FabricParams(p_drop=0.1),\n"
        "    engine.WorkerParams(), np.random.default_rng(0), device='cpu')\n"
        "assert b.recovered\n"
        "assert cost_model.routed_ring_allgather(t, 32, 1 << 20, device='cpu')[0] > 0\n"
        "assert cost_model.mcast_allgather_traffic(t, 32, 1 << 20) > 0\n"
        "assert sched_ir.execute(sched_ir.build_ring_reduce_scatter(8, 1 << 20),\n"
        "                        fidelity='analytic') > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
