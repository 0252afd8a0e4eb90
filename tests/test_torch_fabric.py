"""The port's fabric (``core/topology.py``) and cost model
(``core/cost_model.py``) against the JAX package's, on the CPU: the same
topologies built in both packages give the same links (names, endpoints,
capacities, tiers), the same routes and multicast and aggregation trees edge
for edge and in order, the same cuts and byte counters; every cost-model
function returns the reference's value exactly, the routed ring's time and
``link_bytes`` included (its engine's solve on the CPU).
"""
import numpy as np
import pytest

from repro.core import cost_model as ref_cm
from repro.core import engine as ref_engine
from repro.core import topology as ref_topo
from repro_torch.core import cost_model as cm
from repro_torch.core import engine, topology


def _names(links) -> list[tuple]:
    return [(l.name, l.src, l.dst, l.capacity) for l in links]


def _both(kind: str, *args, **kw):
    return getattr(topology, kind)(*args, **kw), getattr(ref_topo, kind)(*args, **kw)


def _same_fabric(got, want) -> None:
    assert list(got.links()) == list(want.links())
    assert _names(got.links().values()) == _names(want.links().values())
    assert {k: got.tier_of(*k) for k in got.links()} == {k: want.tier_of(*k)
                                                         for k in want.links()}
    assert got.signature() == want.signature()
    assert got.tier_capacities() == want.tier_capacities()
    assert got.bottleneck_cuts() == [topology.Cut(c.name, c.hosts, c.cap_in, c.cap_out)
                                     for c in want.bottleneck_cuts()]


FAT_TREES = [  # (k, n_hosts, oversubscription)
    (4, None, 1.0), (4, 7, 1.0), (6, 30, 2.0), (8, 32, 1.0), (8, 64, 4.0), (8, 100, 1.0),
]


@pytest.mark.parametrize("k,n_hosts,over", FAT_TREES)
def test_fat_tree_matches_reference(k, n_hosts, over):
    got, want = _both("FatTree", k, n_hosts, b_host=3e9, oversubscription=over)
    _same_fabric(got, want)
    assert _names(got.core_links()) == _names(want.core_links())
    n = got.n_hosts
    rng = np.random.default_rng(k * 1000 + n)
    pairs = [(a, b) for a in range(n) for b in range(n)] if n <= 32 else \
        [tuple(int(x) for x in rng.integers(0, n, 2)) for _ in range(600)]
    for a, b in pairs:
        assert _names(got.route(a, b)) == _names(want.route(a, b)), (a, b)
    for _ in range(40):
        root = int(rng.integers(n))
        members = sorted({int(x) for x in rng.integers(0, n, int(rng.integers(1, 17)))})
        for fn in ("multicast_tree", "aggregation_tree"):
            assert _names(getattr(got, fn)(root, members)) == \
                _names(getattr(want, fn)(root, members)), (fn, root, members)
    everyone = list(range(n))
    assert _names(got.multicast_tree(0, everyone)) == _names(want.multicast_tree(0, everyone))


@pytest.mark.parametrize("k,n_hosts,g", [(4, 16, 2), (4, 16, 4), (8, 64, 8), (8, 48, 6)])
def test_island_fat_tree_matches_reference(k, n_hosts, g):
    got, want = _both("IslandFatTree", k, n_hosts, island_size=g, b_host=3e9)
    _same_fabric(got, want)
    assert (got.n_islands, got.b_island) == (want.n_islands, want.b_island)
    rng = np.random.default_rng(n_hosts + g)
    for _ in range(300):
        a, b = (int(x) for x in rng.integers(0, n_hosts, 2))
        local = got.island_of(a) == got.island_of(b)
        for transport in (None, "switched") + (("island",) if local else ()):
            assert _names(got.route(a, b, transport=transport)) == \
                _names(want.route(a, b, transport=transport)), (a, b, transport)
    for root in range(0, n_hosts, 5):
        members = list(range(root % 3, n_hosts, 2))
        assert _names(got.multicast_tree(root, members)) == \
            _names(want.multicast_tree(root, members))
    lb = {link.name: float(i) for i, link in enumerate(want.links().values())}
    assert got.tier_split(lb) == want.tier_split(lb)
    with pytest.raises(ValueError):
        got.multicast_tree(0, [0, 1], transport="island")
    with pytest.raises(ValueError):
        got.route(0, g, transport="island")


@pytest.mark.parametrize("nx,ny", [(1, 4), (2, 2), (2, 3), (3, 3), (4, 5), (5, 2)])
def test_torus_matches_reference(nx, ny):
    got, want = _both("Torus2D", nx, ny, b_link=7e9)
    _same_fabric(got, want)
    n = nx * ny
    for a in range(n):
        assert got.host(a) == want.host(a)
        for b in range(n):
            assert _names(got.route(a, b)) == _names(want.route(a, b)), (a, b)
    rng = np.random.default_rng(n)
    for _ in range(40):
        root = int(rng.integers(n))
        members = sorted({int(x) for x in rng.integers(0, n, int(rng.integers(1, 9)))})
        assert _names(got.multicast_tree(root, members)) == \
            _names(want.multicast_tree(root, members)), (root, members)
    got.ring_allgather_traffic(nx, 1 << 12, bidi=True)
    want.ring_allgather_traffic(nx, 1 << 12, bidi=True)
    assert dict(got.counters.bytes_by_link) == dict(want.counters.bytes_by_link)


def test_torus_root_alone_tree_mirrors_reference():
    """A group of the root alone: the reference's torus tree has no edge, so
    it does not hold its root (tests/test_fabric.py::
    test_torus_multicast_tree_spans_members fails on nx = ny = 2, root 0,
    members [0]), where the fat-tree's holds the root's uplink. The port
    mirrors both."""
    for nx, ny in ((2, 2), (3, 4)):
        got, want = _both("Torus2D", nx, ny)
        assert got.multicast_tree(0, [0]) == [] == want.multicast_tree(0, [0])
    got, want = _both("FatTree", 4)
    assert _names(got.multicast_tree(3, [3])) == _names(want.multicast_tree(3, [3])) != []


def test_static_counting_and_counters_match_reference():
    got, want = _both("FatTree", 8, 40, b_host=5e9)
    for t in (got, want):
        t.unicast(0, 39, 100.0)
        t.unicast(5, 6, 7.5)
        t.multicast(3, range(0, 40, 3), 11.0)
        t.aggregation_tree(2, [1, 2, 30])
    gc, wc = got.counters, want.counters
    assert dict(gc.bytes_by_link) == dict(wc.bytes_by_link)
    assert (gc.total(), gc.max_link(), gc.switch_port_total()) == \
        (wc.total(), wc.max_link(), wc.switch_port_total())
    inside = {"h0", "h1", "e0.0"}
    assert got.cut_capacity(inside) == want.cut_capacity(inside)
    got.reset()
    assert got.counters.total() == 0 and all(not l.active for l in got.links().values())
    with pytest.raises(ValueError, match="nonexistent fabric link"):
        topology.FatTree(k=4).link("a0.0", "c3")     # core 3 hangs off agg 1, not agg 0
    assert isinstance(got, topology.Topology)
    assert isinstance(topology.Torus2D(2, 2), topology.Topology)


# ------------------------------------------------------------------ cost model


TRAFFIC = ("p2p_ring_allgather_traffic", "p2p_linear_allgather_traffic",
           "p2p_ring_pipeline_bcast_traffic", "mcast_bcast_traffic", "mcast_allgather_traffic")


@pytest.mark.parametrize("k,p", [(4, 16), (8, 32), (8, 100), (16, 64)])
@pytest.mark.parametrize("fn", TRAFFIC)
def test_cost_model_traffic_matches_reference(fn, k, p):
    got, want = _both("FatTree", k, p)
    for n in (1 << 20, 12345):
        assert getattr(cm, fn)(got, p, n) == getattr(ref_cm, fn)(want, p, n), n
        assert dict(got.counters.bytes_by_link) == dict(want.counters.bytes_by_link)


@pytest.mark.parametrize("k,p,radix", [(4, 16, 2), (8, 32, 4), (8, 100, 3)])
def test_cost_model_knomial_matches_reference(k, p, radix):
    got, want = _both("FatTree", k, p)
    assert cm.p2p_knomial_bcast_traffic(got, p, 1 << 16, k=radix) == \
        ref_cm.p2p_knomial_bcast_traffic(want, p, 1 << 16, k=radix)
    assert dict(got.counters.bytes_by_link) == dict(want.counters.bytes_by_link)


def test_cost_model_closed_forms_match_reference():
    for p in (2, 3, 16, 188, 1024):
        assert cm.concurrent_ag_rs_speedup(p) == ref_cm.concurrent_ag_rs_speedup(p)
        assert cm.mc_inc_share(p).__dict__ == ref_cm.mc_inc_share(p).__dict__
        for n in (1, 4096, 1 << 20, 8 << 20):
            for b in (56e9 / 8, 25e9):
                for mode in ("ring_ring", "mc_inc"):
                    assert cm.concurrent_completion_time(n, p, b, mode) == \
                        ref_cm.concurrent_completion_time(n, p, b, mode)
                for fn in ("bcast_time_multicast", "bcast_time_binary_tree",
                           "bcast_time_knomial", "allgather_time_ring",
                           "allgather_time_multicast"):
                    assert getattr(cm, fn)(n, b, p) == getattr(ref_cm, fn)(n, b, p), fn
                assert cm.bcast_time_knomial(n, b, p, k=4, seg=1 << 12) == \
                    ref_cm.bcast_time_knomial(n, b, p, k=4, seg=1 << 12)
            for bidi in (False, True):
                assert cm.torus_ring_per_link_bytes(p, 1 << 20, bidi=bidi) == \
                    ref_cm.torus_ring_per_link_bytes(p, 1 << 20, bidi=bidi)
    assert cm.ring_ring_share().__dict__ == ref_cm.ring_ring_share().__dict__
    with pytest.raises(ValueError):
        cm.concurrent_completion_time(1, 2, 1.0, "tree")


ROUTED_RINGS = [  # (topology kind, args, kw, p, hosts)
    ("FatTree", (8,), dict(n_hosts=32), 32, None),
    ("FatTree", (8,), dict(n_hosts=64, oversubscription=2.0), 48, list(range(63, 15, -1))),
    ("FatTree", (16,), dict(n_hosts=200), 200, None),      # 40,000 memberships: vectorized
    ("IslandFatTree", (8,), dict(n_hosts=32, island_size=4), 32, None),
    ("Torus2D", (4, 4), {}, 16, None),
]


@pytest.mark.parametrize("kind,args,kw,p,hosts", ROUTED_RINGS)
def test_routed_ring_allgather_matches_reference(kind, args, kw, p, hosts):
    got, want = _both(kind, *args, **kw)
    for fab in (None, engine.FabricParams(latency=3e-6)):
        ref_fab = None if fab is None else ref_engine.FabricParams(latency=3e-6)
        t, lb = cm.routed_ring_allgather(got, p, p << 16, fab, hosts, device="cpu")
        t_ref, lb_ref = ref_cm.routed_ring_allgather(want, p, p << 16, ref_fab, hosts)
        assert t == t_ref
        assert list(lb.items()) == list(lb_ref.items())
    with pytest.raises(ValueError):
        cm.routed_ring_allgather(got, p, 1 << 20, hosts=[0], device="cpu")
