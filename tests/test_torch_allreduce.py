"""The port's Allreduce (RS o AG, barrier and segment-pipelined) against the
JAX package's, on the CPU: the builders ``build_allreduce``,
``segment_bytes`` and ``build_pipelined_allreduce`` (ops, activation edges,
meta and ``canonical_key`` equal), the closed forms
``analytic_allreduce_time``, ``pipeline_schedule_time`` and
``analytic_pipelined_allreduce_time`` (bitwise), and ``sched_ir.execute``
of both kinds at the analytic, fluid and packet fidelities, on the abstract
fabric and on routed FatTree and Torus2D fabrics, lossless and at 1e-3.
The same arguments and numpy generator seeds go into both packages; every
field of the results must be equal exactly (the legs, the segments, the
link bytes, the round traces) and the generators must be left in one
state. Every comparison is exact: the reference is deterministic for a
seed, and so is the port.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import dpa as ref_dpa
from repro.core import engine as ref_engine
from repro.core import protocol as ref_protocol
from repro.core import sched_ir as ref_ir
from repro.core import topology as ref_topo
from repro_torch.core import dpa, engine, protocol, sched_ir, topology

WK = dict(n_recv_workers=8)


def assert_same(a, b, ctx="", skip=()) -> None:
    """Two results (the packages' dataclasses, recursively) equal exactly:
    arrays element for element with one dtype, dicts key for key in order,
    lists and tuples item for item, every other value by ``==``; the
    fields named in ``skip`` left out."""
    if dataclasses.is_dataclass(b) and not isinstance(b, type):
        assert type(a).__name__ == type(b).__name__, (ctx, type(a), type(b))
        for f in dataclasses.fields(b):
            if f.name not in skip:
                assert_same(getattr(a, f.name), getattr(b, f.name), f"{ctx}.{f.name}", skip)
    elif isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype, ctx
        assert np.array_equal(a, b), ctx
    elif isinstance(b, dict):
        assert list(a) == list(b), ctx
        for k in b:
            assert_same(a[k], b[k], f"{ctx}[{k!r}]", skip)
    elif isinstance(b, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (ctx, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{ctx}[{i}]", skip)
    else:
        # a float's type too: Python's sum rounds exact floats differently
        assert a == b and (type(a) is type(b) or not isinstance(b, float)), \
            (ctx, a, b, type(a), type(b))


def fabrics(kind, *args, **kw):
    """The same fabric built by both packages: (port, reference); (None,
    None) for the abstract fabric."""
    if kind is None:
        return None, None
    return getattr(topology, kind)(*args, **kw), getattr(ref_topo, kind)(*args, **kw)


def run_both(builder: str, args: tuple, kw: dict, *, fidelity="fluid", fab=None,
             topos=(None, None), hosts=None, loss=None, seed=0, opts=None):
    """(port result, reference result, port generator, reference generator)
    of ``execute`` of ``builder(*args, **kw)`` built by each package."""
    fab = dict(jitter=0.0) if fab is None else fab
    opts = opts or {}
    sched = getattr(sched_ir, builder)(*args, **kw)
    ref = getattr(ref_ir, builder)(*args, **kw)
    port_opts = {k: v[0] if isinstance(v, tuple) and k == "dpa" else v for k, v in opts.items()}
    ref_opts = {k: v[1] if isinstance(v, tuple) and k == "dpa" else v for k, v in opts.items()}
    if fidelity == "analytic":
        return (sched_ir.execute(sched, engine.FabricParams(**fab), engine.WorkerParams(**WK),
                                 fidelity="analytic"),
                ref_ir.execute(ref, ref_engine.FabricParams(**fab), ref_engine.WorkerParams(**WK),
                               fidelity="analytic"), None, None)
    rng_t, rng_r = np.random.default_rng(seed), np.random.default_rng(seed)
    got = sched_ir.execute(sched, engine.FabricParams(**fab), engine.WorkerParams(**WK), rng_t,
                           fidelity=fidelity, topology=topos[0], hosts=hosts, loss=loss,
                           device="cpu", **port_opts)
    want = ref_ir.execute(ref, ref_engine.FabricParams(**fab), ref_engine.WorkerParams(**WK),
                          rng_r, fidelity=fidelity, topology=topos[1], hosts=hosts, loss=loss,
                          **ref_opts)
    return got, want, rng_t, rng_r


def assert_run_same(got, want, rng_t, rng_r, ctx=""):
    assert_same(got, want, ctx)
    if rng_t is not None:
        assert rng_t.random() == rng_r.random(), ctx


# ------------------------------------------------------------------ builders

ALLREDUCE_ARGS = [(2, 1 << 12, None), (5, 1000, None), (5, 1000, 2), (8, 1 << 20, 8),
                  (8, 1 << 20, 3), (16, 3 << 18, 1), (16, 7, 4)]
PIPELINED_ARGS = [(4, 1 << 16, None, 1), (4, 1 << 16, None, 2), (8, 1 << 20, 4, 3),
                  (8, 1 << 20, 8, 8), (6, 1001, 2, 4), (16, 5, None, 5)]


@pytest.mark.parametrize("args", ALLREDUCE_ARGS)
def test_build_allreduce_matches_reference(args):
    got, want = sched_ir.build_allreduce(*args), ref_ir.build_allreduce(*args)
    assert_same(got, want, f"allreduce{args}")
    assert sched_ir.canonical_key(got) == ref_ir.canonical_key(want)
    assert got.rounds() == want.rounds()
    sched_ir.validate(got)


@pytest.mark.parametrize("args", PIPELINED_ARGS)
def test_build_pipelined_allreduce_matches_reference(args):
    p, n, m, s = args
    got = sched_ir.build_pipelined_allreduce(p, n, m, n_segments=s)
    want = ref_ir.build_pipelined_allreduce(p, n, m, n_segments=s)
    assert_same(got, want, f"pipelined{args}")
    assert sched_ir.canonical_key(got) == ref_ir.canonical_key(want)
    assert got.rounds() == want.rounds()
    sched_ir.validate(got)


def test_builders_guard_as_the_reference_asserts():
    """Where the reference asserts, the port raises ValueError."""
    for call, ref_call in [
            (lambda: sched_ir.build_allreduce(1, 1 << 10),
             lambda: ref_ir.build_allreduce(1, 1 << 10)),
            (lambda: sched_ir.build_pipelined_allreduce(4, 3, n_segments=4),
             lambda: ref_ir.build_pipelined_allreduce(4, 3, n_segments=4)),
            (lambda: sched_ir.segment_bytes(10, 0), lambda: ref_ir.segment_bytes(10, 0))]:
        with pytest.raises(AssertionError):
            ref_call()
        with pytest.raises(ValueError):
            call()


def test_segment_bytes_matches_reference():
    """And the reference's partition property (tests/test_sched_search.py:239)."""
    for n in (0, 1, 7, 10, 1 << 20, (1 << 20) + 3):
        for s in (1, 2, 3, 8):
            got = sched_ir.segment_bytes(n, s)
            assert got == ref_ir.segment_bytes(n, s)
            assert sum(got) == n and max(got) - min(got) <= 1


def test_single_segment_pipeline_keys_differ_from_barrier_like_the_reference():
    a = sched_ir.build_pipelined_allreduce(8, 1 << 20, 4, n_segments=1)
    b = sched_ir.build_allreduce(8, 1 << 20, 4)
    ra = ref_ir.build_pipelined_allreduce(8, 1 << 20, 4, n_segments=1)
    rb = ref_ir.build_allreduce(8, 1 << 20, 4)
    assert (sched_ir.canonical_key(a) == sched_ir.canonical_key(b)) == \
        (ref_ir.canonical_key(ra) == ref_ir.canonical_key(rb))


# --------------------------------------------------------------- closed forms


def test_closed_forms_bitwise():
    rng = np.random.default_rng(3)
    for _ in range(200):
        p = int(rng.integers(2, 300))
        n = int(rng.integers(1, 1 << 28))
        b = float(rng.uniform(1e9, 1e11))
        lat = float(rng.uniform(1e-7, 1e-5))
        m = [None, 1, int(rng.integers(1, p + 1)), p][int(rng.integers(4))]
        pool = [None, float(rng.uniform(1e9, 1e11))][int(rng.integers(2))]
        hop = float(rng.uniform(0.0, 3e-6))
        s = int(rng.integers(1, 9))
        kw = dict(m=m, pool_rate=pool, rnr_hop=hop)
        assert protocol.analytic_allreduce_time(p, n, b, lat, **kw) == \
            ref_protocol.analytic_allreduce_time(p, n, b, lat, **kw)
        assert protocol.analytic_pipelined_allreduce_time(p, n, b, lat, n_segments=s, **kw) == \
            ref_protocol.analytic_pipelined_allreduce_time(p, n, b, lat, n_segments=s, **kw)
        stages = rng.uniform(0.0, 1e-3, (2, s)).tolist()
        assert protocol.pipeline_schedule_time(*stages) == \
            ref_protocol.pipeline_schedule_time(*stages)


def test_pipeline_recurrence_reduces_to_sum_for_one_segment():
    """tests/test_sched_search.py:233, in the port."""
    assert protocol.pipeline_schedule_time([3.0], [2.0]) == 5.0
    assert protocol.pipeline_schedule_time([1.0, 1.0], [1.0, 1.0]) == 3.0
    with pytest.raises(ValueError):
        protocol.pipeline_schedule_time([], [])
    with pytest.raises(ValueError):
        protocol.analytic_pipelined_allreduce_time(8, 1 << 20, 1e10, 1e-6, n_segments=0)


# ------------------------------------------------------------------ execute

# (builder, args, kwargs, fabric kind or None, fabric args)
EXEC_GRID = [
    ("build_allreduce", (8, 1 << 20, None), {}, None),
    ("build_allreduce", (8, 1 << 20, 8), {}, None),
    ("build_allreduce", (7, 1 << 19, 3), {}, None),
    ("build_pipelined_allreduce", (8, 1 << 20, 4), dict(n_segments=3), None),
    ("build_pipelined_allreduce", (8, 1 << 20, None), dict(n_segments=2), None),
    ("build_allreduce", (16, 1 << 20, 16), {}, ("FatTree", (8,), dict(n_hosts=16,
                                                                       oversubscription=4.0))),
    ("build_allreduce", (16, 1 << 20, None), {}, ("FatTree", (8,), dict(n_hosts=16,
                                                                         oversubscription=4.0))),
    ("build_pipelined_allreduce", (16, 1 << 20, 16), dict(n_segments=2),
     ("FatTree", (8,), dict(n_hosts=16, oversubscription=4.0))),
    ("build_allreduce", (16, 1 << 20, 4), {}, ("Torus2D", (4, 4), {})),
    ("build_pipelined_allreduce", (16, 1 << 20, 16), dict(n_segments=4), ("Torus2D", (4, 4), {})),
]


def _grid_id(case):
    builder, args, kw, fab = case
    return f"{builder[6:]}{args}{kw.get('n_segments', '')}-{fab[0] if fab else 'abstract'}"


# (fidelity, loss, jitter); the analytic oracle has no routed mode, so it
# runs on the abstract fabric's cases only
FIDELITY_GRID = [("analytic", None, 0.0), ("fluid", None, 0.0), ("fluid", None, 1e-6),
                 ("packet", None, 1e-6), ("packet", 1e-3, 1e-6)]
EXEC_CASES = [(case, fid) for case in EXEC_GRID for fid in FIDELITY_GRID
              if not (fid[0] == "analytic" and case[3] is not None)]


@pytest.mark.parametrize("case,fid", EXEC_CASES,
                         ids=[f"{_grid_id(c)}-{f[0]}-{f[1]}-{f[2]}" for c, f in EXEC_CASES])
def test_allreduce_execute_matches_reference(case, fid):
    builder, args, kw, fab_spec = case
    fidelity, loss, jitter = fid
    topos = fabrics(fab_spec[0], *fab_spec[1], **fab_spec[2]) if fab_spec else (None, None)
    got, want, rng_t, rng_r = run_both(builder, args, kw, fidelity=fidelity, topos=topos,
                                       loss=loss, fab=dict(jitter=jitter), seed=len(args))
    assert_run_same(got, want, rng_t, rng_r, f"{builder}{args} {fidelity} loss={loss}")
    if fidelity != "analytic" and fab_spec is not None:
        assert got.link_bytes
    if fidelity == "packet" and "segments" not in kw and args[2]:
        assert got.ag.completed


def test_allreduce_packet_options_reach_the_allgather_leg():
    """``dpa_fidelity="event"`` with ``dpa=``, ``aggregate_nacks`` and
    ``max_rounds`` go to the multicast AG leg (every segment's), as in the
    reference; a ring AG leg refuses them."""
    opts = dict(dpa_fidelity="event", dpa=(dpa.DpaConfig("UD", 16), ref_dpa.DpaConfig("UD", 16)),
                aggregate_nacks=False, max_rounds=3)
    for builder, args, kw in (("build_allreduce", (8, 1 << 19, 4), {}),
                              ("build_pipelined_allreduce", (8, 1 << 19, 8), dict(n_segments=2))):
        got, want, rng_t, rng_r = run_both(builder, args, kw, fidelity="packet", loss=0.01,
                                           fab=dict(), seed=5, opts=opts)
        assert_run_same(got, want, rng_t, rng_r, builder)
    with pytest.raises(ValueError):
        sched_ir.execute(sched_ir.build_allreduce(8, 1 << 16), fidelity="packet",
                         device="cpu", max_rounds=2)
    with pytest.raises(NotImplementedError):
        sched_ir.execute(sched_ir.build_allreduce(8, 1 << 16, 8), fidelity="packet",
                         device="cpu", engine="reference")


def test_allreduce_bytes_compose_rs_and_ag():
    """tests/test_sched_ir.py:149, in the port and equal to the reference."""
    p, n = 8, 1 << 20
    got, want, rng_t, rng_r = run_both("build_allreduce", (p, n), dict(m=p), fab=dict())
    assert_run_same(got, want, rng_t, rng_r)
    assert got.bytes_total == got.rs.bytes_total + got.ag.bytes_total
    assert got.time == got.rs_time + got.ag_time


@pytest.mark.parametrize("p", [4, 16])
@pytest.mark.parametrize("loss", [0.0, 1e-3, 1e-2])
@pytest.mark.parametrize("n_bytes", [1 << 17, 1 << 20])
@pytest.mark.parametrize("m", [None, "full"])
def test_allreduce_fidelity_ordering(p, loss, n_bytes, m):
    """tests/test_sched_ir.py:188, in the port: analytic <= fluid <= packet
    for RS o AG with the ring and the multicast AG, the multicast leg
    running the NACK / retransmission engine under loss; every run equal to
    the reference's."""
    m = p if m == "full" else None
    fab = dict(jitter=0.0)                        # the reference test's FAB
    ana, ref_ana, _, _ = run_both("build_allreduce", (p, n_bytes), dict(m=m),
                                  fidelity="analytic", fab=fab)
    assert ana == ref_ana
    runs = {}
    for name, fid, ls in (("fluid", "fluid", None), ("pkt0", "packet", None),
                          ("pkt", "packet", loss)):
        got, want, rng_t, rng_r = run_both("build_allreduce", (p, n_bytes), dict(m=m),
                                           fidelity=fid, fab=fab, loss=ls)
        assert_run_same(got, want, rng_t, rng_r, f"{name} p={p} m={m} loss={loss}")
        runs[name] = got
    assert ana <= runs["fluid"].time * (1.0 + 1e-12)
    assert runs["fluid"].time == pytest.approx(runs["pkt0"].time, rel=1e-12)
    assert runs["fluid"].time <= runs["pkt"].time * (1.0 + 1e-12)
    shard_chunks = max(n_bytes // p // 4096, 1)
    if m is not None and loss * p * (p - 1) * shard_chunks > 20:
        assert runs["pkt"].ag.recovered > 0


def test_pipelined_allreduce_fidelity_ordering():
    """tests/test_sched_search.py:213 and :224, in the port and equal to the
    reference: four segments lower at all three fidelities in order; one
    segment takes the barrier composition's time."""
    fab = dict(jitter=0.0)
    ana, ref_ana, _, _ = run_both("build_pipelined_allreduce", (8, 4 << 20, 4),
                                  dict(n_segments=4), fidelity="analytic", fab=fab)
    assert ana == ref_ana
    f, rf, rng_t, rng_r = run_both("build_pipelined_allreduce", (8, 4 << 20, 4),
                                   dict(n_segments=4), fab=fab)
    assert_run_same(f, rf, rng_t, rng_r)
    p, rp, rng_t, rng_r = run_both("build_pipelined_allreduce", (8, 4 << 20, 4),
                                   dict(n_segments=4), fidelity="packet", fab=fab)
    assert_run_same(p, rp, rng_t, rng_r)
    assert ana <= f.time + 1e-12 <= p.time + 1e-9
    assert len(f.segments) == 4 and f.bytes_total > 0 and f.rs_time > 0 and f.ag_time > 0
    one, _, _, _ = run_both("build_pipelined_allreduce", (8, 4 << 20, 4), dict(n_segments=1),
                            fab=fab)
    barrier, _, _, _ = run_both("build_allreduce", (8, 4 << 20, 4), {}, fab=fab)
    assert one.time == pytest.approx(barrier.time, rel=1e-12)


def test_analytic_respects_caller_worker_params():
    """tests/test_sched_ir.py:343's Allreduce case: the oracle bounds the
    fluid run for the caller's worker pool too."""
    wk = engine.WorkerParams(n_recv_workers=8, rnr_barrier_hop=0.0)
    fab = engine.FabricParams(jitter=0.0)
    sched = sched_ir.build_allreduce(16, 1 << 16, m=16)
    ana = sched_ir.execute(sched, fab, wk, fidelity="analytic")
    assert ana == ref_ir.execute(ref_ir.build_allreduce(16, 1 << 16, m=16),
                                 ref_engine.FabricParams(jitter=0.0),
                                 ref_engine.WorkerParams(n_recv_workers=8, rnr_barrier_hop=0.0),
                                 fidelity="analytic")
    fl = sched_ir.execute(sched, fab, wk, np.random.default_rng(0), device="cpu")
    assert ana <= fl.time * (1.0 + 1e-12)
    assert math.isfinite(ana) and ana > 0


def test_allreduce_execute_guards():
    sched = sched_ir.build_allreduce(4, 1 << 14, 4)
    topo = topology.FatTree(k=8, n_hosts=4)
    with pytest.raises(ValueError):
        sched_ir.execute(sched, fidelity="analytic", topology=topo)
    with pytest.raises(ValueError):
        sched_ir.execute(sched, fidelity="fluid", loss=0.1, device="cpu")
    with pytest.raises(ValueError):
        sched_ir.execute(sched, fidelity="fluid", device="cpu", dpa_fidelity="event")
