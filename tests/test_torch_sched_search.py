"""The port's schedule searcher (``core/sched_search.py``) and
``sched_ir.autotune_chains`` against the JAX package's, on the CPU: the
candidate spaces, the lower bounds and certificates, ``EvalContext.key()``
(the device left out), the memoized and disk-persisted ``EvalCache``, and
every ``search`` / ``sweep_chains`` / ``autotune_chains`` result field for
field (the table, winner, best builder, certificate, evaluations, cache
hits, pruned and ``packet_validated``; the wall clock aside), on the
abstract fabric, FatTree and Torus2D. Each of the reference's tests of
tests/test_sched_search.py has its counterpart here (the two
``engine=`` tests aside: the per-leaf packet executor is not ported; the
P = 64 search sits in tests/test_torch_search_scale.py), and so do
tests/test_sched_ir.py:319 and :327. ``n_jobs=2`` (the spawn process pool)
equals the serial search bitwise. No wall-clock assert: a loaded CPU
misses any budget. Every comparison is exact.
"""
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import engine as ref_engine
from repro.core import protocol as ref_protocol
from repro.core import sched_ir as ref_ir
from repro.core import sched_search as ref_search
from repro_torch.core import engine, protocol, sched_ir, sched_search
from repro_torch.core.sched_search import EvalCache, EvalContext
from test_torch_allreduce import assert_same, fabrics

FAB, REF_FAB = engine.FabricParams(jitter=0.0), ref_engine.FabricParams(jitter=0.0)
WK, REF_WK = engine.WorkerParams(n_recv_workers=8), ref_engine.WorkerParams(n_recv_workers=8)
P, N = 8, 1 << 20
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _fattree(p=16, oversubscription=4.0):
    return fabrics("FatTree", 8, n_hosts=p, oversubscription=oversubscription)


def _torus(**kw):
    return fabrics("Torus2D", 4, 4, **kw)


TOPOS = {"abstract": lambda: (None, None), "fattree": _fattree, "torus": _torus}


def search_both(collective, p, n, topos=(None, None), caches=(None, None), **kw):
    """(port SearchResult, reference SearchResult), equal field for field
    but the wall clock."""
    got = sched_search.search(collective, p, n, topology=topos[0], cache=caches[0],
                              device="cpu", **kw)
    want = ref_search.search(collective, p, n, topology=topos[1], cache=caches[1], **kw)
    assert_same(got, want, f"{collective} p={p}", skip=("wall_s",))
    return got, want


# ------------------------------------------------------------ the candidates


@pytest.mark.parametrize("collective", sched_search.COLLECTIVES)
def test_candidates_validate_and_are_acyclic(collective):
    """tests/test_sched_search.py:37, in the port; the candidates equal the
    reference's."""
    topo, ref = _fattree()
    cands = sched_search.candidates(collective, P, N, topo)
    assert_same(cands, ref_search.candidates(collective, P, N, ref))
    for cand in cands:
        sched_ir.validate(cand.sched)
        assert sum(len(g) for g in cand.sched.rounds()) == len(cand.sched.ops)
    assert [sched_ir.canonical_key(c.sched) for c in cands] == \
        [ref_ir.canonical_key(c.sched) for c in ref_search.candidates(collective, P, N, ref)]


@pytest.mark.parametrize("collective", sched_search.COLLECTIVES)
def test_candidates_lower_at_all_three_fidelities(collective):
    """tests/test_sched_search.py:45, in the port: one generator carried
    through every candidate's fluid and packet runs, each run equal to the
    reference's."""
    rng, ref_rng = np.random.default_rng(0), np.random.default_rng(0)
    for cand, ref_cand in zip(sched_search.candidates(collective, P, N, None),
                              ref_search.candidates(collective, P, N, None)):
        a = sched_ir.execute(cand.sched, FAB, WK, fidelity="analytic")
        f = sched_ir.execute(cand.sched, FAB, WK, rng, fidelity="fluid", device="cpu")
        p = sched_ir.execute(cand.sched, FAB, WK, rng, fidelity="packet", device="cpu")
        assert a == ref_ir.execute(ref_cand.sched, REF_FAB, REF_WK, fidelity="analytic")
        assert_same(f, ref_ir.execute(ref_cand.sched, REF_FAB, REF_WK, ref_rng,
                                      fidelity="fluid"), cand.name)
        assert_same(p, ref_ir.execute(ref_cand.sched, REF_FAB, REF_WK, ref_rng,
                                      fidelity="packet"), cand.name)
        assert math.isfinite(a) and a > 0
        assert a <= f.time + 1e-12 <= p.time + 1e-9
    assert rng.random() == ref_rng.random()


def test_chain_candidates_include_divisors_and_cut_derived():
    """tests/test_sched_search.py:55, in the port."""
    topo, ref = _fattree()
    ms = sched_search.chain_candidates(16, topo)
    assert ms == ref_search.chain_candidates(16, ref)
    assert {1, 2, 4, 8, 16} <= set(ms)
    assert any(3 <= m <= 5 for m in ms)
    assert sched_search.chain_candidates(12) == ref_search.chain_candidates(12)


def test_candidates_guard():
    with pytest.raises(ValueError):
        sched_search.candidates("gather", P, N)


# ------------------------------------------------------ bounds, certificates


@pytest.mark.parametrize("fabric", list(TOPOS))
def test_winner_respects_lower_bound_certificate(fabric):
    """tests/test_sched_search.py:67, in the port and equal to the reference."""
    r, _ = search_both("allreduce", P, N, TOPOS[fabric](), validate_packet=False)
    assert r.certificate.bound <= r.winner_time + 1e-12
    assert r.certificate.ratio >= 1.0 - 1e-9
    for row in r.table:
        if row.time is not None:
            assert row.bound <= row.time + 1e-12, row.name


@pytest.mark.parametrize("fabric", ["fattree", "torus"])
def test_cut_lower_bound_admissible_for_builders(fabric):
    """tests/test_sched_search.py:79, in the port: the cut bound equal to
    the reference's and at most every candidate's routed fluid time."""
    topo, ref = TOPOS[fabric]()
    rng = np.random.default_rng(0)
    for cand, ref_cand in zip(sched_search.candidates("allreduce", 16, N, topo),
                              ref_search.candidates("allreduce", 16, N, ref)):
        topo.reset()
        t = sched_ir.execute(cand.sched, FAB, WK, rng, fidelity="fluid", topology=topo,
                             device="cpu").time
        lb = sched_search.cut_lower_bound(cand.sched, topo)
        assert lb == ref_search.cut_lower_bound(ref_cand.sched, ref)
        assert lb <= t + 1e-12, cand.name


def test_lower_bounds_equal_the_reference():
    """``lower_bound`` on every candidate of every collective and fabric."""
    for fabric, make in TOPOS.items():
        topo, ref = make()
        ctx = EvalContext(FAB, WK, topo, None, "fluid", 0, "cpu")
        ref_ctx = ref_search.EvalContext(REF_FAB, REF_WK, ref, None, "fluid", 0)
        for collective in sched_search.COLLECTIVES:
            for cand, ref_cand in zip(sched_search.candidates(collective, 16, N, topo),
                                      ref_search.candidates(collective, 16, N, ref)):
                assert sched_search.lower_bound(cand.sched, ctx) == \
                    ref_search.lower_bound(ref_cand.sched, ref_ctx), (fabric, cand.name)


def test_bound_certificate_ratio_infinite_on_zero_bound():
    """tests/test_sched_search.py:90, in the port."""
    cert = protocol.BoundCertificate("allgather", 2, 1, 0.0, 1.0, "analytic")
    assert math.isinf(cert.ratio)
    ref = ref_protocol.BoundCertificate("allgather", 2, 1, 0.5, 1.0, "analytic")
    assert protocol.BoundCertificate("allgather", 2, 1, 0.5, 1.0, "analytic").ratio == ref.ratio
    with pytest.raises(Exception):
        cert.bound = 1.0                               # frozen


# ---------------------------------------------------------------- outcomes


def test_search_never_loses_to_builders_and_wins_on_fattree():
    """tests/test_sched_search.py:98, in the port and equal to the reference."""
    r, _ = search_both("allreduce", 16, 16 << 20, _fattree(), loss=0.001)
    assert r.searched_vs_best_builder <= 1.0
    assert r.winner_time < r.best_builder_time
    assert r.winner.origin == "derived"
    assert r.packet_validated is True


def test_search_wins_strictly_on_torus():
    """tests/test_sched_search.py:106, in the port and equal to the reference."""
    r, _ = search_both("allreduce", 16, 16 << 20, _torus(), loss=0.001)
    assert r.winner_time < r.best_builder_time
    assert r.packet_validated is True


def test_search_matches_builder_when_space_is_builders_only():
    """tests/test_sched_search.py:114, in the port."""
    r, _ = search_both("broadcast", P, N, validate_packet=False)
    assert r.winner.origin == "builder"
    assert r.searched_vs_best_builder == 1.0
    r, _ = search_both("reduce_scatter", P, N, validate_packet=True, loss=0.01)
    assert r.packet_validated is True


def test_search_table_covers_every_candidate():
    """tests/test_sched_search.py:120, in the port."""
    r, _ = search_both("allreduce", P, N, validate_packet=False)
    assert len(r.table) == r.evaluations + r.pruned
    for row in r.table:
        if row.time is None:
            assert row.bound >= r.winner_time - 1e-12


def test_adding_capacity_never_worsens_searched_time_fattree():
    """tests/test_sched_search.py:135, in the port, one cache each side."""
    caches = (EvalCache(), ref_search.EvalCache())
    thin, _ = search_both("allreduce", 16, 16 << 20, _fattree(), caches, validate_packet=False)
    fat, _ = search_both("allreduce", 16, 16 << 20, _fattree(oversubscription=1.0), caches,
                         validate_packet=False)
    assert fat.winner_time <= thin.winner_time + 1e-12


def test_adding_capacity_never_worsens_searched_time_torus():
    """tests/test_sched_search.py:149, in the port."""
    slow, _ = search_both("allreduce", 16, 16 << 20, _torus(b_link=12.5e9),
                          validate_packet=False)
    fast, _ = search_both("allreduce", 16, 16 << 20, _torus(b_link=25e9),
                          validate_packet=False)
    assert fast.winner_time <= slow.winner_time + 1e-12


# ------------------------------------------------------------------ caches


def test_search_reuses_cache_across_runs():
    """tests/test_sched_search.py:160, in the port; the warm search equal to
    the reference's warm search (its hits included)."""
    caches = (EvalCache(), ref_search.EvalCache())
    r1, _ = search_both("allreduce", P, N, caches=caches, validate_packet=False)
    misses = caches[0].misses
    r2, _ = search_both("allreduce", P, N, caches=caches, validate_packet=False)
    assert caches[0].misses == misses
    assert r2.cache_hits == r2.evaluations
    assert r1.winner_time == r2.winner_time
    assert (caches[0].hits, caches[0].misses) == (caches[1].hits, caches[1].misses)


def test_eval_context_key_is_the_references_and_leaves_out_the_device():
    topo, ref = _fattree()
    for args in [(), (topo, None, "fluid", 3), (topo, tuple(range(16)), "analytic", 0),
                 (None, (1, 2), "fluid", 1)]:
        ref_args = tuple(ref if a is topo else a for a in args)
        want = ref_search.EvalContext(REF_FAB, REF_WK, *ref_args).key()
        keys = {EvalContext(FAB, WK, *args).key()}
        if args:
            keys |= {EvalContext(FAB, WK, *args, device=d).key()
                     for d in ("cpu", "cuda", torch.device("cpu"))}
        assert keys == {want}


def test_eval_cache_keeps_the_searched_space():
    """``EvalCache.space`` builds a fabric shape's candidates once (the
    reference's candidates, the same objects on a rerun), anew for another
    cache, another shape or other move generators, and each time for a
    fabric keyed by identity; a warm search takes the kept space."""
    topo, ref = _fattree()
    cache = EvalCache()
    first = cache.space("allreduce", 16, N, topo)
    assert_same(first, ref_search.candidates("allreduce", 16, N, ref))
    again = cache.space("allreduce", 16, N, _fattree()[0])
    assert all(a is b for a, b in zip(first, again)) and len(first) == len(again)
    assert all(a is not b for a, b in zip(first, EvalCache().space("allreduce", 16, N, topo)))
    assert cache.space("allgather", 16, N, topo)[0] is not first[0]

    class Opaque:
        supports_packet = False

        def reset(self):
            pass

    opaque = Opaque()
    assert cache.space("broadcast", 8, N, opaque)[0] is not \
        cache.space("broadcast", 8, N, opaque)[0]
    sched_search.search("allreduce", 16, N, topology=topo, validate_packet=False, cache=cache,
                        device="cpu")
    assert all(getattr(c.sched, "_validated", False) for c in cache.space("allreduce", 16, N,
                                                                          topo))


def test_cache_key_separates_contexts():
    """tests/test_sched_search.py:170, in the port."""
    cache = EvalCache()
    sched = sched_ir.build_allgather(P, N, 2)
    t_a = cache.evaluate(sched, EvalContext(FAB, WK, device="cpu")).time
    t_b = cache.evaluate(sched, EvalContext(FAB, engine.WorkerParams(n_recv_workers=1),
                                            device="cpu")).time
    assert cache.misses == 2 and t_a != t_b
    ref = ref_search.EvalCache()
    assert t_b == ref.evaluate(ref_ir.build_allgather(P, N, 2),
                               ref_search.EvalContext(REF_FAB,
                                                      ref_engine.WorkerParams(n_recv_workers=1))
                               ).time


def test_canonical_key_content_addressed():
    """tests/test_sched_search.py:180, in the port."""
    a, b, c = (sched_ir.build_allgather(P, N, m) for m in (2, 2, 4))
    assert sched_ir.canonical_key(a) == sched_ir.canonical_key(b)
    assert sched_ir.canonical_key(a) != sched_ir.canonical_key(c)
    assert sched_ir.canonical_key(c) == ref_ir.canonical_key(ref_ir.build_allgather(P, N, 4))


def _result_fields(r):
    return (r.winner.name, r.winner_time, r.winner_fabric_bytes, r.best_builder.name,
            r.best_builder_time, r.evaluations, r.cache_hits, r.pruned,
            [(c.name, c.origin, c.bound, c.time, c.fabric_bytes) for c in r.table])


def test_parallel_search_bitwise_identical_to_serial(monkeypatch):
    """tests/test_sched_search.py:299, in the port: ``n_jobs=2`` (a spawn
    pool of two children on the CPU) equals the serial search and the
    reference's, field for field."""
    monkeypatch.delenv("REPRO_SEARCH_WORKERS", raising=False)
    topo, ref = _fattree()
    serial = sched_search.search("allgather", 16, N, topology=topo, hosts=list(range(16)),
                                 validate_packet=False, device="cpu")
    prefetched = []
    real = sched_search._prefetch_parallel

    def spy(*args, **kw):
        out = real(*args, **kw)
        prefetched.append(len(out))              # the replay pops the dict empty
        return out

    monkeypatch.setattr(sched_search, "_prefetch_parallel", spy)
    par = sched_search.search("allgather", 16, N, topology=topo, hosts=list(range(16)),
                              validate_packet=False, n_jobs=2, device="cpu")
    assert len(prefetched) == 1 and prefetched[0] > 0   # the children evaluated candidates
    assert _result_fields(par) == _result_fields(serial)
    assert_same(par, serial, skip=("wall_s",))
    assert_same(par, ref_search.search("allgather", 16, N, topology=ref, hosts=list(range(16)),
                                       validate_packet=False), skip=("wall_s",))


def test_search_workers_env_opt_in(monkeypatch):
    """tests/test_sched_search.py:308, in the port."""
    monkeypatch.delenv("REPRO_SEARCH_WORKERS", raising=False)
    serial = sched_search.search("allreduce", P, N, validate_packet=False, device="cpu")
    monkeypatch.setenv("REPRO_SEARCH_WORKERS", "2")
    par = sched_search.search("allreduce", P, N, validate_packet=False, device="cpu")
    assert _result_fields(par) == _result_fields(serial)


def test_eval_cache_persists_across_processes_keyspace(tmp_path, monkeypatch):
    """tests/test_sched_search.py:317, in the port: a fresh cache on the
    file serves every evaluation of a rerun from disk; the file is the
    reference's format, so the reference's cache reads it and serves its
    rerun from it too."""
    monkeypatch.delenv("REPRO_EVAL_CACHE", raising=False)
    path = str(tmp_path / "evals.json")
    topo, ref = _fattree()
    r1 = sched_search.search("allgather", 16, N, topology=topo, hosts=list(range(16)),
                             validate_packet=False, cache=EvalCache(path), device="cpu")
    warm = EvalCache(path)
    r2 = sched_search.search("allgather", 16, N, topology=topo, hosts=list(range(16)),
                             validate_packet=False, cache=warm, device="cpu")
    assert warm.misses == 0
    assert r2.cache_hits == r2.evaluations
    assert r2.winner_time == r1.winner_time and r2.winner.name == r1.winner.name
    ref_warm = ref_search.EvalCache(path)
    r3 = ref_search.search("allgather", 16, N, topology=ref, hosts=list(range(16)),
                           validate_packet=False, cache=ref_warm)
    assert ref_warm.misses == 0
    assert_same(r2, r3, skip=("wall_s",))


def test_eval_cache_never_persists_identity_keyed_topologies(tmp_path):
    """tests/test_sched_search.py:333, in the port."""
    class Opaque:
        supports_packet = False

        def reset(self):
            pass

    path = str(tmp_path / "evals.json")
    cache = EvalCache(path)
    sched = sched_ir.build_allgather(P, N, 2)
    cache.evaluate(sched, EvalContext(FAB, WK, device="cpu"))
    with pytest.raises(Exception):
        cache.evaluate(sched, EvalContext(FAB, WK, Opaque(), device="cpu"))
    cache.save()
    reread = EvalCache(path)
    assert all("'id'" not in k for k in reread._disk)
    assert len(reread._disk) >= 1
    with open(path) as f:
        assert json.load(f)["version"] == 1


def test_eval_cache_survives_corrupt_file(tmp_path):
    """tests/test_sched_search.py:357, in the port."""
    path = tmp_path / "evals.json"
    for bad in ("{not json", json.dumps({"version": 2, "entries": {}})):
        path.write_text(bad)
        cache = EvalCache(str(path))
        assert len(cache._disk) == 0
        cache.evaluate(sched_ir.build_allgather(P, N, 2), EvalContext(FAB, WK, device="cpu"))
        cache.save()
        assert len(EvalCache(str(path))._disk) == 1
    assert not [f for f in os.listdir(tmp_path) if ".tmp." in f]   # the write was atomic


def test_eval_cache_persistent_classmethod(tmp_path, monkeypatch):
    """tests/test_sched_search.py:368, in the port."""
    monkeypatch.delenv("REPRO_EVAL_CACHE", raising=False)
    assert EvalCache.persistent().path is None
    p = str(tmp_path / "c.json")
    monkeypatch.setenv("REPRO_EVAL_CACHE", p)
    cache = EvalCache.persistent()
    assert cache.path == p
    cache.evaluate(sched_ir.build_allgather(P, N, 2), EvalContext(FAB, WK, device="cpu"))
    cache.save()
    assert EvalCache.persistent().misses == 0


def test_sweep_chains_saves_shared_cache(tmp_path):
    """tests/test_sched_search.py:381, in the port and equal to the reference."""
    path = str(tmp_path / "evals.json")
    best, times = sched_search.sweep_chains(
        sched_ir.build_allgather, p=P, n_bytes=N, fabric=FAB, workers=WK,
        candidates=[1, 2, 4], cache=EvalCache(path), device="cpu")
    assert (best, times) == ref_search.sweep_chains(
        ref_ir.build_allgather, p=P, n_bytes=N, fabric=REF_FAB, workers=REF_WK,
        candidates=[1, 2, 4])
    warm = EvalCache(path)
    best2, times2 = sched_search.sweep_chains(
        sched_ir.build_allgather, p=P, n_bytes=N, fabric=FAB, workers=WK,
        candidates=[1, 2, 4], cache=warm, device="cpu")
    assert warm.misses == 0 and (best2, times2) == (best, times)


# ----------------------------------------------------------------- autotune


def _autotune_both(topos=(None, None), caches=(None, None), **kw):
    got = sched_ir.autotune_chains(sched_ir.build_allgather, topos[0], cache=caches[0],
                                   device="cpu", **kw)
    want = ref_ir.autotune_chains(ref_ir.build_allgather, topos[1], cache=caches[1], **kw)
    assert got == want and all(type(got[1][m]) is type(want[1][m]) for m in want[1])
    return got


def test_autotune_chains_shares_cache_and_returns_full_sweep():
    """tests/test_sched_search.py:188, in the port."""
    cache = EvalCache()
    best, times = _autotune_both(p=P, n_bytes=N, caches=(cache, ref_search.EvalCache()))
    assert set(times) == {m for m in range(1, P + 1) if P % m == 0}
    assert best == min(times, key=lambda m: (times[m], m))
    assert sched_ir.autotune_chains(sched_ir.build_allgather, p=P, n_bytes=N, cache=cache,
                                    device="cpu") == (best, times)
    assert cache.hits == len(times)


def test_autotune_chains_matches_direct_execution():
    """tests/test_sched_search.py:200, in the port."""
    _, times = _autotune_both(p=P, n_bytes=N)
    for m, t in times.items():
        direct = sched_ir.execute(sched_ir.build_allgather(P, N, m), FAB, WK,
                                  np.random.default_rng(0), fidelity="fluid", device="cpu")
        assert t == direct.time


def test_autotune_chains_prefers_full_parallelism_on_flat_fabric():
    """tests/test_sched_ir.py:319, in the port."""
    fab, ref_fab = engine.FabricParams(jitter=0.0), ref_engine.FabricParams(jitter=0.0)
    best, times = sched_ir.autotune_chains(sched_ir.build_allgather, p=16, n_bytes=1 << 18,
                                           fabric=fab, workers=WK, device="cpu")
    assert (best, times) == ref_ir.autotune_chains(ref_ir.build_allgather, p=16,
                                                   n_bytes=1 << 18, fabric=ref_fab,
                                                   workers=REF_WK)
    assert best == 16
    assert set(times) == {1, 2, 4, 8, 16}
    assert times[16] <= min(times.values()) + 1e-18


def test_autotune_chains_routed_and_analytic():
    """tests/test_sched_ir.py:327, in the port."""
    topos = fabrics("FatTree", k=8, n_hosts=16, b_host=FAB.b_link)
    best, times = _autotune_both(p=16, n_bytes=1 << 18, topos=topos, fabric=FAB, workers=WK,
                                 candidates=(2, 4, 16))
    assert best in (2, 4, 16) and len(times) == 3
    best_a, _ = _autotune_both(p=16, n_bytes=1 << 18, fabric=FAB, workers=WK,
                               fidelity="analytic")
    assert best_a == 16
    thin = fabrics("FatTree", k=8, n_hosts=16, b_host=FAB.b_link, oversubscription=4.0)
    _autotune_both(p=16, n_bytes=1 << 18, topos=thin, fabric=FAB, workers=WK)


# ----------------------------------------------------------- the port's rules


def test_search_entry_points_default_to_cuda():
    """Without device= they run on CUDA, and raise without a card."""
    calls = [lambda: sched_search.search("allreduce", 4, 1 << 16, validate_packet=False),
             lambda: sched_search.sweep_chains(sched_ir.build_allgather, p=4, n_bytes=1 << 16,
                                               fabric=FAB, workers=WK, candidates=[2]),
             lambda: sched_ir.autotune_chains(sched_ir.build_allgather, p=4, n_bytes=1 << 16),
             lambda: sched_ir.execute(sched_ir.build_allreduce(4, 1 << 16, 4)),
             lambda: sched_ir.execute(sched_ir.build_hierarchical_allgather(8, 1 << 16, 2),
                                      fidelity="packet")]
    if torch.cuda.is_available():
        assert sched_search.search("allreduce", 4, 1 << 16, validate_packet=False).evaluations
        return
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_searcher_imports_neither_jax_nor_repro():
    """A search with the spawn pool, an autotune and the profiler, in a
    fresh process, load no jax and no module of the JAX package."""
    code = (
        "import sys\n"
        "from repro_torch.core import profiling, sched_ir, sched_search, topology\n"
        "profiling.enable()\n"
        "r = sched_search.search('allgather', 8, 1 << 16, topology=topology.FatTree(4, 8),\n"
        "                        n_jobs=2, loss=0.01, device='cpu')\n"
        "assert r.packet_validated\n"
        "assert sched_ir.autotune_chains(sched_ir.build_allgather, p=8, n_bytes=1 << 16,\n"
        "                                device='cpu')[0] == 8\n"
        "assert set(profiling.report()) <= set(profiling.PHASES)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
