"""The port's event-level DPA progress engine (``core/dpa_engine.py``)
against the JAX package's, on the CPU: the same seeded traces into both,
every done time bitwise equal, ``n_served`` and ``llc_spill_events`` equal,
and the measured-throughput twins equal.

It also pins, as the port computes it, the one DPA fault of the reference
that the JAX package's own tests show: the event capacity of a UC pool of 17
threads (a partial trailing core of one thread) is 0.694 of ``dpa.pool_tput``,
below the 0.78 band of ``tests/test_dpa_engine.py::
test_capacity_converges_to_pool_tput``.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro.core import dpa as ref_dpa
from repro.core import dpa_engine as ref_de
from repro_torch.core import dpa, dpa_engine as de


def _params(name):
    """The same hardware description built in both packages."""
    def build(mod, dmod):
        if name == "ud16":
            return mod.EventDpaParams.from_table1("UD", 16)
        if name == "uc5":
            return mod.EventDpaParams.from_table1("UC", 5)
        if name == "ud40":
            return mod.EventDpaParams.from_table1("UD", 40)
        if name == "config":
            return mod.EventDpaParams.from_dpa_config(dmod.DpaConfig("UC", 24, 8192))
        if name == "host":
            return mod.EventDpaParams.host_cpu(2)
        if name == "host_rc":
            return mod.EventDpaParams.host_cpu(3, "RC_no_reliability")
        if name == "zero":
            return mod.EventDpaParams.zero_cost(8)
        if name == "spill":
            # a small LLC and a steep penalty: the occupancy term bites
            return dataclasses.replace(mod.EventDpaParams.from_table1("UD", 6),
                                       llc_bytes=64 * 1024.0, llc_penalty=2.5)
        if name == "nocap":
            return mod.EventDpaParams(n_threads=7, threads_per_core=3, freq_hz=1.1e9,
                                      cycles_compute=90.0, cycles_stall=700.0,
                                      mem_contention=0.3, core_cap_msgs=None)
        raise KeyError(name)
    return build(de, dpa), build(ref_de, ref_dpa)


PARAMS = ["ud16", "uc5", "ud40", "config", "host", "host_rc", "zero", "spill", "nocap"]


@pytest.mark.parametrize("name", PARAMS)
def test_params_match_reference(name):
    got, want = _params(name)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    assert got.n_cores == want.n_cores
    assert [got.threads_on_core(c) for c in range(got.n_cores + 1)] == \
        [want.threads_on_core(c) for c in range(want.n_cores + 1)]
    for kind, wire in (("data", None), ("nack", 4096 + 32), ("nack", 9000), ("retx", None)):
        assert got.service_cycles(kind, wire) == want.service_cycles(kind, wire)
    with pytest.raises(ValueError):
        got.service_cycles("probe")
    with pytest.raises(ValueError):
        got.service_cycles("nack")


def _trace(rng, n, rate):
    """Sorted arrivals: a Poisson stream at ``rate`` with bursts of ties."""
    gaps = rng.exponential(1.0 / rate, n)
    gaps[rng.random(n) < 0.2] = 0.0
    return np.cumsum(gaps)


@pytest.mark.parametrize("name", PARAMS)
@pytest.mark.parametrize("seed", [0, 1])
def test_service_batches_match_reference(name, seed):
    """Several batches of data, NACK and retransmit items on one persistent
    pool (each batch later than the last, as the simulators submit them),
    at paced and saturating rates: done arrays bitwise, counters equal."""
    got_p, want_p = _params(name)
    a, b = de.DpaEventPool(got_p), ref_de.DpaEventPool(want_p)
    rng = np.random.default_rng(seed)
    t = 0.0
    for kind, wire, n, rate, chunk in (("data", None, 3000, 5e6, 4096),
                                       ("nack", 4096 + 512, 3, 1e6, 4608),
                                       ("retx", None, 200, 0.0, 4096),
                                       ("data", None, 500, 1e9, 64),
                                       ("data", None, 0, 1e6, 4096),
                                       ("data", None, 1200, 2e7, 16384)):
        arr = np.full(n, t) if rate == 0.0 else t + _trace(rng, n, rate)
        got = a.service_batch(arr, chunk, kind=kind, wire_bytes=wire)
        want = b.service_batch(arr, chunk, kind=kind, wire_bytes=wire)
        assert got.dtype == want.dtype and np.array_equal(got, want), (name, kind)
        assert (a.n_served, a.llc_spill_events) == (b.n_served, b.llc_spill_events)
        t = float(arr[-1]) if n else t
    if name == "spill":
        assert a.llc_spill_events > 0
    if name == "zero":
        assert a.llc_spill_events == 0


@pytest.mark.parametrize("name", ["ud16", "host", "spill"])
def test_service_with_rnr_matches_reference(name):
    got_p, want_p = _params(name)
    a, b = de.DpaEventPool(got_p), ref_de.DpaEventPool(want_p)
    rng = np.random.default_rng(5)
    arr = _trace(rng, 4000, 5e7)                 # faster than the pool: the ring overflows
    psns = rng.permutation(4000)
    drops = 0
    for staging in (64, 1024, 8192):
        t_got, rnr_got = a.service_with_rnr(arr, psns, 4096, staging)
        t_want, rnr_want = b.service_with_rnr(arr, psns, 4096, staging)
        assert t_got == t_want and np.array_equal(rnr_got, rnr_want)
        drops += rnr_got.size
        arr = arr + float(arr[-1])
    assert drops
    t_got, rnr_got = a.service_with_rnr(arr[:0], psns[:0], 4096, 64)
    t_want, rnr_want = b.service_with_rnr(arr[:0], psns[:0], 4096, 64)
    assert t_got is t_want is None and rnr_got.size == rnr_want.size == 0


def test_resolve_event_params_matches_reference():
    for n in (1, 8, 16):
        assert dataclasses.astuple(de.resolve_event_params(None, n)) == \
            dataclasses.astuple(ref_de.resolve_event_params(None, n))
    p = de.EventDpaParams.host_cpu(3)
    assert de.resolve_event_params(p, 4) is p
    assert dataclasses.astuple(de.resolve_event_params(dpa.DpaConfig("UC", 9), 4)) == \
        dataclasses.astuple(ref_de.resolve_event_params(ref_dpa.DpaConfig("UC", 9), 4))
    with pytest.raises(TypeError):
        de.resolve_event_params(object(), 4)
    assert de.DPA_FIDELITIES == ref_de.DPA_FIDELITIES
    assert de.RETX_POST_FRAC == ref_de.RETX_POST_FRAC
    with pytest.raises(ValueError):
        de.EventDpaParams(n_threads=0)


# ---------------------------------------------------- the measured twins


@pytest.mark.parametrize("transport", ["UD", "UC"])
def test_throughput_twins_match_reference(transport):
    """The twins that ``paper_figs.dpa_scaling_sweep`` reads, at Figs. 13 and
    14's thread counts and the full-core anchors."""
    for n in (1, 2, 4, 8, 16, 17, 32):
        got, want = (de.EventDpaParams.from_table1(transport, n),
                     ref_de.EventDpaParams.from_table1(transport, n))
        assert de.pool_tput_event(got) == ref_de.pool_tput_event(want)
        assert de.pool_tput_event(got, chunk_bytes=64, n_chunks=900) == \
            ref_de.pool_tput_event(want, chunk_bytes=64, n_chunks=900)
        assert de.sustained_tput_event(got) == ref_de.sustained_tput_event(want)
        assert de.sustained_tput_event(got, dpa.LINK_1600G_BYTES, chunk_bytes=8192) == \
            ref_de.sustained_tput_event(want, ref_dpa.LINK_1600G_BYTES, chunk_bytes=8192)
    assert de.threads_to_saturate_event(transport) == ref_de.threads_to_saturate_event(transport)
    for cores in (1, 2, 4):
        assert de.pool_tput_event(de.EventDpaParams.host_cpu(cores)) == \
            ref_de.pool_tput_event(ref_de.EventDpaParams.host_cpu(cores))


def test_fig16_twins_match_reference():
    need = dpa.link_chunk_arrival_rate(dpa.LINK_1600G_BYTES)
    for n in (8, 64, 128):
        got = de.sustained_chunk_rate_event(de.EventDpaParams.from_table1("UD", n), need)
        want = ref_de.sustained_chunk_rate_event(ref_de.EventDpaParams.from_table1("UD", n),
                                                 need)
        assert got == want
        assert de.tbit_feasible_event("UD", n) == ref_de.tbit_feasible_event("UD", n)
    # the zero-cost pool keeps up with any rate (its steady span is the trace's)
    assert de.sustained_chunk_rate_event(de.EventDpaParams.zero_cost(4), 1e9) == \
        ref_de.sustained_chunk_rate_event(ref_de.EventDpaParams.zero_cost(4), 1e9) == 1e9
    assert de.tbit_feasible_event("UD", 128) and not de.tbit_feasible_event("UD", 8)
    assert de.threads_to_saturate_event("UC") <= 4
    assert 8 <= de.threads_to_saturate_event("UD") <= 16


def test_uc17_capacity_ratio_mirrors_the_reference():
    """Mirrored, not fixed: static round-robin dispatch under-serves a
    partial trailing core, so a UC pool of 17 threads (16 + 1) measures 0.694
    of the analytic oracle, below the reference test's 0.78 band (which
    fails on this stored example). The port computes the reference's
    number; see ROADMAP.md §3."""
    ev = de.pool_tput_event(de.EventDpaParams.from_table1("UC", 17))
    an = dpa.pool_tput(dpa.DpaConfig("UC", 17))
    ref = ref_de.pool_tput_event(ref_de.EventDpaParams.from_table1("UC", 17)) / \
        ref_dpa.pool_tput(ref_dpa.DpaConfig("UC", 17))
    assert ev / an == ref
    assert round(ev / an, 3) == 0.694 and ev / an < 0.78
    # full cores sit on the oracle (the reference's anchors, within 10 %)
    for t in (16, 32, 64):
        ratio = de.pool_tput_event(de.EventDpaParams.from_table1("UC", t)) / \
            dpa.pool_tput(dpa.DpaConfig("UC", t))
        assert math.isclose(ratio, 1.0, rel_tol=0.10), (t, ratio)
