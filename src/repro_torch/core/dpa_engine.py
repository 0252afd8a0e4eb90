"""Event-level DPA progress-engine simulator (paper §II-C, §VI-C, Figs 13-16).

Port of ``src/repro/core/dpa_engine.py``, in numpy on the host as the
reference keeps it: the same recurrences in the same order, so every done
time is bitwise the reference's.

``core/dpa.py`` models the DPA worker pool as closed-form throughput curves
(``pool_tput``: the Table-I single-thread rate x a T^e multithread envelope
x a per-core cap). This module simulates the same hardware CQE by CQE:

  - N RISC-V cores x M hardware thread contexts. CQEs are dispatched
    round-robin over the contexts (compact placement: core 1 fills before
    core 2, §VI-C), each context owning a DMA/doorbell queue (its
    ``thread_free`` horizon).
  - A CQE's service is split into compute cycles and stalled-on-memory
    cycles (``dpa.cqe_service_cycles``: the Table-I throughput anchor sized
    by the measured IPC ~ 0.1). Compute serializes on the core's single
    issue pipeline; stalls overlap other contexts' compute. Contexts sharing
    a core inflate each other's stalls by ``dpa.MEM_CONTENTION`` per
    co-resident context.
  - Each core's NIC-engine interface ingests CQEs at most at
    ``dpa.CORE_CAP_CHUNKS_PER_S`` (8 cores = 128 threads are exactly a
    1.6 Tbit/s arrival rate, Fig 16).
  - An LLC-occupancy term (a heap of in-flight items) degrades service while
    outstanding chunk state exceeds the 1.5 MB LLC (``dpa.LLC_MISS_PENALTY``
    on the stall component).
  - Work is typed: data CQEs, NACK messages (bitmap streaming, scaled by
    wire bytes) and retransmit-post items run on the same contexts, so
    protocol work steals cycles from the receive datapath.
  - ``EventDpaParams.host_cpu`` is the host baseline: 1-4 Epyc-class cores,
    one context per core, nothing hides the stalls (Fig 5).

Each pool is a sequential recurrence per context with a shared LLC heap;
it runs on the host, one Python step a work item, in the packet
simulators' ``dpa_fidelity="event"`` mode (``core/packet.py``,
``core/sched_ir._packet_allgather``). ``core/dpa.py`` stays the
cross-check oracle of the measured twins below.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, replace

import numpy as np

from repro_torch.core import dpa as dpa_model
from repro_torch.core.engine import staging_rnr_mask

#: send-side retransmit posting (WQE build + doorbell) as a fraction of a
#: data CQE: no payload staging or reassembly bookkeeping, the RDMA engine
#: reads the user buffer directly (§III-A zero-copy)
RETX_POST_FRAC = 0.25

DPA_FIDELITIES = ("scalar", "event")


@dataclass(frozen=True)
class EventDpaParams:
    """Hardware description consumed by ``DpaEventPool``. Build it with
    ``from_table1`` (the calibrated BF-3 DPA), ``host_cpu`` (the Epyc
    baseline) or ``zero_cost`` (the degenerate exactness config)."""
    transport: str = "UD"
    n_threads: int = 16
    threads_per_core: int = dpa_model.DPA_THREADS_PER_CORE
    freq_hz: float = dpa_model.DPA_FREQ_HZ
    cycles_compute: float = 0.0
    cycles_stall: float = 0.0
    mem_contention: float = 0.0          # stall inflation per co-resident context
    core_cap_msgs: float | None = dpa_model.CORE_CAP_CHUNKS_PER_S
    llc_bytes: float = dpa_model.DPA_LLC_BYTES
    llc_penalty: float = dpa_model.LLC_MISS_PENALTY
    ref_bytes: int = dpa_model.REF_CHUNK_BYTES   # byte-scaled work reference

    def __post_init__(self):
        if not (self.n_threads >= 1 and self.threads_per_core >= 1):
            raise ValueError(f"need n_threads >= 1 and threads_per_core >= 1, got "
                             f"{self.n_threads}, {self.threads_per_core}")
        if not (self.cycles_compute >= 0 and self.cycles_stall >= 0):
            raise ValueError(f"cycles must be >= 0, got {self.cycles_compute}, "
                             f"{self.cycles_stall}")
        if not (self.mem_contention >= 0 and self.llc_penalty >= 1.0):
            raise ValueError(f"need mem_contention >= 0 and llc_penalty >= 1, got "
                             f"{self.mem_contention}, {self.llc_penalty}")

    @classmethod
    def from_table1(cls, transport: str = "UD", n_threads: int = 16) -> "EventDpaParams":
        comp, stall = dpa_model.cqe_service_cycles(transport)
        return cls(transport=transport, n_threads=n_threads, cycles_compute=comp,
                   cycles_stall=stall, mem_contention=dpa_model.MEM_CONTENTION[transport])

    @classmethod
    def from_dpa_config(cls, cfg: dpa_model.DpaConfig) -> "EventDpaParams":
        """The event twin of a ``DpaConfig`` (the chunk size is per CQE in
        the event engine, so only the transport and threads carry over)."""
        return cls.from_table1(cfg.transport, cfg.n_threads)

    @classmethod
    def host_cpu(cls, n_cores: int = 2, datapath: str = "UD_reliability") -> "EventDpaParams":
        """Fig 5 host baseline: Epyc-class cores, one context each; the
        stalls are exposed, no NIC-interface cap, no DPA LLC model."""
        comp, stall = dpa_model.host_cqe_service_cycles(datapath)
        return cls(transport=datapath, n_threads=n_cores, threads_per_core=1,
                   freq_hz=dpa_model.CPU_FREQ_HZ, cycles_compute=comp, cycles_stall=stall,
                   mem_contention=0.0, core_cap_msgs=None, llc_bytes=math.inf)

    @classmethod
    def zero_cost(cls, n_threads: int = 16) -> "EventDpaParams":
        """A free progress engine: every CQE completes at its arrival."""
        return cls(n_threads=n_threads, cycles_compute=0.0, cycles_stall=0.0,
                   mem_contention=0.0, core_cap_msgs=None, llc_bytes=math.inf)

    @property
    def n_cores(self) -> int:
        return -(-self.n_threads // self.threads_per_core)

    def threads_on_core(self, core: int) -> int:
        full, rem = divmod(self.n_threads, self.threads_per_core)
        if core < full:
            return self.threads_per_core
        return rem

    def service_cycles(self, kind: str = "data",
                       wire_bytes: int | None = None) -> tuple[float, float]:
        """(compute, stall) cycles of one work item: ``data`` one receive CQE;
        ``nack`` one (aggregated) NACK, a CQE scaled by ``wire_bytes /
        ref_bytes`` (streaming the packed bitmap); ``retx`` posting one
        retransmit WQE, ``RETX_POST_FRAC`` of a CQE."""
        c, s = self.cycles_compute, self.cycles_stall
        if kind == "data":
            return c, s
        if kind == "nack":
            if wire_bytes is None:
                raise ValueError("a nack item needs wire_bytes")
            scale = wire_bytes / self.ref_bytes
            return c * scale, s * scale
        if kind == "retx":
            return c * RETX_POST_FRAC, s * RETX_POST_FRAC
        raise ValueError(f"unknown work kind: {kind}")


class DpaEventPool:
    """One NIC's DPA progress engine, persistent across service batches, so
    protocol work (NACK service, retransmit posting) steals cycles from the
    data CQEs that land on the same contexts later.

    ``service_batch`` simulates a batch item by item:

        ingest  = max(arrival, core NIC-interface pacing)     # per-core cap
        start   = max(ingest, context's doorbell-queue horizon)
        compute = serialized on the core's issue pipeline     # C cycles
        stall   = overlapped, inflated by co-resident contexts and by LLC
                  overflow of outstanding chunk state         # S cycles
        done    = compute_end + stall

    Every submitted item gets exactly one done time; ``n_served`` counts
    them, ``llc_spill_events`` the items served with the LLC overflowed."""

    def __init__(self, params: EventDpaParams, t0: float = 0.0):
        self.params = p = params
        self._thread_free = [t0] * p.n_threads
        self._pipe_free = [t0] * p.n_cores
        self._ingest_next = [t0] * p.n_cores
        self._contention = [1.0 + p.mem_contention * (p.threads_on_core(c) - 1)
                            for c in range(p.n_cores)]
        self._inflight: list[tuple[float, float]] = []   # (done, bytes) heap
        self._inflight_bytes = 0.0
        self.n_served = 0
        self.llc_spill_events = 0

    def service_batch(self, arrivals: np.ndarray, chunk_bytes: float, *, kind: str = "data",
                      wire_bytes: int | None = None) -> np.ndarray:
        """Done times of a sorted batch of arrivals (one work item each).
        The reference's loop with the arrivals as Python floats: the same
        IEEE double operations in the same order."""
        p = self.params
        arr = np.asarray(arrivals, dtype=float)
        n = int(arr.shape[0])
        if n == 0:
            return np.empty(0)
        comp_cyc, stall_cyc = p.service_cycles(kind, wire_bytes)
        comp_s = comp_cyc / p.freq_hz
        inv_cap = 0.0 if p.core_cap_msgs is None else 1.0 / p.core_cap_msgs
        tpc, n_threads, freq = p.threads_per_core, p.n_threads, p.freq_hz
        llc, penalty = p.llc_bytes, p.llc_penalty
        track_llc = math.isfinite(llc)
        thread_free, pipe_free, ingest_next = (self._thread_free, self._pipe_free,
                                               self._ingest_next)
        stall_of = [stall_cyc * k / freq for k in self._contention]
        inflight = self._inflight
        inflight_bytes = self._inflight_bytes
        spills = 0
        bytes_f = float(chunk_bytes)
        heappush, heappop = heapq.heappush, heapq.heappop
        out = [0.0] * n
        for k, a in enumerate(arr.tolist()):
            j = k % n_threads
            c = j // tpc
            if track_llc:
                while inflight and inflight[0][0] <= a:
                    inflight_bytes -= heappop(inflight)[1]
            if inv_cap:
                t_in = a if a >= ingest_next[c] else ingest_next[c]
                ingest_next[c] = t_in + inv_cap
            else:
                t_in = a
            tf = thread_free[j]
            start = t_in if t_in >= tf else tf
            pf = pipe_free[c]
            comp_end = (start if start >= pf else pf) + comp_s
            pipe_free[c] = comp_end
            stall_s = stall_of[c]
            if track_llc and inflight_bytes + chunk_bytes > llc:
                stall_s *= penalty
                spills += 1
            t_done = comp_end + stall_s
            thread_free[j] = t_done
            if track_llc:
                heappush(inflight, (t_done, bytes_f))
                inflight_bytes += chunk_bytes
            out[k] = t_done
        self._inflight_bytes = inflight_bytes
        self.llc_spill_events += spills
        self.n_served += n
        return np.array(out)

    def service_with_rnr(self, arrivals: np.ndarray, psns: np.ndarray, chunk_bytes: float,
                         staging: int, *, kind: str = "data", wire_bytes: int | None = None):
        """(t_last, rnr_psns) under the staging ring's overflow rule
        (``engine.staging_rnr_mask``). t_last is the latest done time: on a
        persistent pool the last arrival is not always the last to finish.
        (None, no PSNs) for an empty batch."""
        done = self.service_batch(arrivals, chunk_bytes, kind=kind, wire_bytes=wire_bytes)
        if done.shape[0] == 0:
            return None, psns[:0]
        rnr_psns = psns[staging_rnr_mask(done, np.asarray(arrivals, dtype=float), staging)]
        return float(done.max()), rnr_psns


def resolve_event_params(dpa, workers_n_threads: int) -> EventDpaParams:
    """The packet simulators' ``dpa=`` -> EventDpaParams: params pass
    through, a DpaConfig is converted, None gives a Table-I UD pool with as
    many threads as the scalar worker pool."""
    if dpa is None:
        return EventDpaParams.from_table1("UD", workers_n_threads)
    if isinstance(dpa, EventDpaParams):
        return dpa
    if isinstance(dpa, dpa_model.DpaConfig):
        return EventDpaParams.from_dpa_config(dpa)
    raise TypeError(f"dpa= expects EventDpaParams | DpaConfig | None, got {type(dpa).__name__}")


# ------------------------------------------------- measured-throughput twins
#
# The event-engine counterparts of dpa.pool_tput / sustained_tput /
# threads_to_saturate / tbit_feasible: each drives the simulator with a
# trace and measures.


def pool_tput_event(params: EventDpaParams, *, chunk_bytes: int = 4096,
                    n_chunks: int | None = None) -> float:
    """Measured capacity (bytes/s): a saturating all-at-once backlog,
    makespan-timed, the LLC term off (the oracle ``dpa.pool_tput`` has
    none)."""
    if n_chunks is None:
        n_chunks = max(512, 48 * params.n_threads)
    pool = DpaEventPool(replace(params, llc_bytes=math.inf))
    done = pool.service_batch(np.zeros(n_chunks), chunk_bytes)
    return n_chunks * chunk_bytes / float(done.max())


def _steady_rate(arrivals: np.ndarray, done: np.ndarray) -> float:
    """Items/s over the second half of a paced trace."""
    n = done.shape[0]
    mid = n // 2
    span = float(done[-1] - done[mid - 1])
    if span <= 0.0:                       # zero-cost pool: done == arrivals
        span = float(arrivals[-1] - arrivals[mid - 1])
    return (n - mid) / span if span > 0.0 else math.inf


def sustained_tput_event(params: EventDpaParams,
                         link_bytes_per_s: float = dpa_model.LINK_200G_BYTES, *,
                         chunk_bytes: int = 4096, n_chunks: int | None = None) -> float:
    """Measured bytes/s against a line-rate arrival trace (Figs 13/14)."""
    if n_chunks is None:
        n_chunks = max(2048, 48 * params.n_threads)
    arrivals = np.arange(n_chunks) * (chunk_bytes / link_bytes_per_s)
    pool = DpaEventPool(params)
    done = pool.service_batch(arrivals, chunk_bytes)
    return min(_steady_rate(arrivals, done) * chunk_bytes, link_bytes_per_s)


def threads_to_saturate_event(transport: str,
                              link_bytes_per_s: float = dpa_model.LINK_200G_BYTES, *,
                              chunk_bytes: int = 4096) -> int:
    """Figs 13/14 by measurement: the fewest threads whose event-simulated
    datapath sustains >= 99 % of line rate."""
    limit = dpa_model.DPA_CORES * dpa_model.DPA_THREADS_PER_CORE
    for t in range(1, limit + 1):
        tput = sustained_tput_event(EventDpaParams.from_table1(transport, t),
                                    link_bytes_per_s, chunk_bytes=chunk_bytes)
        if tput >= 0.99 * link_bytes_per_s:
            return t
    return limit


def sustained_chunk_rate_event(params: EventDpaParams, arrival_rate: float, *,
                               chunk_bytes: int = 64, n_chunks: int | None = None) -> float:
    """Measured chunks/s against a trace paced at ``arrival_rate`` (Fig 16)."""
    if n_chunks is None:
        n_chunks = max(4096, 48 * params.n_threads)
    arrivals = np.arange(n_chunks) / arrival_rate
    pool = DpaEventPool(params)
    done = pool.service_batch(arrivals, chunk_bytes)
    return min(_steady_rate(arrivals, done), arrival_rate)


def tbit_feasible_event(transport: str = "UD", n_threads: int = 128, *,
                        margin: float = 0.01) -> bool:
    """§VII-a by event simulation: can 128 threads keep up with the 1.6
    Tbit/s chunk arrival rate at 64 B tracked chunks? ``margin`` absorbs the
    trace's ramp and tail."""
    need = dpa_model.link_chunk_arrival_rate(dpa_model.LINK_1600G_BYTES)
    rate = sustained_chunk_rate_event(EventDpaParams.from_table1(transport, n_threads), need,
                                      chunk_bytes=64)
    return rate >= need * (1.0 - margin)
