"""Datapath Accelerator (DPA) offload model (paper §II-C, §VI-C, Table I).

Port of ``src/repro/core/dpa.py``, a copy: the calibrated closed forms of
the SmartNIC's receive datapath, every function and constant the same,
and no numpy.

Hardware: 16 RISC-V cores @ 1.8 GHz, 16 HW threads/core (256 contexts),
1.5 MB LLC, interfaced with the NIC DMA engine. The receive datapath is
low-IPC data movement (Table I: IPC ~ 0.1), so hardware multithreading hides
load/store latency and throughput scales near-linearly in threads until the
link saturates.

Calibration:
  - Table I single-thread: UD 5.2 GiB/s (1084 cyc/CQE), UC 11.9 GiB/s (598).
  - Fig 13/14: UC saturates 200 Gbit/s at ~4 threads, UD at 8-16.
  - Fig 16: 64 B chunks, 128 threads sustain the 1.6 Tbit/s arrival rate.
  - Fig 5 / §VII-d: one server CPU core sustains only ~1/2-2/3 of 200 Gbit/s.

``core/dpa_engine.py`` simulates the same hardware CQE by CQE; these curves
are its cross-check oracle.
"""
from __future__ import annotations

from dataclasses import dataclass

GIB = 1 << 30

DPA_CORES = 16
DPA_THREADS_PER_CORE = 16
DPA_FREQ_HZ = 1.8e9
DPA_LLC_BYTES = 1.5e6

LINK_200G_BYTES = 200e9 / 8
LINK_1600G_BYTES = 1600e9 / 8

# Table I (measured on BF-3, 8 MiB receive buffer, 4 KiB chunks)
TABLE1 = {
    "UD": {"tput_gib": 5.2, "instr_per_cqe": 113, "cycles_per_cqe": 1084, "ipc": 0.1},
    "UC": {"tput_gib": 11.9, "instr_per_cqe": 66, "cycles_per_cqe": 598, "ipc": 0.11},
}

# Within-core multithread scaling exponent (latency hiding with shared core
# resources), calibrated so UC saturates 200G at ~4 threads and UD at 8-16
# (Figs 13/14). Across cores the scaling is linear, with each core's datapath
# capped at its 200 Gbit/s NIC-engine interface rate — which is exactly why
# 8 cores (128 threads) sustain the 1.6 Tbit/s arrival rate of Fig 16.
MT_SCALING_EXP = 0.55
CORE_CAP_CHUNKS_PER_S = LINK_200G_BYTES / 4096.0

# single server-CPU-core receive datapaths (Fig 5; 2.6 GHz AMD Epyc):
# UD + segmentation/reassembly + software reliability (UCX) and a custom
# RC-chunked engine without the reliability layer. Neither reaches 200 Gbit/s.
CPU_CORE_TPUT_GIB = {"UD_reliability": 9.0, "RC_no_reliability": 18.6}
CPU_FREQ_HZ = 2.6e9

# ---- event-engine calibration (core/dpa_engine.py) -------------------------
# Within-core memory-contention slope of the EVENT-level engine: a thread's
# stalled-on-memory cycles inflate by (1 + slope * (T-1)) when T contexts
# share the core's LLC ports / load-store queue. Calibrated against the same
# anchors as MT_SCALING_EXP — T=1 lands exactly on the Table-I throughput,
# UC saturates 200G at ~4 threads, UD within 8-16 (Figs 13/14) — but through
# the latency-hiding *mechanism* (stalls overlap other threads' compute)
# instead of the closed-form T^e envelope. The two curves agree at the
# anchors and diverge mid-range (DESIGN.md §7 records the deviation).
MEM_CONTENTION = {"UD": 0.17, "UC": 0.35}

# Stall inflation once outstanding chunk state spills the 1.5 MB LLC
# (staging descriptors + bitmap words fall out to DRAM; §III-D keeps
# communicator state LLC-resident precisely to avoid this).
LLC_MISS_PENALTY = 1.6

REF_CHUNK_BYTES = 4096   # Table I was measured at 4 KiB chunks


def cqe_service_cycles(transport: str, *, freq_hz: float = DPA_FREQ_HZ,
                       ref_chunk: int = REF_CHUNK_BYTES) -> tuple[float, float]:
    """(compute_cycles, stall_cycles) per CQE for the event engine.

    The TOTAL wall cycles per CQE are anchored on the Table-I throughput
    (freq * chunk / tput — the measured cycles_per_cqe column undercounts
    queueing outside the core, so the throughput anchor wins), and the
    compute share is the measured instruction fraction instr/cycles = IPC:
    at IPC ~ 0.1 a thread spends ~90% of its CQE stalled on data movement,
    which is exactly the budget hardware multithreading can hide."""
    row = TABLE1[transport]
    total = freq_hz * ref_chunk / (row["tput_gib"] * GIB)
    compute = total * row["instr_per_cqe"] / row["cycles_per_cqe"]
    return compute, total - compute


def host_cqe_service_cycles(datapath: str = "UD_reliability", *,
                            freq_hz: float = CPU_FREQ_HZ,
                            ref_chunk: int = REF_CHUNK_BYTES,
                            ) -> tuple[float, float]:
    """Host-CPU baseline per-CQE cycles (Fig 5 anchors): one Epyc-class core
    running the receive datapath in software. No hardware thread contexts —
    the stall cycles are real wall time, nothing hides them."""
    total = freq_hz * ref_chunk / (CPU_CORE_TPUT_GIB[datapath] * GIB)
    # same measured instruction fraction as the UD DPA datapath: the work is
    # the same; the host just cannot overlap the stalls
    frac = TABLE1["UD"]["instr_per_cqe"] / TABLE1["UD"]["cycles_per_cqe"]
    return total * frac, total * (1.0 - frac)


@dataclass(frozen=True)
class DpaConfig:
    transport: str = "UD"            # UD | UC
    n_threads: int = 1
    chunk_bytes: int = 4096
    link_bytes_per_s: float = LINK_200G_BYTES


def single_thread_tput(transport: str) -> float:
    """Bytes/s, 4 KiB chunks (Table I)."""
    return TABLE1[transport]["tput_gib"] * GIB


def chunk_rate_per_thread(transport: str) -> float:
    """Chunks/s per thread: per-CQE cost dominates, independent of payload for
    small chunks (the Fig 16 projection rests on this)."""
    return single_thread_tput(transport) / 4096.0


def thread_scaling(n_threads: int) -> float:
    return float(n_threads) ** MT_SCALING_EXP


def _pool_chunk_rate(transport: str, n_threads: int) -> float:
    """Chunks/s of a compactly-placed thread pool (§VI-C: fill core 1, then
    core 2, ...): within-core T^e latency-hiding, per-core NIC-interface cap,
    linear across cores."""
    r1 = chunk_rate_per_thread(transport)
    full_cores, rem = divmod(n_threads, DPA_THREADS_PER_CORE)
    per_full = min(r1 * thread_scaling(DPA_THREADS_PER_CORE), CORE_CAP_CHUNKS_PER_S)
    rate = full_cores * per_full
    if rem:
        rate += min(r1 * thread_scaling(rem), CORE_CAP_CHUNKS_PER_S)
    return rate


def pool_tput(cfg: DpaConfig) -> float:
    """Uncapped processing capacity of the thread pool (bytes/s): the leaf
    service rate the discrete-event engine consumes (core/engine.py). Link
    capping belongs to the fabric model, not the worker pool."""
    return _pool_chunk_rate(cfg.transport, cfg.n_threads) * cfg.chunk_bytes


def sustained_tput(cfg: DpaConfig) -> float:
    """Bytes/s the receive datapath sustains (Fig 13/14/15 model).

    Processing is CQE-bound: rate = chunk_rate * chunk_bytes, capped by link.
    Larger UC chunks (multi-packet RDMA writes) raise bytes-per-CQE (Fig 15).
    """
    return min(pool_tput(cfg), cfg.link_bytes_per_s)


def nack_rate(cfg: DpaConfig) -> float:
    """NACK messages/s the DPA progress engine sustains (core/packet.py
    recovery rounds): NACK handling is CQE-bound exactly like the data
    path (Table I), so the pool's chunk rate is its NACK rate — with
    in-tree aggregation the root serves O(1) NACKs/round, which is why the
    recovery engine stays flat as P grows."""
    return _pool_chunk_rate(cfg.transport, cfg.n_threads)


def sustained_chunk_rate(cfg: DpaConfig) -> float:
    """Chunks/s (Fig 16: compare against the arrival rate of a Tbit/s link)."""
    return min(
        _pool_chunk_rate(cfg.transport, cfg.n_threads),
        cfg.link_bytes_per_s / max(cfg.chunk_bytes, 1),
    )


def threads_to_saturate(transport: str, link_bytes_per_s: float = LINK_200G_BYTES,
                        chunk_bytes: int = 4096) -> int:
    for t in range(1, DPA_CORES * DPA_THREADS_PER_CORE + 1):
        if sustained_tput(DpaConfig(transport, t, chunk_bytes, link_bytes_per_s)) >= (
            link_bytes_per_s * 0.99
        ):
            return t
    return DPA_CORES * DPA_THREADS_PER_CORE


def link_chunk_arrival_rate(link_bytes_per_s: float, mtu: int = 4096) -> float:
    """MTU-sized packets/s at 100% utilization (§VII-a)."""
    return link_bytes_per_s / mtu


def tbit_feasible(transport: str = "UD", n_threads: int = 128) -> bool:
    """§VII-a: can half the DPA sustain a 1.6 Tbit/s chunk arrival rate?
    (Modeled with 64 B chunks to match the arrival rate of 4 KiB MTU at 1.6T.)"""
    rate = sustained_chunk_rate(
        DpaConfig(transport, n_threads, chunk_bytes=64,
                  link_bytes_per_s=LINK_1600G_BYTES)
    )
    return rate >= link_chunk_arrival_rate(LINK_1600G_BYTES, 4096)


def economics_summary() -> dict:
    """§VII-d: SuperPOD node: 2x 54-core Xeon vs 4x CX-7 NICs with DPA."""
    cores_per_100g = 1.0
    links_gbit = 4 * 1600
    cpu_cores_needed = links_gbit / 100 * cores_per_100g * 2  # both directions
    return {
        "cpu_cores_needed_4x1600g": cpu_cores_needed,
        "nic_cost_ratio": 1 / 2.5,   # NICs ~2.5x cheaper than the CPUs
        "nic_energy_ratio": 1 / 7.0, # ~7x lower energy
    }
