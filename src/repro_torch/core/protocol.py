"""Reliable Broadcast protocol (paper §III): segmentation, the logical
state machines, the engine-backed timing facade and the closed forms.

Port of ``src/repro/core/protocol.py``:

- ``MTU``, ``PSN_BITS``, ``IMM_BITS``, ``segment``, ``max_addressable_buffer``,
  ``bitmap_bytes``, ``cutoff_time``;
- the logical state machines of §III (reference protocol.py:26-165):
  ``Bitmap`` and ``StagingRing`` (counters and bits, plain host state as in
  the reference), ``LeafReceiver`` (staging -> bitmap -> a uint8 user
  buffer on the receiver's device; ``deliver`` takes a PSN and that chunk's
  row of ``segment``'s tensor) and ``final_handshake_ok``;
- ``broadcast_time`` and ``allgather_time``, with ``dpa=`` routing the
  receive datapath through the event-level DPA (``core/dpa_engine.py``);
- the closed-form oracle: ``analytic_rnr_barrier``, ``analytic_bcast_time``,
  ``analytic_allgather_time``, ``analytic_ring_allgather_time``,
  ``analytic_ring_reduce_scatter_time``, the composite collectives'
  ``analytic_hier_allgather_time``, ``analytic_allreduce_time``,
  ``pipeline_schedule_time``, ``analytic_pipelined_allreduce_time``
  (:216-366), and ``analytic_expected_rounds``, ``analytic_recovery_time``,
  ``analytic_ring_pipeline_bcast_time`` (:390-446);
- ``BoundCertificate`` (:369), the searcher's certificate;
- ``memory_footprint`` and ``communicators_in_llc`` (:448-467);
- ``reassemble``: a leaf's receive datapath replayed on the chunk
  reassembly kernel in the order a Broadcast delivered the chunks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.device import device_of
from repro_torch.kernels import chunk_reassembly

MTU = 4096
PSN_BITS = 24           # of the 32-bit CQE immediate (rest: collective id, Fig 7)
IMM_BITS = 32


def segment(buffer, mtu: int = MTU) -> torch.Tensor:
    """Fragment a root buffer into MTU chunks (§III-A): row i is the chunk
    with PSN i, as a ``(n_chunks, mtu)`` uint8 tensor; the last chunk is
    zero-padded to the MTU. ``buffer`` is bytes or a 1-D uint8 array or
    tensor; a tensor keeps its device."""
    if isinstance(buffer, torch.Tensor):
        flat = buffer.reshape(-1)
    else:
        flat = torch.from_numpy(np.frombuffer(bytes(buffer), dtype=np.uint8).copy())
    if flat.dtype != torch.uint8:
        raise TypeError(f"segment takes a byte buffer, got {flat.dtype}")
    n = flat.numel()
    n_chunks = -(-n // mtu)
    if n_chunks >= 1 << PSN_BITS:
        raise ValueError("the PSN must fit the immediate (Fig 7)")
    out = torch.zeros((n_chunks, mtu), dtype=torch.uint8, device=flat.device)
    out.view(-1)[:n] = flat
    return out


def reassemble(result, chunks: torch.Tensor, leaf: int,
               user: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """One leaf's receive datapath: the root's ``chunks`` (from ``segment``),
    staged in the order the leaf's staging ring took them in
    (``result.delivery_order[leaf]`` of a Broadcast run with
    ``collect_delivery=True``), scattered into ``user`` by PSN on the chunk
    reassembly kernel (``kernels/chunk_reassembly.py``). ``user`` defaults
    to a zeroed buffer like ``chunks``. Returns (user, bitmap); after a
    completed Broadcast every bit is set and ``user`` equals ``chunks``."""
    if leaf not in result.delivery_order:
        raise ValueError(f"no delivery order for leaf {leaf}: run the Broadcast with "
                         "collect_delivery=True")
    psn = torch.from_numpy(result.delivery_order[leaf]).to(chunks.device)
    if user is None:
        user = torch.zeros_like(chunks)
    return chunk_reassembly.chunk_reassembly(chunks[psn], psn, user)


def max_addressable_buffer(psn_bits: int, mtu: int = MTU) -> int:
    """Fig 7: the receive buffer addressable with psn_bits of immediate."""
    return (1 << psn_bits) * mtu


def bitmap_bytes(buffer_bytes: int, mtu: int = MTU) -> int:
    """Fig 7 / §III-D: one bit per chunk."""
    return (-(-buffer_bytes // mtu) + 7) // 8


# ------------------------------------------------------ logical state machines


@dataclass
class Bitmap:
    """A receiver's chunk bitmap: 64-bit words, bit ``psn & 63`` of word
    ``psn >> 6``."""
    n_chunks: int
    words: list[int] = field(default_factory=list)

    def __post_init__(self):
        self.words = [0] * ((self.n_chunks + 63) // 64)

    def set(self, psn: int) -> None:
        if not 0 <= psn < self.n_chunks:
            raise IndexError(f"PSN {psn} outside 0..{self.n_chunks - 1}")
        self.words[psn >> 6] |= 1 << (psn & 63)

    def get(self, psn: int) -> bool:
        return bool(self.words[psn >> 6] >> (psn & 63) & 1)

    def popcount(self) -> int:
        return sum(w.bit_count() for w in self.words)

    def complete(self) -> bool:
        return self.popcount() == self.n_chunks

    def missing(self) -> list[int]:
        return [i for i in range(self.n_chunks) if not self.get(i)]


@dataclass
class StagingRing:
    """Receive-side staging area (§III-B): chunks land here in any order and
    are copied to the user buffer at their PSN's offset. An arrival beyond
    the capacity is an RNR drop."""
    capacity_chunks: int
    occupied: int = 0
    rnr_drops: int = 0

    def arrive(self) -> bool:
        if self.occupied >= self.capacity_chunks:
            self.rnr_drops += 1
            return False
        self.occupied += 1
        return True

    def drain(self, k: int = 1) -> None:
        if self.occupied < k:
            raise ValueError(f"drain({k}) of a ring holding {self.occupied}")
        self.occupied -= k


class LeafReceiver:
    """A Broadcast leaf's datapath (§III-B/C): staging -> bitmap -> user
    buffer, a zeroed uint8 tensor of ``n_bytes`` on ``device`` (default
    ``cuda``)."""

    def __init__(self, n_bytes: int, mtu: int = MTU, staging_chunks: int = 8192, *,
                 device=None):
        self.mtu = mtu
        self.n_chunks = -(-n_bytes // mtu) if n_bytes else 0
        self.user = torch.zeros(n_bytes, dtype=torch.uint8,
                                device=device_of("cuda" if device is None else device))
        self.bitmap = Bitmap(max(self.n_chunks, 1))
        self.staging = StagingRing(staging_chunks)
        self.duplicates = 0

    def _write(self, psn: int, payload: torch.Tensor) -> None:
        """Chunk ``psn``'s bytes into the user buffer; the padding of a last
        chunk past the buffer's end is not written."""
        off = psn * self.mtu
        end = min(off + self.mtu, self.user.numel())
        self.user[off:end] = payload.reshape(-1)[:end - off].to(self.user.device)

    def deliver(self, psn: int, payload: torch.Tensor) -> bool:
        """Fast path: the multicast datagram of chunk ``psn`` (its row of
        ``segment``'s tensor) arrived, in any order. False on an RNR drop
        (staging full)."""
        if not self.staging.arrive():
            return False
        if self.bitmap.get(psn):
            self.duplicates += 1
        else:
            self._write(psn, payload)
            self.bitmap.set(psn)
        self.staging.drain()
        return True

    def fetch_recover(self, peers: list["LeafReceiver"], root_buffer) -> int:
        """Slow path (§III-C): recursive zero-copy fetch along the ring. For
        each missing chunk, walk the left neighbours until one holds it (the
        root in the worst case, ``root_buffer``: bytes or a uint8 tensor).
        Returns the hops times chunks traversed."""
        root = root_buffer if isinstance(root_buffer, torch.Tensor) else torch.from_numpy(
            np.frombuffer(bytes(root_buffer), dtype=np.uint8).copy())
        root = root.reshape(-1)
        cost = 0
        for psn in self.bitmap.missing():
            off = psn * self.mtu
            src = None
            for peer in peers:
                cost += 1
                if peer.bitmap.get(psn):
                    src = peer.user
                    break
            if src is None:   # fell through to the root
                src = root
                cost += 1
            self._write(psn, src[off:off + self.mtu])
            self.bitmap.set(psn)
        return cost

    def complete(self) -> bool:
        return self.bitmap.complete()


def cutoff_time(n_bytes: int, b_link: float, alpha: float = 50e-6) -> float:
    """§III-C: timeout = N/B_link + alpha (RNR sync + network noise)."""
    return n_bytes / b_link + alpha


def final_handshake_ok(completed: list[bool]) -> bool:
    """Every leaf completed -> every final packet sent and received in the
    ring."""
    return all(completed)


# ------------------------------------------------- engine-backed timing facade


def broadcast_time(p: int, n_bytes: int, fabric=None, workers=None, *,
                   fidelity: str = "packet", seed: int = 0, dpa=None, device=None,
                   **kw) -> float:
    """Completion time of one reliable Broadcast rooted at rank 0, from the
    engine of ``fidelity`` (the packet engine by default, or the fluid one)
    with a generator seeded by ``seed``, as the reference resolves it:
    ``broadcast_time`` -> ``simulator.simulate_broadcast`` ->
    ``sched_ir.execute``. ``dpa=`` (a ``dpa.DpaConfig`` or a
    ``dpa_engine.EventDpaParams``) runs the receive datapath on the
    event-level DPA (``dpa_fidelity="event"``, the packet fidelity only).
    Other keywords go to the packet engine. The leaves' receive datapath
    runs on ``device`` (default ``cuda``)."""
    from repro_torch.core import engine, simulator   # deferred: packet imports us

    _event_dpa(dpa, fidelity, kw)
    return simulator.simulate_broadcast(
        p, n_bytes, fabric or engine.FabricParams(), workers or engine.WorkerParams(),
        np.random.default_rng(seed), fidelity=fidelity, device=device, **kw).time


def allgather_time(p: int, n_bytes: int, fabric=None, workers=None, *,
                   n_chains: int = 1, fidelity: str = "packet", seed: int = 0, dpa=None,
                   device=None, **kw) -> float:
    """Completion time of one reliable M-chain Allgather (reference
    protocol.py:193), from ``simulator.simulate_allgather`` at ``fidelity``
    with a generator seeded by ``seed``; as ``broadcast_time`` otherwise."""
    from repro_torch.core import engine, simulator   # deferred: packet imports us

    _event_dpa(dpa, fidelity, kw)
    return simulator.simulate_allgather(
        p, n_bytes, fabric or engine.FabricParams(), workers or engine.WorkerParams(),
        np.random.default_rng(seed), n_chains, fidelity=fidelity, device=device, **kw).time


def _event_dpa(dpa, fidelity: str, kw: dict) -> None:
    """``dpa=`` selects the event-level DPA, as the reference's facades do."""
    if dpa is None:
        return
    if fidelity != "packet":
        raise ValueError("dpa= requires fidelity='packet'")
    kw.setdefault("dpa_fidelity", "event")
    kw["dpa"] = dpa


# ----------------------------------------------- closed-form cross-check oracle


def analytic_rnr_barrier(p: int, latency: float, rnr_hop: float = 1.5e-6) -> float:
    """§V-A recursive-doubling RNR barrier (the engines' own)."""
    return math.ceil(math.log2(max(p, 2))) * (latency + rnr_hop)


def analytic_bcast_time(p: int, n_bytes: int, b_link: float, latency: float, *,
                        pool_rate: float | None = None, depth: int = 1,
                        rnr_hop: float = 1.5e-6) -> float:
    """Lossless closed form of the Broadcast: RNR barrier + the stream at the
    slower of wire and worker pool + per-hop latency + final handshake."""
    rate = b_link if pool_rate is None else min(b_link, pool_rate)
    return (analytic_rnr_barrier(p, latency, rnr_hop)
            + n_bytes / rate + depth * latency + latency)


def analytic_allgather_time(p: int, n_bytes: int, b_link: float, latency: float, *,
                            n_chains: int = 1, pool_rate: float | None = None,
                            rnr_hop: float = 1.5e-6) -> float:
    """Lossless closed form (a lower bound) of the Allgather: RNR barrier +
    the (P-1)N gathered bytes at the slower of wire and worker pool + one
    activation hop a generation (R = ceil(P/M)) + the final handshake."""
    rate = b_link if pool_rate is None else min(b_link, pool_rate)
    rounds = -(-p // n_chains)
    return (analytic_rnr_barrier(p, latency, rnr_hop)
            + (p - 1) * n_bytes / rate + rounds * latency + latency)


def analytic_ring_allgather_time(p: int, n_bytes: int, b_link: float,
                                 latency: float) -> float:
    """Closed form of the ring Allgather: P-1 generations, each forwarding an
    N-byte shard on the full-duplex NIC plus one hop."""
    return (p - 1) * (n_bytes / b_link + latency)


def analytic_ring_reduce_scatter_time(p: int, n_bytes: int, b_link: float,
                                      latency: float) -> float:
    """Closed form of the ring Reduce-Scatter of an N-byte buffer a rank:
    P-1 generations of the N/P shard (reduction at line rate)."""
    return (p - 1) * (n_bytes / p / b_link + latency)


def analytic_hier_allgather_time(p: int, n_bytes: int, b_link: float, latency: float, *,
                                 island_size: int, m: int | None = None,
                                 stripe_mode: str = "mcast", pool_rate: float | None = None,
                                 rnr_hop: float = 1.5e-6,
                                 b_island: float | None = None) -> float:
    """Closed form (a lower bound) of the hierarchical island Allgather
    (``sched_ir.build_hierarchical_allgather``): phase B an I-member
    Allgather over the switched tier at ``b_link`` (I = P/g islands; the
    M-chain form, or the ring form for the unicast stripe), phase C g-1
    island-ring generations, each rotating an I*N bundle at ``b_island``
    (default ``b_link``). Every phase-C hop crosses one link of at most
    ``b_island``, so the ring term at the island capacity bounds either
    redistribution transport from below (the searcher's pruning bound)."""
    g = island_size
    if not (g >= 2 and p % g == 0 and p // g >= 2):
        raise ValueError(f"islands of {g} must tile {p} ranks into at least two")
    n_islands = p // g
    if stripe_mode == "mcast":
        stripe = analytic_allgather_time(n_islands, n_bytes, b_link, latency, n_chains=m or 1,
                                         pool_rate=pool_rate, rnr_hop=rnr_hop)
    else:
        stripe = analytic_ring_allgather_time(n_islands, n_bytes, b_link, latency)
    b_isl = b_island if b_island is not None else b_link
    return stripe + (g - 1) * (n_islands * n_bytes / b_isl + latency)


def analytic_allreduce_time(p: int, n_bytes: int, b_link: float, latency: float, *,
                            m: int | None = None, pool_rate: float | None = None,
                            rnr_hop: float = 1.5e-6) -> float:
    """Closed form of Allreduce = RS o AG (``sched_ir.build_allreduce``):
    the ring Reduce-Scatter of the buffer, then an Allgather of the reduced
    N/P shards, the ring's (``m`` None) or the M-chain multicast's."""
    rs = analytic_ring_reduce_scatter_time(p, n_bytes, b_link, latency)
    shard = max(n_bytes // p, 1)
    if m:
        ag = analytic_allgather_time(p, shard, b_link, latency, n_chains=m,
                                     pool_rate=pool_rate, rnr_hop=rnr_hop)
    else:
        ag = analytic_ring_allgather_time(p, shard, b_link, latency)
    return rs + ag


def pipeline_schedule_time(rs_times: list[float], ag_times: list[float]) -> float:
    """The two-stage pipeline's completion time: segment s's AG starts once
    its own RS finished and segment s-1's AG drained; segment s+1's RS
    follows segment s's. One definition for the pipelined executor
    (``sched_ir._exec_pipelined_allreduce``) and the closed form below; it
    is monotone in every stage time, so per-segment lower bounds give a
    lower bound of the executed schedule."""
    if len(rs_times) != len(ag_times) or not rs_times:
        raise ValueError(f"need as many RS as AG stages, at least one: {len(rs_times)}, "
                         f"{len(ag_times)}")
    t_rs = t_ag = 0.0
    for rs, ag in zip(rs_times, ag_times):
        t_rs = t_rs + rs
        t_ag = max(t_rs, t_ag) + ag
    return t_ag


def analytic_pipelined_allreduce_time(p: int, n_bytes: int, b_link: float, latency: float, *,
                                      m: int | None = None, n_segments: int = 1,
                                      pool_rate: float | None = None,
                                      rnr_hop: float = 1.5e-6) -> float:
    """Closed form of the segment-pipelined Allreduce
    (``sched_ir.build_pipelined_allreduce``): ``n_segments`` equal-ish
    segments, each an RS o AG pair, segment s+1's Reduce-Scatter under
    segment s's Allgather. One segment is ``analytic_allreduce_time``."""
    if n_segments < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    q, rem = divmod(n_bytes, n_segments)
    segs = [q + (1 if i < rem else 0) for i in range(n_segments)]
    rs_times, ag_times = [], []
    for seg in segs:
        rs_times.append(analytic_ring_reduce_scatter_time(p, seg, b_link, latency))
        shard = max(seg // p, 1)
        if m:
            ag_times.append(analytic_allgather_time(p, shard, b_link, latency, n_chains=m,
                                                    pool_rate=pool_rate, rnr_hop=rnr_hop))
        else:
            ag_times.append(analytic_ring_allgather_time(p, shard, b_link, latency))
    return pipeline_schedule_time(rs_times, ag_times)


# ----------------------------------------------- lower-bound certificates


@dataclass(frozen=True)
class BoundCertificate:
    """The optimality certificate of a searched schedule
    (``core/sched_search.py``): the admissible lower bound the winner was
    pruned against, the term of it that binds (the closed form or a fabric
    cut), and the winner's time over the bound (1.0: nothing is left on the
    table at this fidelity)."""

    kind: str
    p: int
    n_bytes: int
    bound: float                     # admissible lower bound (s)
    winner_time: float               # simulated time of the winner (s)
    binding: str                     # the binding term ("analytic", "cut")

    @property
    def ratio(self) -> float:
        """winner_time / bound: >= 1.0 wherever the bound is admissible."""
        return self.winner_time / self.bound if self.bound > 0 else math.inf


def analytic_expected_rounds(path_loss: float, n_chunks: int, target: float = 0.5) -> float:
    """Expected NACK/retransmission rounds until a receiver behind a path of
    per-packet loss ``path_loss`` completes: the missing set decays
    geometrically, so rounds ~ log(target / n_chunks) / log(q)."""
    if not 0.0 <= path_loss < 1.0:
        raise ValueError(f"path_loss must be in [0, 1), got {path_loss}")
    if path_loss == 0.0 or n_chunks <= 0:
        return 0.0
    # rounds until E[missing] < target chunks
    return max(math.log(target / n_chunks) / math.log(path_loss), 1.0)


def analytic_recovery_time(p: int, n_bytes: int, b_link: float, latency: float,
                           path_loss: float, *, n_tree_links: int | None = None,
                           link_loss: float | None = None, mtu: int = MTU, depth: int = 6,
                           alpha: float = 50e-6) -> float:
    """Closed-form expected recovery time of NACK aggregation and multicast
    retransmission. A round: the cutoff slack, the NACK ascent, the
    retransmission of the union of missing chunks (1 - (1 - q_link)^L of the
    buffer for L lossy tree links) and the descent."""
    n_chunks = max(-(-n_bytes // mtu), 1)
    rounds = analytic_expected_rounds(path_loss, n_chunks)
    if rounds == 0.0:
        return 0.0
    if n_tree_links is not None and link_loss is not None:
        union_frac = 1.0 - (1.0 - link_loss) ** n_tree_links
    else:
        union_frac = min(p * path_loss, 1.0)
    t = 0.0
    frac = union_frac
    for _ in range(int(math.ceil(rounds))):
        t += alpha + 2 * depth * latency + frac * n_bytes / b_link
        frac *= path_loss
    return t


def analytic_ring_pipeline_bcast_time(p: int, n_bytes: int, b_link: float, latency: float, *,
                                      loss_rate: float = 0.0, mtu: int = MTU) -> float:
    """The reliable-unicast baseline: a pipelined ring Broadcast on RC, its
    hardware go-back-N retransmission a goodput inflation 1/(1-q) a hop
    (the crossover of ``protocol_loss_sweep`` part B)."""
    if not 0.0 <= loss_rate < 1.0:
        raise ValueError(f"loss_rate must be in [0, 1), got {loss_rate}")
    n_chunks = max(-(-n_bytes // mtu), 1)
    chunk = min(mtu, n_bytes) if n_bytes else mtu
    wire = (n_chunks + p - 2) * chunk / b_link / (1.0 - loss_rate)
    return wire + (p - 1) * latency


# --------------------------------------------------------- memory footprint


def memory_footprint(n_bytes: int, *, mtu: int = MTU, staging_chunks: int = 1024,
                     n_leaf_rc_qps: int = 2, ctx_bytes: int = 16 << 10) -> dict:
    """§III-D: protocol state per communicator."""
    return {
        "staging_bytes": staging_chunks * mtu,
        "bitmap_bytes": bitmap_bytes(n_bytes, mtu),
        "rc_qps": n_leaf_rc_qps,
        "ud_qps": 1,
        "context_bytes": ctx_bytes,
    }


def communicators_in_llc(llc_bytes: int = int(1.5e6), recvbuf_bytes: int = 16 << 30,
                         ctx_bytes: int = 16 << 10, tracked_chunk: int = 32 << 10) -> int:
    """§III-D(d): how many communicators fit the DPA LLC (the paper: more
    than 16 with 64 KiB bitmaps for 16 GB receive buffers, the bitmap
    tracking 32 KiB multi-packet UC chunks, Fig. 15)."""
    per = bitmap_bytes(recvbuf_bytes, tracked_chunk) + ctx_bytes
    return llc_bytes // per
