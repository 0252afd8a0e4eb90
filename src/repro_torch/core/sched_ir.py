"""Collective schedule IR: the typed schedule graph of the paper's
collectives, and its fluid, analytic and packet lowerings.

Port of ``src/repro/core/sched_ir.py``:

- ``PhaseBreakdown``, ``BcastResult``, ``AllgatherResult``, ``_chunking``,
  ``_rnr_barrier`` (sched_ir.py:79-129);
- the ops ``Multicast``, ``Unicast``, ``Reduce`` and ``Schedule`` with its
  activation DAG, ``rounds()`` and ``n_rounds`` (:136-243);
- ``payload_bytes``, ``canonical_key``, ``validate`` (:246-336);
- the builders ``build_broadcast_tree``, ``build_allgather``,
  ``build_ring_allgather``, ``build_hierarchical_allgather`` (:380),
  ``build_ring_reduce_scatter``, ``build_allreduce`` (:483),
  ``segment_bytes`` (:505), ``build_pipelined_allreduce`` (:515) and
  ``build_fsdp_step`` (:557);
- the fluid lowerings ``_fluid_broadcast``, ``_fluid_allgather`` and
  ``_fluid_ring`` (:622-908), on the abstract fabric or a routed
  ``core/topology.py`` fabric (``topology=``, ``hosts=``): the fluid engine
  (``core/engine.py``; its vectorized max-min solve on ``device``) and the
  leaves' pools on the pool kernel (``csrc/pool.cu``), the Broadcast's
  P - 1 leaves in one launch;
- the packet lowerings: ``_packet_allgather`` (:1163-1879, its vectorized
  executor) on the abstract fabric or a topology, with ``_Chain`` (the
  reference's ``_PacketChainRun``) and the link masks of a pass OR-ed
  along the chains' paths on ``device``; ``_packet_ring`` (:911), RC
  goodput inflation over the fluid ring;
- the composite executors (:953-1150): ``AllreduceResult``,
  ``_exec_allreduce`` and ``_exec_pipelined_allreduce`` (RS o AG, barrier
  or segment-pipelined), ``HierAllgatherResult``,
  ``_stripe_contention_factor`` and ``_exec_hier_allgather`` (the striped
  switched Allgather, then the island ring), at the fluid and packet
  fidelities, each leg through ``execute`` on ``device``;
- ``fsdp_submitters`` (:1882), the FSDP step's per-layer flows, abstract
  or routed;
- the analytic lowering ``_exec_analytic`` (:2012), the closed forms of
  ``core/protocol.py``;
- ``execute`` (:2051) for every kind: ``fsdp_step`` at the fluid and
  packet fidelities (``core/engine.simulate_fsdp_step``), the others at
  every fidelity;
- ``autotune_chains`` (:2149), the chain-count sweep, which delegates to
  ``core/sched_search.sweep_chains``.

A Schedule is a DAG of typed ops joined by activation edges, the §IV-A
chain signal ("when I finish multicasting I activate my chain
successor"); "round r" is the r-th topological generation of the DAG.
The host phases (the draws, the NACK rows' pack and OR, the merged rows'
sort) are timed by ``core/profiling.py`` when it is enabled.
"""
from __future__ import annotations

import hashlib
import math
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import profiling, protocol
from repro_torch.core import schedule as seq
from repro_torch.core.dpa_engine import DPA_FIDELITIES, DpaEventPool, resolve_event_params
from repro_torch.core.engine import (FSDP_POLICIES, Engine, FabricParams, WorkerParams,
                                     staging_rnr_mask, worker_pool_completion,
                                     worker_pool_completion_rows)
from repro_torch.device import device_of
from repro_torch.kernels import bitmap

FIDELITIES = ("analytic", "fluid", "packet")
KINDS = ("broadcast", "allgather", "ring_allgather", "reduce_scatter",
         "allreduce", "hier_allgather", "fsdp_step")
#: per-op transport tags (None: let the fabric route); multicast is
#: switched-only, islands have no switch replication
TRANSPORTS = (None, "intra_host", "island", "switched")


# -------------------------------------------------------------- shared pieces


@dataclass
class PhaseBreakdown:
    rnr_sync: float = 0.0
    multicast: float = 0.0
    reliability: float = 0.0
    handshake: float = 0.0

    def total(self) -> float:
        return self.rnr_sync + self.multicast + self.reliability + self.handshake


@dataclass
class BcastResult:
    completion: np.ndarray            # per-leaf completion time (s)
    phases: PhaseBreakdown
    delivered_fast: int
    recovered: int
    rnr_drops: int
    bytes_fast: int
    bytes_recovery: int
    bytes_total: int                  # conservation: fast + recovery == total
    link_bytes: dict[str, float] = field(default_factory=dict)
    # ^ routed mode only: per-fabric-link bytes from the same engine run

    @property
    def time(self) -> float:
        return float(self.completion.max(initial=0.0))


@dataclass
class AllgatherResult:
    time: float
    phases: PhaseBreakdown
    recovered: int
    bytes_fast: int
    bytes_recovery: int
    bytes_total: int
    per_rank_recv_tput: float         # (P-1)*N / time  (Fig. 11 metric)
    link_bytes: dict[str, float] = field(default_factory=dict)
    # ^ routed mode only: per-fabric-link bytes from the same engine run


def _chunking(n_bytes: int, mtu: int) -> tuple[int, int]:
    n_chunks = max(-(-n_bytes // mtu), 1)
    chunk = min(mtu, n_bytes) if n_bytes else mtu
    return n_chunks, chunk


def _rnr_barrier(p: int, fabric: FabricParams, workers: WorkerParams) -> float:
    """The RNR barrier: recursive doubling (paper §V-A)."""
    rounds = int(np.ceil(np.log2(max(p, 2))))
    return rounds * (fabric.latency + workers.rnr_barrier_hop)


def _invariant(ok: bool, *what) -> None:
    if not ok:
        raise ValueError(f"schedule invariant broken: {what}")


# ------------------------------------------------------------------- the ops


@dataclass(frozen=True)
class Multicast:
    """Switch-replicated stream: ``root`` sends ``nbytes`` once, every other
    member of ``group`` receives it (Insight 1)."""
    root: int
    group: tuple[int, ...]
    nbytes: float
    transport: str | None = None

    @property
    def receivers(self) -> tuple[int, ...]:
        return tuple(x for x in self.group if x != self.root)

    @property
    def payload_bytes(self) -> float:
        """Receiver-side payload this op delivers."""
        return self.nbytes * len(self.receivers)

    def ranks(self):
        return self.group


@dataclass(frozen=True)
class Unicast:
    """Point-to-point stream on reliable (RC) transport."""
    src: int
    dst: int
    nbytes: float
    transport: str | None = None

    @property
    def payload_bytes(self) -> float:
        return self.nbytes

    def ranks(self):
        return (self.src, self.dst)


@dataclass(frozen=True)
class Reduce:
    """Reduction op: each source's payload is combined (``op``) on its edge
    toward ``dst``, which receives only the combined ``nbytes``."""
    dst: int
    srcs: tuple[int, ...]
    nbytes: float
    op: str = "sum"
    transport: str | None = None

    @property
    def payload_bytes(self) -> float:
        return self.nbytes

    def ranks(self):
        return (self.dst, *self.srcs)


Op = Multicast | Unicast | Reduce


@dataclass(frozen=True)
class Schedule:
    """A collective as an explicit op DAG. ``activation`` edges (i, j) are
    op-index pairs: op j may start only after op i completed."""
    kind: str
    p: int
    n_bytes: int                       # per-rank payload of the collective
    ops: tuple[Op, ...]
    activation: tuple[tuple[int, int], ...] = ()
    meta: dict = field(default_factory=dict)

    def rounds(self) -> list[list[int]]:
        """Topological generations of the activation DAG (ASAP layering):
        generation g holds every op whose longest activation chain from a
        source has length g. Raises on a cycle."""
        n = len(self.ops)
        succs: list[list[int]] = [[] for _ in range(n)]
        indeg = [0] * n
        for a, b in self.activation:
            succs[a].append(b)
            indeg[b] += 1
        gen = [0] * n
        q = deque(i for i in range(n) if indeg[i] == 0)
        seen = 0
        while q:
            i = q.popleft()
            seen += 1
            for j in succs[i]:
                gen[j] = max(gen[j], gen[i] + 1)
                indeg[j] -= 1
                if indeg[j] == 0:
                    q.append(j)
        _invariant(seen == n, "activation edges must form a DAG")
        out: list[list[int]] = [[] for _ in range(max(gen, default=-1) + 1)]
        for i in range(n):
            out[gen[i]].append(i)
        return out

    @property
    def n_rounds(self) -> int:
        return len(self.rounds())


def payload_bytes(sched: Schedule) -> float:
    """Receiver-side payload the whole schedule delivers."""
    return sum(op.payload_bytes for op in sched.ops)


#: meta keys that change what the executor runs
_CANONICAL_META = ("n_chains", "m", "n_segments", "policy", "n_layers",
                   "layer_bytes", "island_size", "stripe_mode",
                   "redistribute_transport")


def canonical_key(sched: Schedule) -> str:
    """Stable content hash of a schedule: kind, shape, the typed op DAG and
    the executor-relevant meta scalars, the reference's key for the same
    schedule (blake2b of the same repr). Memoized per object."""
    memo = getattr(sched, "_canonical_memo", None)
    if memo is not None:
        return memo
    parts: list = [sched.kind, sched.p, sched.n_bytes]
    for op in sched.ops:
        if isinstance(op, Multicast):
            parts.append(("M", op.root, op.group, op.nbytes, op.transport))
        elif isinstance(op, Unicast):
            parts.append(("U", op.src, op.dst, op.nbytes, op.transport))
        else:
            parts.append(("R", op.dst, op.srcs, op.nbytes, op.op, op.transport))
    parts.append(tuple(sorted(sched.activation)))
    parts.append(tuple((k, sched.meta[k]) for k in _CANONICAL_META if k in sched.meta))
    key = hashlib.blake2b(repr(parts).encode(), digest_size=16).hexdigest()
    object.__setattr__(sched, "_canonical_memo", key)
    return key


def validate(sched: Schedule) -> None:
    """Structural invariants every builder must satisfy (the reference's,
    raising ``ValueError`` where it asserts)."""
    _invariant(sched.kind in KINDS, sched.kind)
    n = len(sched.ops)
    for op in sched.ops:
        for r in op.ranks():
            _invariant(0 <= r < sched.p, op, sched.p)
        _invariant(op.nbytes >= 0, op)
        _invariant(op.transport in TRANSPORTS, op)
        if isinstance(op, Multicast):
            _invariant(op.transport in (None, "switched"), op,
                       "multicast exists only on the switched tier")
    for a, b in sched.activation:
        _invariant(0 <= a < n and 0 <= b < n and a != b, a, b)
    rounds = sched.rounds()
    targets = {b for _, b in sched.activation}
    for g, idxs in enumerate(rounds[1:], start=1):
        _invariant(any(i in targets for i in idxs), f"generation {g} has no activation "
                   "predecessor")
    if sched.kind == "allgather":
        roots = [op.root for op in sched.ops]
        _invariant(sorted(roots) == list(range(sched.p)), "every rank must broadcast exactly once")
        m = sched.meta["n_chains"]
        for r, idxs in enumerate(rounds):
            _invariant(tuple(sched.ops[i].root for i in idxs) == seq.active_group(r, sched.p, m),
                       r, m)
    if sched.kind == "hier_allgather":
        g = sched.meta["island_size"]
        _invariant(g >= 2 and sched.p % g == 0 and sched.p // g >= 2, sched.p, g)
        for op in sched.ops:
            if isinstance(op, Multicast):
                _invariant(op.transport == "switched", op)
                _invariant(set(op.group) == {x for x in range(sched.p)
                                             if x % g == op.root % g}, op, g)
            else:
                _invariant(isinstance(op, Unicast), op)
                if op.transport == "island":
                    _invariant(op.src // g == op.dst // g, op, g,
                               "island op must stay inside one island")


# ------------------------------------------------------------------ builders


def build_broadcast_tree(p: int, n_bytes: int, root: int = 0) -> Schedule:
    """One reliable Broadcast: a single Multicast op rooted at ``root``
    (reference sched_ir.py:339)."""
    return Schedule("broadcast", p, n_bytes, (Multicast(root, tuple(range(p)), n_bytes),))


def build_allgather(p: int, n_bytes: int, m: int = 1) -> Schedule:
    """The paper's Allgather (Appendix A; reference sched_ir.py:345):
    R = ceil(P/M) generations of up to M concurrent Multicasts, and an
    activation edge from each chain member to its successor. Uneven chains
    (M not dividing P): the last chains are shorter and the final
    generations activate fewer roots."""
    group = tuple(range(p))
    ops: list[Op] = []
    op_of_root: dict[int, int] = {}
    for st in seq.allgather_schedule(p, m):
        for root in st.roots:
            op_of_root[root] = len(ops)
            ops.append(Multicast(root, group, n_bytes))
    act = tuple((op_of_root[f], op_of_root[t]) for f, t in seq.activation_edges(p, m))
    return Schedule("allgather", p, n_bytes, tuple(ops), act, meta={"n_chains": m})


def build_ring_allgather(p: int, n_bytes: int) -> Schedule:
    """Classical ring Allgather (reference sched_ir.py:364): P-1 generations,
    each rank forwarding the shard it just received to its right neighbour
    (RC unicasts)."""
    ops: list[Op] = []
    act: list[tuple[int, int]] = []
    idx: dict[tuple[int, int], int] = {}
    for s in range(p - 1):
        for i in range(p):
            idx[(s, i)] = len(ops)
            ops.append(Unicast(i, (i + 1) % p, n_bytes))
        if s:
            act += [(idx[(s - 1, (i - 1) % p)], idx[(s, i)]) for i in range(p)]
    return Schedule("ring_allgather", p, n_bytes, tuple(ops), tuple(act))


def build_hierarchical_allgather(p: int, n_bytes: int, island_size: int, m: int = 1, *,
                                 stripe_mode: str = "mcast",
                                 redistribute_transport: str = "island") -> Schedule:
    """The tiered Allgather of island fabrics (``topology.IslandFatTree``;
    reference sched_ir.py:380): ranks in islands of ``island_size`` (g),
    I = P/g islands, stripe r the ranks {j*g + r}, one of each island.

      B (switched tier): each stripe runs the M-chain multicast Allgather of
        its I members over the fat-tree, so a NIC ingests (I-1)*N, not
        (P-1)*N; ``stripe_mode="ring"`` makes the stripe legs routed
        unicast rings.
      C (island tier): once its stripe is done a rank holds the stripe's
        I*N bundle; g-1 island-ring generations rotate the g bundles of
        each island on ``redistribute_transport`` ("island": the island's
        ring; "switched": back over the fat-tree).

    ``meta`` carries the two phases' sub-schedules the composite executor
    runs: ``stripe_ag`` (one stripe's template) and ``island_ring`` (phase
    C over all P ranks)."""
    if stripe_mode not in ("mcast", "ring"):
        raise ValueError(f"stripe_mode must be 'mcast' or 'ring', got {stripe_mode!r}")
    if redistribute_transport not in ("island", "switched"):
        raise ValueError(f"redistribute_transport must be 'island' or 'switched', got "
                         f"{redistribute_transport!r}")
    g = island_size
    if not (g >= 2 and p % g == 0):
        raise ValueError(f"islands of {g} must tile {p} ranks")
    n_islands = p // g
    if n_islands < 2:
        raise ValueError(f"islands of {g} of {p} ranks: need at least two islands")
    if stripe_mode == "mcast":
        stripe_tpl = build_allgather(n_islands, n_bytes, m)
    else:
        stripe_tpl = build_ring_allgather(n_islands, n_bytes)
        m = None
    tpl_rounds = stripe_tpl.rounds()
    ops: list[Op] = []
    act: list[tuple[int, int]] = []
    stripe_last: list[list[int]] = []     # per stripe: its last generation's ops
    for r in range(g):
        members = tuple(j * g + r for j in range(n_islands))
        off = len(ops)
        for op in stripe_tpl.ops:
            if isinstance(op, Multicast):
                ops.append(Multicast(members[op.root], tuple(members[x] for x in op.group),
                                     op.nbytes, transport="switched"))
            else:
                ops.append(Unicast(members[op.src], members[op.dst], op.nbytes,
                                   transport="switched"))
        act += [(a + off, b + off) for a, b in stripe_tpl.activation]
        stripe_last.append([i + off for i in tpl_rounds[-1]])
    bundle = n_islands * n_bytes
    ring_ops: list[Op] = []
    ring_act: list[tuple[int, int]] = []
    off = len(ops)
    idx: dict[tuple[int, int], int] = {}
    for s in range(g - 1):
        for i in range(p):
            base = (i // g) * g
            idx[(s, i)] = len(ring_ops)
            ring_ops.append(Unicast(i, base + (i - base + 1) % g, bundle,
                                    transport=redistribute_transport))
        if s:
            ring_act += [(idx[(s - 1, (i // g) * g + (i % g - 1) % g)], idx[(s, i)])
                         for i in range(p)]
    ops += ring_ops
    act += [(a + off, b + off) for a, b in ring_act]
    # the phase barrier a stripe: rank i's redistribution starts once its own
    # stripe's (i % g) last generation delivered
    for i in range(p):
        act += [(a, off + idx[(0, i)]) for a in stripe_last[i % g]]
    island_ring = Schedule("ring_allgather", p, bundle, tuple(ring_ops), tuple(ring_act))
    return Schedule("hier_allgather", p, n_bytes, tuple(ops), tuple(act),
                    meta={"island_size": g, "m": m, "stripe_mode": stripe_mode,
                          "redistribute_transport": redistribute_transport,
                          "bundle_bytes": bundle, "stripe_ag": stripe_tpl,
                          "island_ring": island_ring})


def build_ring_reduce_scatter(p: int, n_bytes: int) -> Schedule:
    """Ring Reduce-Scatter of an ``n_bytes`` buffer a rank (reference
    sched_ir.py:464): P-1 generations of single-source Reduce edges, each
    carrying the N/P shard being summed around the ring."""
    shard = n_bytes / p
    ops: list[Op] = []
    act: list[tuple[int, int]] = []
    idx: dict[tuple[int, int], int] = {}
    for s in range(p - 1):
        for i in range(p):
            idx[(s, i)] = len(ops)
            ops.append(Reduce((i + 1) % p, (i,), shard))
        if s:
            act += [(idx[(s - 1, (i - 1) % p)], idx[(s, i)]) for i in range(p)]
    return Schedule("reduce_scatter", p, n_bytes, tuple(ops), tuple(act),
                    meta={"shard_bytes": shard})


def build_allreduce(p: int, n_bytes: int, m: int | None = None) -> Schedule:
    """Allreduce = RS o AG (reference sched_ir.py:483): the ring
    Reduce-Scatter of the ``n_bytes`` buffer, then an Allgather of the
    reduced N/P shards, the ring's (``m`` None) or the paper's M-chain
    multicast (``m >= 1``), joined by a full activation barrier. The shard
    is rounded to whole bytes for the packet-granular AG leg."""
    if p < 2:
        raise ValueError(f"allreduce needs at least 2 ranks, got p={p}")
    shard_int = max(n_bytes // p, 1)
    rs = build_ring_reduce_scatter(p, n_bytes)
    ag = build_allgather(p, shard_int, m) if m else build_ring_allgather(p, shard_int)
    off = len(rs.ops)
    act = list(rs.activation) + [(a + off, b + off) for a, b in ag.activation]
    rs_last = rs.rounds()[-1]
    ag_first = [i + off for i in ag.rounds()[0]]
    act += [(a, b) for a in rs_last for b in ag_first]   # the phase barrier
    return Schedule("allreduce", p, n_bytes, rs.ops + ag.ops, tuple(act),
                    meta={"m": m, "shard_bytes": shard_int, "n_rs_ops": off, "rs": rs,
                          "ag": ag})


def segment_bytes(n_bytes: int, n_segments: int) -> tuple[int, ...]:
    """The buffer's split for pipelining (reference sched_ir.py:505):
    ``n_segments`` contiguous segments, the first ``n_bytes % n_segments``
    one byte longer."""
    if n_segments < 1:
        raise ValueError(f"n_segments must be >= 1, got {n_segments}")
    q, rem = divmod(n_bytes, n_segments)
    return tuple(q + (1 if i < rem else 0) for i in range(n_segments))


def build_pipelined_allreduce(p: int, n_bytes: int, m: int | None = None,
                              n_segments: int = 2) -> Schedule:
    """The segment-pipelined Allreduce (reference sched_ir.py:515): the
    buffer in ``n_segments`` segments, each an RS o AG pair, wired as a
    two-stage pipeline: segment s's AG activated by its own RS, segment
    s+1's RS by segment s's RS (not its AG), so the next Reduce-Scatter
    runs under the previous Allgather. One segment is ``build_allreduce``'s
    barrier composition."""
    if p < 2:
        raise ValueError(f"allreduce needs at least 2 ranks, got p={p}")
    if not 1 <= n_segments <= max(n_bytes, 1):
        raise ValueError(f"n_segments must be in [1, {max(n_bytes, 1)}], got {n_segments}")
    segments: list[tuple[Schedule, Schedule]] = []
    ops: list[Op] = []
    act: list[tuple[int, int]] = []
    prev_rs_last: list[int] = []
    for seg in segment_bytes(n_bytes, n_segments):
        shard_int = max(seg // p, 1)
        rs = build_ring_reduce_scatter(p, seg)
        ag = build_allgather(p, shard_int, m) if m else build_ring_allgather(p, shard_int)
        segments.append((rs, ag))
        rs_off = len(ops)
        ops += rs.ops
        act += [(a + rs_off, b + rs_off) for a, b in rs.activation]
        rs_first = [i + rs_off for i in rs.rounds()[0]]
        rs_last = [i + rs_off for i in rs.rounds()[-1]]
        ag_off = len(ops)
        ops += ag.ops
        act += [(a + ag_off, b + ag_off) for a, b in ag.activation]
        ag_first = [i + ag_off for i in ag.rounds()[0]]
        # the pipeline's wiring: RS_s -> AG_s and RS_s -> RS_{s+1}
        act += [(a, b) for a in prev_rs_last for b in rs_first]
        act += [(a, b) for a in rs_last for b in ag_first]
        prev_rs_last = rs_last
    return Schedule("allreduce", p, n_bytes, tuple(ops), tuple(act),
                    meta={"m": m, "n_segments": n_segments, "segments": tuple(segments),
                          "shard_bytes": max(n_bytes // p, 1)})


def build_fsdp_step(*, p: int, n_layers: int = 32, layer_bytes: float = 256e6,
                    policy: str = "mcast", n_chains: int = 2, **compute) -> Schedule:
    """One FSDP training step as a schedule graph (reference
    sched_ir.py:557): per layer a forward AG (prefetched), a backward AG and
    a backward RS, each in the op type the policy puts on the wire:

      naive   AG and RS both P2P rings (Unicast / single-source Reduce
              edges carrying the full (P-1)/P gather bytes)
      mcast   AG as P Multicasts of the 1/P shard (switch replication);
              RS stays a ring of Reduce edges
      split   AG Multicasts down, in-network aggregation Reduces up
              (every source reduced toward dst: Insight 2's RS_inc)

    Activation edges: each rank's prefetch chain (layer i+1's AG after
    layer i's) and each layer's RS after its backward AG.
    ``fsdp_submitters`` lowers the per-layer op template onto an Engine;
    ``core/engine.simulate_fsdp_step`` interleaves the flows with compute."""
    if policy not in FSDP_POLICIES:
        raise ValueError(f"policy must be one of {FSDP_POLICIES}, got {policy!r}")
    if p < 2 or n_layers < 1:
        raise ValueError(f"need p >= 2 and n_layers >= 1, got {p}, {n_layers}")
    gather = (p - 1) / p * layer_bytes
    shard = layer_bytes / p
    group = tuple(range(p))

    def ag_ops() -> list[Op]:
        if policy == "naive":
            return [Unicast(i, (i + 1) % p, gather) for i in range(p)]
        return [Multicast(i, group, shard) for i in range(p)]

    def rs_ops() -> list[Op]:
        if policy == "split":
            return [Reduce(i, tuple(x for x in group if x != i), shard) for i in range(p)]
        return [Reduce((i + 1) % p, (i,), gather) for i in range(p)]

    ops: list[Op] = []
    act: list[tuple[int, int]] = []
    fwd: list[list[int]] = []
    for layer in range(n_layers):
        base = len(ops)
        ops += ag_ops()
        fwd.append(list(range(base, base + p)))
        if layer:
            act += [(fwd[layer - 1][i], fwd[layer][i]) for i in range(p)]
    prev = fwd[-1]
    for layer in range(n_layers - 1, -1, -1):
        base = len(ops)
        ops += ag_ops()
        idx = list(range(base, base + p))
        act += [(prev[i], idx[i]) for i in range(p)]
        rbase = len(ops)
        ops += rs_ops()
        act += [(idx[i], rbase + i) for i in range(p)]
        prev = idx
    return Schedule("fsdp_step", p, int(layer_bytes), tuple(ops), tuple(act),
                    meta=dict(policy=policy, n_layers=n_layers, layer_bytes=layer_bytes,
                              n_chains=n_chains, gather_bytes=gather, shard_bytes=shard,
                              compute=dict(compute)))


# ----------------------------------------------------------- fluid lowerings


def _placed(topology, hosts, p: int) -> list[int]:
    """The ranks' hosts on ``topology`` (default 0..P-1), its counters reset."""
    hosts = list(hosts) if hosts is not None else list(range(p))
    if len(hosts) != p:
        raise ValueError(f"{len(hosts)} hosts for {p} ranks")
    topology.reset()
    return hosts


def _fluid_broadcast(sched: Schedule, fabric: FabricParams, workers: WorkerParams,
                     rng: np.random.Generator, *, topology=None, hosts=None,
                     device=None) -> BcastResult:
    """Fluid lowering of a single-Multicast schedule (reference
    sched_ir.py:622). The root's stream is one flow, on its send link or, on
    a topology, the multicast tree (the per-leaf latency then scales with the
    routed hop count). On the host, leaf by leaf (the root skipped), each
    leaf's jitter and drop draws in the reference's order; on ``device``
    (default ``cuda``), every leaf's arrivals (injection + latency + jitter,
    the dropped ones +inf), one row a leaf, sorted, so that each row holds
    its survivors in order and +inf after them, and all rows through the
    pool in one launch of ``csrc/pool.cu``. Each row's last completion,
    survivor count and staging-ring drops come back to the host in one copy,
    where the fetch-ring recovery and the final handshake are the
    reference's arithmetic."""
    dev = device_of("cuda" if device is None else device)
    (op,) = sched.ops
    p, n_bytes, root = sched.p, sched.n_bytes, op.root
    n_chunks, chunk = _chunking(n_bytes, fabric.mtu)
    t_rnr = _rnr_barrier(p, fabric, workers)

    eng = Engine(device=dev)
    if topology is not None:
        hosts = _placed(topology, hosts, p)
        tree = topology.multicast_tree(hosts[root], hosts)
        flow = eng.submit_tree(tree, n_chunks * chunk, t_start=t_rnr, tag="mcast")
        hop_lat = [len(topology.route(hosts[root], hosts[leaf])) * fabric.latency
                   for leaf in range(p)]
    else:
        # abstract mode: a single flow on the root's send link, one hop
        eng.add_link("root.send", fabric.b_link)
        flow = eng.submit("root.send", n_chunks * chunk, t_start=t_rnr)
        hop_lat = [fabric.latency] * p
    eng.run()
    inject = flow.chunk_times(n_chunks, chunk)
    service = chunk / workers.thread_tput
    cutoff = t_rnr + protocol.cutoff_time(n_bytes, fabric.b_link, fabric.alpha)

    leaves = [leaf for leaf in range(p) if leaf != root]
    jit = np.empty((len(leaves), n_chunks))
    dropped = np.empty((len(leaves), n_chunks), dtype=bool)
    t0 = time.perf_counter() if profiling.ENABLED else 0.0
    for k in range(len(leaves)):
        jit[k] = rng.uniform(0.0, fabric.jitter, size=n_chunks)
        dropped[k] = rng.random(n_chunks) < fabric.p_drop
    if t0:
        profiling.record("rng", time.perf_counter() - t0)
    n_drop = dropped.sum(1)
    hop = torch.tensor([hop_lat[leaf] for leaf in leaves], dtype=torch.float64, device=dev)
    delay = hop[:, None] + torch.from_numpy(jit).to(dev)
    arr = torch.from_numpy(inject).to(dev)[None, :] + delay
    arr = torch.where(torch.from_numpy(dropped).to(dev), math.inf, arr)
    if profiling.ENABLED:
        with profiling.phase("packing"):
            rows = torch.sort(arr, dim=1).values
    else:
        rows = torch.sort(arr, dim=1).values
    counts = torch.from_numpy(n_chunks - n_drop).to(dev)
    done, rnr = worker_pool_completion_rows(rows, workers.n_recv_workers, service,
                                            workers.staging_chunks)
    last = done.gather(1, (counts - 1).clamp_min(0)[:, None])[:, 0]
    per_leaf = torch.stack([last, rnr.sum(1).to(torch.float64)]).cpu().numpy()

    completion = np.zeros(p)
    completion[root] = inject[-1]
    recovered_total = rnr_total = fast_total = 0
    t_mcast_end = t_rnr
    t_rel_end = 0.0
    for k, leaf in enumerate(leaves):
        n_lost = int(n_drop[k])
        rnr_k = int(per_leaf[1, k])
        rnr_total += rnr_k
        fast_total += n_chunks - n_lost - rnr_k
        t_fast = per_leaf[0, k] if n_lost < n_chunks else t_rnr
        missing = n_lost + rnr_k
        if missing:
            # fetch ring (§III-C): wait for the cutoff, then selective RDMA
            # reads from the left neighbour
            t0 = max(t_fast, cutoff)
            t_fetch = t0 + missing * (2 * fabric.latency + chunk / fabric.b_link)
            recovered_total += missing
            completion[leaf] = t_fetch
            t_rel_end = max(t_rel_end, t_fetch - t0)
        else:
            completion[leaf] = t_fast
        t_mcast_end = max(t_mcast_end, t_fast)

    # final handshake: send final to left, need final from right (§III-C)
    shifted = np.roll(completion, -1)
    completion = np.maximum(completion, shifted) + fabric.latency
    return BcastResult(
        completion=completion,
        phases=PhaseBreakdown(rnr_sync=t_rnr, multicast=t_mcast_end - t_rnr,
                              reliability=t_rel_end, handshake=fabric.latency),
        delivered_fast=fast_total,
        recovered=recovered_total,
        rnr_drops=rnr_total,
        bytes_fast=fast_total * chunk,
        bytes_recovery=recovered_total * chunk,
        bytes_total=(p - 1) * n_chunks * chunk,
        link_bytes=eng.link_bytes() if topology is not None else {},
    )


def _fluid_allgather(sched: Schedule, fabric: FabricParams, workers: WorkerParams,
                     rng: np.random.Generator, *, topology=None, hosts=None, co_hosts=(),
                     device=None) -> AllgatherResult:
    """Fluid lowering of an Appendix-A allgather schedule (reference
    sched_ir.py:710): each generation's Multicast roots inject at once, and
    the leaf receive path (link and worker pool) is the shared bottleneck;
    generations are chained by the activation signal. On a topology each
    chain is a multicast tree flow, and ``co_hosts`` lists further host sets
    running the same schedule at once, whose tree flows are submitted beside
    (their bytes counted, their contention felt). A generation's arrivals
    are the reference's host arithmetic; its pool is a one-row launch of
    ``csrc/pool.cu`` on ``device`` (default ``cuda``)."""
    dev = device_of("cuda" if device is None else device)
    p, n_bytes = sched.p, sched.n_bytes
    generations = sched.rounds()
    n_chunks, chunk = _chunking(n_bytes, fabric.mtu)
    service = chunk / workers.thread_tput
    t_rnr = _rnr_barrier(p, fabric, workers)

    eng = Engine(device=dev)
    if topology is not None:
        hosts = _placed(topology, hosts, p)
    else:
        eng.add_link("leaf.recv", fabric.b_link)

    t = t_rnr
    recovered_total = fast_bytes = rec_bytes = 0
    mcast_time = rel_time = 0.0
    for round_ops in generations:
        m = len(round_ops)
        total_chunks = m * n_chunks
        if topology is not None:
            roots = [hosts[sched.ops[i].root] for i in round_ops]
            flows = [eng.submit_tree(topology.multicast_tree(root, hosts), n_chunks * chunk,
                                     t_start=t, tag=f"chain{root}")
                     for root in roots]
            for co in co_hosts:
                for i in round_ops:
                    co_root = co[sched.ops[i].root]
                    eng.submit_tree(topology.multicast_tree(co_root, list(co)),
                                    n_chunks * chunk, t_start=t, tag=f"costripe{co_root}")
        else:
            # m chain roots inject at once onto the leaf's ejection link
            flows = [eng.submit("leaf.recv", n_chunks * chunk, t_start=t,
                                tag=f"chain{sched.ops[i].root}")
                     for i in round_ops]
        eng.run()
        arrive_spacing = np.sort(np.concatenate([f.chunk_times(n_chunks, chunk)
                                                 for f in flows]))
        t0 = time.perf_counter() if profiling.ENABLED else 0.0
        delay = fabric.latency + rng.uniform(0.0, fabric.jitter, size=total_chunks)
        dropped = rng.random(total_chunks) < fabric.p_drop
        if t0:
            profiling.record("rng", time.perf_counter() - t0)
        arrivals = np.sort((arrive_spacing + delay)[~dropped])
        t_fast, rnr = t, 0
        if arrivals.size:
            done, mask = worker_pool_completion_rows(
                torch.from_numpy(arrivals)[None].to(dev), workers.n_recv_workers, service,
                workers.staging_chunks)
            t_fast, rnr = torch.stack([done[0, -1], mask.sum().to(torch.float64)]).tolist()
            # a numpy scalar, as the reference's done[-1]: the composite
            # executors' sums (Python's sum is compensated only over exact
            # floats) then round as the reference's do
            t_fast, rnr = np.float64(t_fast), int(rnr)
        missing = int(dropped.sum()) + rnr
        cutoff = t + protocol.cutoff_time(m * n_bytes, fabric.b_link, fabric.alpha)
        t_round_end = t_fast
        if missing:
            t0 = max(t_fast, cutoff)
            t_round_end = t0 + missing * (2 * fabric.latency + chunk / fabric.b_link)
            rel_time += t_round_end - t0
            recovered_total += missing
        mcast_time += max(t_fast - t, 0.0)
        fast_bytes += (total_chunks - missing) * chunk
        rec_bytes += missing * chunk
        # activation signal to the next root of every chain
        t = max(t_round_end + fabric.latency, eng.now)

    t_done = t + fabric.latency  # final handshake
    return AllgatherResult(
        time=t_done,
        phases=PhaseBreakdown(rnr_sync=t_rnr, multicast=mcast_time, reliability=rel_time,
                              handshake=fabric.latency),
        recovered=recovered_total,
        bytes_fast=fast_bytes,
        bytes_recovery=rec_bytes,
        bytes_total=p * n_chunks * chunk,
        per_rank_recv_tput=(p - 1) * n_bytes / t_done,
        link_bytes=eng.link_bytes() if topology is not None else {},
    )


@dataclass
class RingCollectiveResult:
    """Result of a ring schedule (ring_allgather / reduce_scatter):
    generation-synchronous neighbour exchange on RC transport."""
    time: float
    phases: PhaseBreakdown
    n_rounds: int
    bytes_total: float                 # receiver payload (== payload_bytes)
    bytes_recovery: float = 0.0        # packet fidelity: RC goodput inflation
    link_bytes: dict[str, float] = field(default_factory=dict)


def _fluid_ring(sched: Schedule, fabric: FabricParams, workers: WorkerParams,
                rng: np.random.Generator, *, topology=None, hosts=None, co_hosts=(),
                device=None) -> RingCollectiveResult:
    """Fluid lowering of a ring schedule (reference sched_ir.py:849): each
    generation every rank forwards its shard to its right neighbour. On the
    abstract fabric one send and one receive flow of the representative
    rank's full-duplex NIC a generation; on a topology every op is a routed
    unicast (its transport pinning the tier where the fabric has tiers), and
    ``co_hosts`` adds sibling stripes' flows. A Reduce edge costs its wire
    bytes. The engine's vectorized solve runs on ``device``."""
    dev = device_of("cuda" if device is None else device)
    p = sched.p
    generations = sched.rounds()
    eng = Engine(device=dev)
    if topology is not None:
        hosts = _placed(topology, hosts, p)
        tiered = getattr(topology, "supports_transport", False)

        def routed(src: int, dst: int, transport):
            return (topology.route(src, dst, transport=transport) if tiered
                    else topology.route(src, dst))

        route_cache: dict[tuple, list] = {}

        def route_of(op: Op):
            src = op.src if isinstance(op, Unicast) else op.srcs[0]
            key = (src, op.dst, op.transport)
            if key not in route_cache:
                route_cache[key] = routed(hosts[src], hosts[op.dst], op.transport)
            return route_cache[key]
    else:
        eng.add_link("ring.send", fabric.b_link)
        eng.add_link("ring.recv", fabric.b_link)

    t = 0.0
    wire_time = 0.0
    for round_ops in generations:
        ops = [sched.ops[i] for i in round_ops]
        for op in ops:
            if not isinstance(op, (Unicast, Reduce)) or (isinstance(op, Reduce)
                                                         and len(op.srcs) != 1):
                raise ValueError(f"the ring lowering takes unicasts and single-source "
                                 f"Reduce edges, got {op}")
        if topology is not None:
            flows = [eng.submit_route(route_of(op), op.nbytes, t_start=t, tag=f"ring{i}")
                     for i, op in enumerate(ops)]
            for s, co in enumerate(co_hosts):
                for i, op in enumerate(ops):
                    src = op.src if isinstance(op, Unicast) else op.srcs[0]
                    eng.submit_route(routed(co[src], co[op.dst], op.transport), op.nbytes,
                                     t_start=t, tag=f"costripe{s}.{i}")
        else:
            nbytes = ops[0].nbytes
            flows = [eng.submit("ring.send", nbytes, t_start=t, tag="ring"),
                     eng.submit("ring.recv", nbytes, t_start=t, tag="ring")]
        eng.run()
        t_end = max(f.t_end for f in flows)
        wire_time += t_end - t
        t = t_end + fabric.latency     # the shard must reach the neighbour
    return RingCollectiveResult(
        time=t,
        phases=PhaseBreakdown(multicast=wire_time, handshake=len(generations) * fabric.latency),
        n_rounds=len(generations),
        bytes_total=payload_bytes(sched),
        link_bytes=eng.link_bytes() if topology is not None else {},
    )


def _packet_ring(sched: Schedule, fabric: FabricParams, workers: WorkerParams,
                 rng: np.random.Generator, *, topology=None, hosts=None, loss=None,
                 device=None) -> RingCollectiveResult:
    """Packet fidelity for ring schedules (reference sched_ir.py:911): RC
    transport retransmits in hardware (go-back-N), so loss is a goodput
    inflation 1/(1 - q_path) of the wire time (``packet.
    rc_goodput_inflation``), q_path over the mean route length of the first
    generation's ops (their transport's tier where the fabric has tiers).
    At loss 0 it is the fluid lowering exactly."""
    from repro_torch.core import packet as pk   # deferred: packet imports this module

    base = _fluid_ring(sched, fabric, workers, rng, topology=topology, hosts=hosts,
                       device=device)
    template = pk.resolve_loss(loss, fabric)
    if template is None:
        return base
    if topology is not None:
        host_list = list(hosts) if hosts is not None else list(range(sched.p))
        tiered = getattr(topology, "supports_transport", False)

        def route_len(op) -> int:
            src = op.src if isinstance(op, Unicast) else op.srcs[0]
            if tiered:
                return len(topology.route(host_list[src], host_list[op.dst],
                                          transport=op.transport))
            return len(topology.route(host_list[src], host_list[op.dst]))

        hops = [route_len(sched.ops[i]) for i in sched.rounds()[0]]
        path_len = max(sum(hops) / len(hops), 1.0)
    else:
        path_len = 1.0
    inflate = pk.rc_goodput_inflation(template.mean_rate, path_len)
    extra = base.phases.multicast * inflate
    base.time += extra
    base.phases.reliability = extra
    base.bytes_recovery = base.bytes_total * inflate
    return base


# ------------------------------------------------------------------ allreduce


@dataclass
class AllreduceResult:
    """Allreduce = RS o AG (reference sched_ir.py:953), the phases back to
    back (``build_allreduce``'s barrier) or segment-pipelined
    (``build_pipelined_allreduce``: ``segments`` holds every (rs, ag) pair
    of results, ``rs`` and ``ag`` the first segment's)."""
    time: float
    rs_time: float                     # total RS stage busy time
    ag_time: float                     # total AG stage busy time
    bytes_total: float
    rs: RingCollectiveResult
    ag: object                         # AllgatherResult | RingCollectiveResult
    link_bytes: dict[str, float] = field(default_factory=dict)
    segments: tuple = ()               # pipelined: ((rs, ag) result, ...)


def _merge_bytes(into: dict[str, float], more: dict[str, float]) -> None:
    for k, v in more.items():
        into[k] = into.get(k, 0.0) + v


def _exec_allreduce(sched: Schedule, fabric, workers, rng, *, fidelity, topology, hosts, loss,
                    kw, device) -> AllreduceResult:
    """The barrier Allreduce (reference sched_ir.py:972): the RS and AG
    sub-schedules that ``build_allreduce`` keeps in ``meta``, each through
    ``execute`` on ``device`` with the one generator, back to back; the
    packet options go to the AG leg."""
    if "segments" in sched.meta:
        return _exec_pipelined_allreduce(sched, fabric, workers, rng, fidelity=fidelity,
                                         topology=topology, hosts=hosts, loss=loss, kw=kw,
                                         device=device)
    rs = execute(sched.meta["rs"], fabric, workers, rng, fidelity=fidelity, topology=topology,
                 hosts=hosts, loss=loss, device=device)
    merged = dict(rs.link_bytes)
    ag = execute(sched.meta["ag"], fabric, workers, rng, fidelity=fidelity, topology=topology,
                 hosts=hosts, loss=loss, device=device, **kw)
    _merge_bytes(merged, ag.link_bytes)
    return AllreduceResult(time=rs.time + ag.time, rs_time=rs.time, ag_time=ag.time,
                           bytes_total=rs.bytes_total + ag.bytes_total, rs=rs, ag=ag,
                           link_bytes=merged)


def _exec_pipelined_allreduce(sched: Schedule, fabric, workers, rng, *, fidelity, topology,
                              hosts, loss, kw, device) -> AllreduceResult:
    """The segment-pipelined Allreduce (reference sched_ir.py:998): each
    segment's RS and AG run on their own (the RS on the neighbour ring, the
    AG on the multicast trees or the receive path: disjoint stage resources
    at this model's grain), then ``protocol.pipeline_schedule_time``
    composes them, segment s+1's RS under segment s's AG. The same
    recurrence over per-segment closed forms is the admissible bound, so
    analytic <= fluid <= packet carries over segment by segment."""
    results = []
    merged: dict[str, float] = {}
    for rs_sched, ag_sched in sched.meta["segments"]:
        rs = execute(rs_sched, fabric, workers, rng, fidelity=fidelity, topology=topology,
                     hosts=hosts, loss=loss, device=device)
        rs_links = dict(rs.link_bytes)
        ag = execute(ag_sched, fabric, workers, rng, fidelity=fidelity, topology=topology,
                     hosts=hosts, loss=loss, device=device, **kw)
        results.append((rs, ag))
        _merge_bytes(merged, rs_links)
        _merge_bytes(merged, ag.link_bytes)
    rs_times = [rs.time for rs, _ in results]
    ag_times = [ag.time for _, ag in results]
    return AllreduceResult(
        time=protocol.pipeline_schedule_time(rs_times, ag_times),
        rs_time=sum(rs_times),
        ag_time=sum(ag_times),
        bytes_total=sum(rs.bytes_total + ag.bytes_total for rs, ag in results),
        rs=results[0][0],
        ag=results[0][1],
        link_bytes=merged,
        segments=tuple(results),
    )


# ----------------------------------------------------- hierarchical Allgather


@dataclass
class HierAllgatherResult:
    """The hierarchical Allgather: striped switched Allgather, then the
    island-ring redistribution (reference sched_ir.py:1038). ``stripe`` is
    stripe 0's phase-B result: the stripes are disjoint and alike, so one
    times them all; at fluid fidelity on a topology every stripe's flows
    share its engine (stripe 0 feels the siblings' uplink contention, every
    stripe's bytes are counted), at packet fidelity stripe 0's time carries
    the fluid-measured contention factor."""
    time: float
    stripe: object                   # AllgatherResult | RingCollectiveResult
    ring: RingCollectiveResult       # phase C (the island redistribution)
    bytes_total: float
    per_rank_recv_tput: float
    phases: PhaseBreakdown
    link_bytes: dict[str, float] = field(default_factory=dict)
    completed: bool = True           # packet: phase B converged (C is RC)


def _stripe_contention_factor(stripe_sched: Schedule, fabric, workers, topology, stripe_hosts,
                              co_stripes, device=None) -> float:
    """The stripes' uplink contention as a fluid slowdown (reference
    sched_ir.py:1062): the stripe template alone and with every sibling
    stripe's flows on one engine, each from a fresh ``default_rng(0)`` (so
    the pair's draws are the same), on ``device``. At least 1 (max-min is
    monotone); the packet stripe leg is scaled by it."""
    if not co_stripes:
        return 1.0
    lower = _fluid_allgather if stripe_sched.kind == "allgather" else _fluid_ring
    solo = lower(stripe_sched, fabric, workers, np.random.default_rng(0), topology=topology,
                 hosts=stripe_hosts, device=device)
    full = lower(stripe_sched, fabric, workers, np.random.default_rng(0), topology=topology,
                 hosts=stripe_hosts, co_hosts=co_stripes, device=device)
    return max(full.time / solo.time, 1.0)


def _exec_hier_allgather(sched: Schedule, fabric, workers, rng, *, fidelity, topology, hosts,
                         loss, kw, device) -> HierAllgatherResult:
    """The hierarchical Allgather's lowering (reference sched_ir.py:1081):
    phase B, the stripe template on stripe 0's members with the sibling
    stripes' flows beside it (fluid on a topology: on one engine; packet:
    stripe 0's packet run scaled by the fluid contention factor, the
    siblings' fabric bytes counted statically), then phase C, the island
    ring over every rank (its ops' transports route it onto the island
    tier). A phase C all on the island tier runs lossless at packet
    fidelity (the island's links are reliable); the switched redistribution
    keeps the caller's loss. The packet options in ``kw`` go to a multicast
    stripe leg only (a ring stripe is RC transport)."""
    p, g = sched.p, sched.meta["island_size"]
    n_islands = p // g
    stripe_sched: Schedule = sched.meta["stripe_ag"]
    ring_sched: Schedule = sched.meta["island_ring"]
    host_list = list(hosts) if hosts is not None else list(range(p))
    if len(host_list) != p:
        raise ValueError(f"{len(host_list)} hosts for {p} ranks")
    stripe_hosts = [host_list[j * g] for j in range(n_islands)] if topology is not None else None
    co_stripes = ([[host_list[j * g + r] for j in range(n_islands)] for r in range(1, g)]
                  if topology is not None else [])
    if fidelity == "fluid" and topology is not None:
        lower = _fluid_allgather if stripe_sched.kind == "allgather" else _fluid_ring
        stripe_res = lower(stripe_sched, fabric, workers, rng, topology=topology,
                           hosts=stripe_hosts, co_hosts=co_stripes, device=device)
        link_bytes = dict(stripe_res.link_bytes)
    else:
        stripe_kw = kw if stripe_sched.kind == "allgather" else {}
        stripe_res = execute(stripe_sched, fabric, workers, rng, fidelity=fidelity,
                             topology=topology, hosts=stripe_hosts, loss=loss, device=device,
                             **stripe_kw)
        link_bytes = dict(stripe_res.link_bytes)
        if topology is not None:
            factor = _stripe_contention_factor(stripe_sched, fabric, workers, topology,
                                               stripe_hosts, co_stripes, device=device)
            if factor > 1.0:
                extra = stripe_res.time * (factor - 1.0)
                stripe_res.time += extra
                stripe_res.phases.multicast += extra
            topology.reset()
            for r in range(1, g):
                members = [host_list[j * g + r] for j in range(n_islands)]
                for op in stripe_sched.ops:
                    if isinstance(op, Multicast):
                        topology.multicast(members[op.root], members, op.nbytes)
                    else:
                        topology.unicast(members[op.src], members[op.dst], op.nbytes)
            for (a, b), v in topology.counters.bytes_by_link.items():
                link_bytes[f"{a}->{b}"] = link_bytes.get(f"{a}->{b}", 0.0) + v
    ring_loss = loss
    if all(op.transport == "island" for op in ring_sched.ops):
        ring_loss = 0.0               # packet.resolve_loss: lossless
    ring_res = execute(ring_sched, fabric, workers, rng, fidelity=fidelity, topology=topology,
                       hosts=host_list, loss=ring_loss if fidelity == "packet" else None,
                       device=device)
    _merge_bytes(link_bytes, ring_res.link_bytes)
    total_time = stripe_res.time + ring_res.time
    sp, rp = stripe_res.phases, ring_res.phases
    return HierAllgatherResult(
        time=total_time,
        stripe=stripe_res,
        ring=ring_res,
        bytes_total=payload_bytes(sched),
        per_rank_recv_tput=(p - 1) * sched.n_bytes / total_time,
        phases=PhaseBreakdown(rnr_sync=sp.rnr_sync, multicast=sp.multicast + rp.multicast,
                              reliability=sp.reliability + rp.reliability,
                              handshake=sp.handshake + rp.handshake),
        link_bytes=link_bytes,
        completed=bool(getattr(stripe_res, "completed", True)),
    )


# ----------------------------------------------------------- FSDP lowering


def fsdp_submitters(sched: Schedule, eng: Engine, fabric: FabricParams, *,
                    topology=None, hosts=None):
    """Lower the per-layer AG/RS op template of a ``build_fsdp_step``
    schedule onto an Engine (reference sched_ir.py:1882): returns
    ``(submit_ag, submit_rs, ag_sync)``, the closures the FSDP timeline
    calls per layer, and the AG's activation latency. On a topology every op
    is a routed unicast, a multicast tree or an aggregation tree flow;
    abstractly the ops fall on the representative rank's NIC links (naive:
    one shared half-duplex medium; mcast and split: a full-duplex send and
    receive). The caller resets the topology (multi-job runs share one
    fabric). Each closure takes ``(t, scale=1.0)``: ``scale`` multiplies the
    layer's wire bytes against the template's ``layer_bytes``."""
    p = sched.p
    meta = sched.meta
    n_chains = meta["n_chains"]
    # byte quantities come from meta (the builder's expressions); the op
    # template of the first layer decides the policy's wire structure
    gather_bytes, shard_bytes = meta["gather_bytes"], meta["shard_bytes"]
    b = fabric.b_link
    ag_template = sched.ops[:p]                                   # layer 0's AG ops
    rs_template = [op for op in sched.ops if isinstance(op, Reduce)][:p]
    if isinstance(ag_template[0], Unicast):
        policy = "naive"
    elif len(rs_template[0].srcs) > 1:
        policy = "split"
    else:
        policy = "mcast"
    if policy != meta["policy"]:
        raise ValueError(f"the op template is {policy}, the meta says {meta['policy']}")

    if topology is not None:
        hosts = list(hosts) if hosts is not None else list(range(p))
        if len(hosts) != p:
            raise ValueError(f"{len(hosts)} hosts for {p} ranks")

        def submit_ring(routes, tag, nbytes, t):
            return [eng.submit_route(r, nbytes, t_start=t, tag=tag) for r in routes]

        if policy == "naive":
            # both collectives as P2P rings in the same direction: their
            # flows share every host link and the ECMP paths between them
            ring = [topology.route(hosts[op.src], hosts[op.dst]) for op in ag_template]

            def submit_ag(t, scale=1.0):
                return submit_ring(ring, "ag", gather_bytes * scale, t)

            def submit_rs(t, scale=1.0):
                return submit_ring(ring, "rs", gather_bytes * scale, t)

            return submit_ag, submit_rs, (p - 1) * fabric.latency

        mcast_trees = [topology.multicast_tree(hosts[op.root], hosts) for op in ag_template]

        def submit_ag(t, scale=1.0):
            # every host multicasts its 1/P shard; the switches replicate
            return [eng.submit_tree(tree, shard_bytes * scale, t_start=t, tag="ag")
                    for tree in mcast_trees]

        if policy == "mcast":
            ring = [topology.route(hosts[op.srcs[0]], hosts[op.dst]) for op in rs_template]

            def submit_rs(t, scale=1.0):
                return submit_ring(ring, "rs", gather_bytes * scale, t)
        else:   # split: RS_inc, aggregation trees opposite the AG trees
            agg_trees = [topology.aggregation_tree(hosts[op.dst], hosts) for op in rs_template]

            def submit_rs(t, scale=1.0):
                return [eng.submit_tree(tree, shard_bytes * scale, t_start=t, tag="rs")
                        for tree in agg_trees]

        rounds = max(p // max(n_chains, 1), 1)
        return submit_ag, submit_rs, rounds * fabric.latency

    if policy == "naive":
        eng.add_link("shared", b)

        def submit_ag(t, scale=1.0):
            # ring AG: (p-1)/p*L sent and received through the shared medium
            return [eng.submit("shared", 2 * gather_bytes * scale, t_start=t, tag="ag")]

        def submit_rs(t, scale=1.0):
            return [eng.submit("shared", 2 * gather_bytes * scale, t_start=t, tag="rs")]

        return submit_ag, submit_rs, (p - 1) * fabric.latency

    # mcast and split share the multicast AG; they differ in the RS
    eng.add_link("send", b)
    eng.add_link("recv", b)

    def submit_ag(t, scale=1.0):
        # AG_mc: receive-bound (its send share is 1/p)
        return [eng.submit("send", shard_bytes * scale, t_start=t, tag="ag"),
                eng.submit("recv", gather_bytes * scale, t_start=t, tag="ag")]

    if policy == "mcast":
        def submit_rs(t, scale=1.0):
            # ring RS: the full gather bytes both ways, so its receive
            # stream contends with AG_mc on the ejection link
            return [eng.submit("send", gather_bytes * scale, t_start=t, tag="rs"),
                    eng.submit("recv", gather_bytes * scale, t_start=t, tag="rs")]
    else:
        def submit_rs(t, scale=1.0):
            # RS_inc: send-bound; the switch reduces, the node receives only
            # its own reduced shard
            return [eng.submit("send", gather_bytes * scale, t_start=t, tag="rs"),
                    eng.submit("recv", shard_bytes * scale, t_start=t, tag="rs")]

    rounds = max(p // max(n_chains, 1), 1)
    return submit_ag, submit_rs, rounds * fabric.latency


# ------------------------------------------------------------ analytic path


def _exec_analytic(sched: Schedule, fabric: FabricParams, workers: WorkerParams) -> float:
    """Closed-form oracle per schedule kind (``core/protocol.py``
    ``analytic_*``; reference sched_ir.py:2012): the lossless lower bound
    the engines are held against (analytic <= fluid <= packet)."""
    b, lat = fabric.b_link, fabric.latency
    pool_rate = workers.n_recv_workers * workers.thread_tput
    hop = workers.rnr_barrier_hop
    p, n = sched.p, sched.n_bytes
    if sched.kind == "broadcast":
        return protocol.analytic_bcast_time(p, n, b, lat, pool_rate=pool_rate, rnr_hop=hop)
    if sched.kind == "allgather":
        return protocol.analytic_allgather_time(p, n, b, lat, n_chains=sched.meta["n_chains"],
                                                pool_rate=pool_rate, rnr_hop=hop)
    if sched.kind == "ring_allgather":
        return protocol.analytic_ring_allgather_time(p, n, b, lat)
    if sched.kind == "hier_allgather":
        return protocol.analytic_hier_allgather_time(
            p, n, b, lat, island_size=sched.meta["island_size"], m=sched.meta.get("m"),
            stripe_mode=sched.meta["stripe_mode"], pool_rate=pool_rate, rnr_hop=hop)
    if sched.kind == "reduce_scatter":
        return protocol.analytic_ring_reduce_scatter_time(p, n, b, lat)
    if sched.kind == "allreduce":
        if sched.meta.get("n_segments", 1) > 1:
            return protocol.analytic_pipelined_allreduce_time(
                p, n, b, lat, m=sched.meta["m"], n_segments=sched.meta["n_segments"],
                pool_rate=pool_rate, rnr_hop=hop)
        return protocol.analytic_allreduce_time(p, n, b, lat, m=sched.meta["m"],
                                                pool_rate=pool_rate, rnr_hop=hop)
    raise NotImplementedError(f"no analytic form for kind={sched.kind}")


# --------------------------------------------------- packet-fidelity Allgather


def _check_packet_options(dpa_fidelity: str, dpa, engine: str) -> None:
    """The packet options' guards, as the reference's; ``engine="reference"``,
    the reference's per-leaf executor, is not ported and raises."""
    if dpa_fidelity not in DPA_FIDELITIES:
        raise ValueError(f"dpa_fidelity must be one of {DPA_FIDELITIES}, got {dpa_fidelity!r}")
    if dpa is not None and dpa_fidelity != "event":
        raise ValueError("dpa= requires dpa_fidelity='event'")
    if engine == "reference":
        raise NotImplementedError("engine='reference': the reference's per-leaf packet "
                                  "executor is not ported (ROADMAP.md §1, \"Not queued\")")
    if engine not in ("auto", "vectorized"):
        raise ValueError(f"engine must be 'auto', 'vectorized' or 'reference', got {engine!r}")


def _event_rows(pools: list, vals: torch.Tensor, counts: torch.Tensor, chunk: float,
                staging: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The event-level DPA's pass over sorted arrival rows: ``vals`` (B, w)
    and ``counts`` (B,) come to the host once, row k's real prefix goes
    through ``pools[k]`` (a persistent ``DpaEventPool``, in row order), and
    (t_last (B,): the latest done time, NaN for an empty row; the
    staging-ring drops (B, w) in ``vals``' order) go back to its device."""
    arr, cnt = vals.cpu().numpy(), counts.cpu().numpy()
    t_last = np.full(arr.shape[0], np.nan)
    rnr = np.zeros(arr.shape, dtype=bool)
    for k, dpa_pool in enumerate(pools):
        c = int(cnt[k])
        if c:
            a = arr[k, :c]
            done = dpa_pool.service_batch(a, chunk)
            t_last[k] = done.max()
            rnr[k, :c] = staging_rnr_mask(done, a, staging)
    return torch.from_numpy(t_last).to(vals.device), torch.from_numpy(rnr).to(vals.device)


def _serve_nacks(root_pool, arrivals: np.ndarray, workers: WorkerParams, nack_service: float,
                 nack_wire: int, n_union: int, chunk: float, now: float) -> tuple[float, float]:
    """The root's side of a recovery round: the NACK arrivals served by the
    scalar pool (``root_pool`` None) or by the root's persistent event pool,
    which then posts the ``n_union`` retransmit WQEs on the same contexts
    (the wire injection overlaps the posting). Returns (the NACKs' latest
    service time, the retransmission's start)."""
    if root_pool is None:
        done, _ = worker_pool_completion(arrivals, workers.n_recv_workers, nack_service,
                                         workers.staging_chunks)
        return float(done[-1]), max(float(done[-1]), now)
    t_done, _ = root_pool.service_with_rnr(arrivals, np.arange(arrivals.shape[0]), nack_wire,
                                           workers.staging_chunks, kind="nack",
                                           wire_bytes=nack_wire)
    t_retx = max(t_done, now)
    root_pool.service_batch(np.full(n_union, t_retx), chunk, kind="retx")
    return t_done, t_retx


class _Chain:
    """One Multicast op of a packet Allgather generation (the reference's
    ``_PacketChainRun``, sched_ir.py:1163): its tree flow, each leaf's path
    and the loss process of every link on the paths. On a topology the
    paths are the tree's root->leaf links, and ``model_cache`` gives one
    process per physical link, shared by every chain that crosses it and
    kept across rounds and generations; abstractly a leaf's path is its
    ejection carrier, shared by every chain. ``rows``: each link's row in
    ``models`` (its order); ``idx`` (P, D): each leaf's path as rows, -1 past
    the path's end and for the chain's own root; ``hop`` (P,): each leaf's
    path latency."""

    __slots__ = ("root", "tree", "paths", "models", "rows", "idx", "hop", "flow")

    def __init__(self, root: int, p: int, latency: float, topology, hosts: list[int],
                 carriers, template, rng: np.random.Generator, model_cache: dict):
        from repro_torch.core import packet as pk   # deferred: packet imports this module

        self.root = root
        self.flow = None
        if topology is None:
            # ``carriers``: (paths, models, rows) of every leaf's carrier,
            # built once an Allgather; leaf x's carrier is row x
            self.tree = None
            self.paths, self.models, self.rows = carriers
            at = np.arange(p)
            self.idx = np.where(at == root, -1, at)[:, None]
            self.hop = np.where(at == root, 0.0, latency)
            return
        self.tree = topology.multicast_tree(hosts[root], hosts)
        names = {leaf: topology.host(hosts[leaf]) for leaf in range(p) if leaf != root}
        by_name = pk.tree_paths(self.tree, topology.host(hosts[root]), list(names.values()))
        self.paths = {leaf: by_name[name] for leaf, name in names.items()}
        # forks in the order of the leaves' host names, from the caller's rng
        self.models = pk._link_models({names[leaf]: self.paths[leaf] for leaf in names},
                                      template, rng, cache=model_cache)
        self.rows = {lid: k for k, lid in enumerate(self.models)}
        depth = max((len(path) for path in self.paths.values()), default=1)
        self.idx = np.full((p, depth), -1, dtype=np.int64)
        self.hop = np.zeros(p)
        for leaf, path in self.paths.items():
            self.idx[leaf, :len(path)] = [self.rows[id(link)] for link in path]
            self.hop[leaf] = len(path) * latency

    def links(self) -> dict:
        """The links of the chain's tree with their loss processes: the
        fast path's draws. A chain sends nothing to its own root, so
        abstractly the root's carrier is not among them (drawing on it would
        shift the shared process)."""
        if self.tree is not None:
            return self.models
        return {lid: m for lid, m in self.models.items() if self.rows[lid] != self.root}


def _chain_losses(chains: list[_Chain], sampled: list[dict], sizes: list[int],
                  leaves: np.ndarray, width: int, dev: torch.device) -> torch.Tensor | None:
    """What each leaf lost from each chain in one pass: (len(leaves),
    len(chains), width) bool on ``dev``, or None where no sampled link has a
    loss process. Chain c draws ``sizes[c]`` packets on each link of
    ``sampled[c]`` (its links, or in recovery the pruned tree's); each
    process draws its chains in chain order (``LossModel.sample_runs``),
    which is the reference's order per process. The masks go to the device
    as one (chains x links, width) matrix and are OR-ed along the paths one
    tree level at a time (``packet._or_levels``)."""
    from repro_torch.core import packet as pk   # deferred: packet imports this module

    groups: dict[int, tuple] = {}
    offsets = np.cumsum([0] + [len(ch.models) for ch in chains])
    for c, ch in enumerate(chains):
        for lid, model in sampled[c].items():
            if model is not None:
                groups.setdefault(id(model), (model, []))[1].append(
                    (offsets[c] + ch.rows[lid], sizes[c]))
    if not groups:
        return None
    zero = int(offsets[-1])
    mat = pk._mask_rows(zero, width, dev)
    view = mat.numpy()
    t0 = time.perf_counter() if profiling.ENABLED else 0.0
    for model, runs in groups.values():
        drops = model.sample_runs([s for _, s in runs])
        at = 0
        for r, s in runs:
            view[r, :s] = drops[at:at + s]
            at += s
    if t0:
        profiling.record("rng", time.perf_counter() - t0)
    depth = max(ch.idx.shape[1] for ch in chains)
    idx = np.full((leaves.size, len(chains), depth), zero, dtype=np.int64)
    for c, ch in enumerate(chains):
        part = ch.idx[leaves]
        idx[:, c, :part.shape[1]] = np.where(part >= 0, part + offsets[c], zero)
    return pk._or_levels(mat, idx, dev)


def _merged_pool(arr: torch.Tensor, counts: torch.Tensor, t_floor: torch.Tensor,
                 workers: WorkerParams, service: float, block_elems: int,
                 pools: list | None = None, chunk: float = 0.0):
    """Every leaf's worker pool fed the merged stream of all chains, as one
    pass over a (rows, chains, width) arrival matrix on its device. ``arr``
    holds each delivered chunk's arrival time and +inf where nothing
    arrives (a chain's own root, a lost or unwanted chunk); a row is laid
    out chains in order, chunks ascending, so the stable sort breaks the
    exact ties between chains (jitter 0) as the reference's stable argsort
    of its concatenated rows does, and the +inf sentinels sort past the
    real entries. ``counts`` (rows,) are the real entries a row. Rows go
    through the pool kernel in blocks of ``block_elems`` elements (one
    launch at every shape this port's checks run), or with ``pools`` (a
    ``DpaEventPool`` a row) through the event-level DPA on the host
    (``_event_rows``: the reference's per-leaf merged pass, the stable sort
    still on the device). Returns (t_done (rows,):
    the latest completion of a row's real entries, ``t_floor`` where it
    has none; the staging-ring drops (rows, chains, width) in ``arr``'s
    layout)."""
    b, m, w = arr.shape
    rows = arr.reshape(b, m * w)
    t_done = torch.empty(b, dtype=torch.float64, device=arr.device)
    rnr = torch.empty((b, m * w), dtype=torch.bool, device=arr.device)
    blk = max(1, block_elems // max(m * w, 1))
    pos = torch.arange(m * w, device=arr.device)
    for b0 in range(0, b, blk):
        b1 = min(b0 + blk, b)
        if profiling.ENABLED:
            with profiling.phase("packing"):
                vals, order = torch.sort(rows[b0:b1], dim=1, stable=True)
        else:
            vals, order = torch.sort(rows[b0:b1], dim=1, stable=True)
        if pools is None:
            done, drop = worker_pool_completion_rows(vals, workers.n_recv_workers, service,
                                                     workers.staging_chunks)
            real = pos[None, :] < counts[b0:b1, None]
            last = torch.where(real, done, -math.inf).amax(1)
        else:
            last, drop = _event_rows(pools[b0:b1], vals, counts[b0:b1], chunk,
                                     workers.staging_chunks)
        t_done[b0:b1] = torch.where(counts[b0:b1] > 0, last, t_floor[b0:b1])
        rnr[b0:b1] = torch.zeros_like(drop).scatter_(1, order, drop)
    return t_done, rnr.view(b, m, w)


def _packet_allgather(sched: Schedule, fabric: FabricParams, workers: WorkerParams,
                      rng: np.random.Generator, *, topology=None, hosts=None, loss=None,
                      max_rounds: int | None = None, aggregate_nacks: bool = True,
                      dpa_fidelity: str = "scalar", dpa=None, engine: str = "auto",
                      device=None):
    """Packet-fidelity lowering of an allgather schedule (reference
    sched_ir.py:1210, the vectorized executor), on the abstract fabric or a
    routed topology (``topology=``, ``hosts=``), at either DPA fidelity.

    Each generation of the activation DAG runs its chain roots' Broadcasts
    at once on one fluid engine (host): abstractly every chain's flow, and
    every retransmission, shares the link ``leaf.recv``; on a topology each
    is a tree flow, the retransmission down the tree pruned to the chain's
    root and nackers. Every leaf's worker pool serves the merged arrivals of
    all chains; a generation's activation of the next waits for all its
    chains and their recovery.

    Host: the engine, and every random draw in the reference's order: the
    link loss forks (abstractly one carrier a leaf, forked in leaf order
    0..P-1; routed one process a physical link, forked as each generation's
    chains first reach it, in host-name order), each chain's masks on its
    links (in recovery on its pruned tree's), and one sized jitter draw per
    pass, leaf-major and chain-minor. With a topology and a loss template
    the jitter draws are made even at ``jitter == 0`` (they are all 0.0),
    because later generations fork link models from the same generator.
    ``device``: the link masks of a pass as one matrix, OR-ed along the
    paths one tree level at a time; the leaves x chains x chunks state (the
    missing flags (P, M, chunks), the merged arrival matrix, its stable
    sort, the pool pass on ``csrc/pool.cu``), and each round's NACK unions,
    every live chain's at once: the missing rows of the NACKing leaves
    packed to u32 words (``csrc/bitmap.cu``), the rows OR-ed, a popcount per
    chain. A generation's fast path is one pool launch and a recovery round
    one pool, pack, OR and popcount launch, whatever the number of leaves
    and chains (the pool's rows in blocks of ``_BLOCK_ELEMS`` elements)."""
    from repro_torch.core import packet as pk   # deferred: packet imports this module

    _check_packet_options(dpa_fidelity, dpa, engine)
    dev = device_of("cuda" if device is None else device)
    p, n_bytes = sched.p, sched.n_bytes
    if max_rounds is None:
        max_rounds = pk.DEFAULT_MAX_ROUNDS
    generations = sched.rounds()
    n, chunk = _chunking(n_bytes, fabric.mtu)
    lat = fabric.latency
    t_rnr = _rnr_barrier(p, fabric, workers)
    template = pk.resolve_loss(loss, fabric)
    eng = Engine(device=dev)
    carriers = None
    if topology is not None:
        host_list = _placed(topology, hosts, p)
    else:
        host_list = list(range(p))
        recv_link = eng.add_link("leaf.recv", fabric.b_link)
        # one loss process per leaf (its ejection carrier), shared by every
        # chain that reaches it and persistent across generations
        carriers = [pk._AbstractCarrier() for _ in range(p)]
        if template is not None:
            for c in carriers:
                c.loss = template.fork(rng)
        carriers = ({x: [c] for x, c in enumerate(carriers)},
                    {id(c): c.loss for c in carriers}, {id(c): x for x, c in enumerate(carriers)})
    # routed: one loss process per physical link for the whole Allgather
    model_cache: dict[int, object] = {}
    # at jitter 0 every draw is exactly 0.0 and x + 0.0 == x: nothing is
    # drawn, unless later generations fork link models from the generator
    skip_jitter = fabric.jitter == 0.0 and (topology is None or template is None)
    service = chunk / workers.thread_tput
    nack_service = pk._nack_service(n, workers, fabric.mtu)
    nack_wire = pk._nack_wire_bytes(n, fabric.mtu)
    leaves = np.arange(p)
    # the event-level DPA: one persistent progress engine a host
    pools = None
    if dpa_fidelity == "event":
        params = resolve_event_params(dpa, workers.n_recv_workers)
        pools = [DpaEventPool(params) for _ in range(p)]

    def jitter(arr: torch.Tensor, got: torch.Tensor, counts: torch.Tensor) -> None:
        """One sized draw for a pass, added to the arrivals row-major:
        leaf-major, chain-minor, chunks ascending, as the reference draws."""
        if not skip_jitter:
            arr[got] = arr[got] + pk._jitter_on(rng, fabric.jitter, int(counts.sum()), dev)

    t = t_rnr
    traces = []
    mcast_time = rel_time = 0.0
    recovered_total = rnr_total = retx_wire = fast_total = undelivered = 0
    completed = True
    for round_ops in generations:
        chains = [_Chain(sched.ops[i].root, p, lat, topology, host_list, carriers, template,
                         rng, model_cache) for i in round_ops]
        roots = np.array([ch.root for ch in chains])
        m = roots.size
        for ch in chains:
            if ch.tree is not None:
                ch.flow = eng.submit_tree(ch.tree, n * chunk, t_start=t,
                                          tag=f"chain{host_list[ch.root]}")
            else:
                ch.flow = eng.submit(recv_link, n * chunk, t_start=t, tag=f"chain{ch.root}")
        eng.run()
        inject = torch.from_numpy(np.stack([ch.flow.chunk_times(n, chunk)
                                            for ch in chains])).to(dev)
        # abstractly every path is one hop: a scalar, nothing to copy
        hop = lat if topology is None else torch.from_numpy(
            np.stack([ch.hop for ch in chains], 1)).to(dev)[:, :, None]    # (P, M, 1)
        cutoff = max(ch.flow.t_end for ch in chains) + fabric.alpha
        # fast path: (P, M, chunks); a chain sends nothing to its own root
        valid = leaves[:, None] != roots[None, :]
        lost = None if topology is None and template is None else _chain_losses(
            chains, [ch.links() for ch in chains], [n] * m, leaves, n, dev)
        got = torch.from_numpy(valid).to(dev)[:, :, None].expand(p, m, n)
        if lost is not None:
            got = got & ~lost
        counts = got.sum((1, 2))
        arr = torch.where(got, inject[None] + hop, math.inf)
        jitter(arr, got, counts)
        t_floor = torch.full((p,), t, dtype=torch.float64, device=dev)
        leaf_done, rnr = _merged_pool(arr, counts, t_floor, workers, service, pk._BLOCK_ELEMS,
                                      pools, chunk)
        rnr_total += int(rnr.sum())
        missing = rnr if lost is None else lost | rnr
        t_fast = max(t, float(leaf_done.max()))
        mcast_time += max(t_fast - t, 0.0)
        # interleaved recovery: every incomplete chain NACKs and retransmits
        # at once; the retransmissions share the fabric and every leaf's pool
        t_round_end = t_fast
        for _ in range(max_rounds):
            nacking = missing.any(2)                                   # (P, M)
            nack_np = nacking.cpu().numpy()
            live = np.nonzero(nack_np.any(0))[0]
            if live.size == 0:
                break
            rl = np.nonzero(nack_np[:, live].any(1))[0]                # NACKing leaves
            nack_rl = nack_np[np.ix_(rl, live)]                        # (R, L)
            rows, cols = torch.from_numpy(rl).to(dev), torch.from_numpy(live).to(dev)
            miss = missing[rows[:, None], cols[None, :]]               # (R, L, chunks)
            # each live chain's NACK union: pack, OR over the leaves, popcount
            flags = torch.zeros((rl.size, live.size, n + (-n) % 32), dtype=torch.bool,
                                device=dev)
            flags[:, :, :n] = miss
            if profiling.ENABLED:
                with profiling.phase("packing"):
                    agg = bitmap.bitmap_or_rows(bitmap.bitmap_pack(flags.view(rl.size, -1)))
            else:
                agg = bitmap.bitmap_or_rows(bitmap.bitmap_pack(flags.view(rl.size, -1)))
            agg = agg.view(live.size, -1)
            u = bitmap.bitmap_popcount_rows(agg).cpu().numpy()         # (L,)
            union = bitmap.bitmap_unpack(agg, n)                       # (L, chunks)
            done_np = leaf_done.cpu().numpy()
            retx = []
            live_chains = [chains[c] for c in live]
            for li, ch in enumerate(live_chains):   # the chain roots' NACK service (host)
                nackers = rl[nack_rl[:, li]]
                t_send = np.maximum(done_np[nackers], cutoff) + ch.hop[nackers]
                arrivals = np.array([t_send.max()]) if aggregate_nacks else np.sort(t_send)
                # the chain root's DPA serves the NACKs: in event mode the
                # contexts that receive every other chain's stream
                _, t_retx = _serve_nacks(None if pools is None else pools[ch.root], arrivals,
                                         workers, nack_service, nack_wire, int(u[li]), chunk,
                                         eng.now)
                nbytes = int(u[li]) * chunk
                if ch.tree is not None:
                    members = [host_list[ch.root]] + [host_list[x] for x in nackers]
                    flow = eng.submit_tree(topology.multicast_tree(host_list[ch.root], members),
                                           nbytes, t_start=t_retx,
                                           tag=f"chain{host_list[ch.root]}.retx")
                else:
                    flow = eng.submit(recv_link, nbytes, t_start=t_retx,
                                      tag=f"chain{ch.root}.retx")
                retx.append((flow, nackers, arrivals))
                retx_wire += nbytes
            eng.run()
            cutoff = max(f.t_end for f, _, _ in retx) + fabric.alpha
            u_max = int(u.max())
            inj_r = torch.full((live.size, u_max), math.inf, dtype=torch.float64)
            for li, (flow, _, _) in enumerate(retx):
                inj_r[li, :u[li]] = torch.from_numpy(flow.chunk_times(int(u[li]), chunk))
            # each nacker's missing chunks at their union positions: (R, L, u)
            pos = torch.arange(u_max, device=dev)
            upos = torch.where(pos[None, :] < torch.from_numpy(u).to(dev)[:, None],
                               torch.sort((~union).to(torch.uint8), dim=1,
                                          stable=True).indices[:, :u_max], n)
            miss_pad = torch.cat([miss, miss.new_zeros(rl.size, live.size, 1)], 2)
            want = miss_pad.gather(2, upos[None].expand(rl.size, -1, -1))
            # the pruned trees' links only: the links of each chain's nackers
            pruned = [pk._models_on_paths(ch.paths, ch.models, nackers.tolist())
                      for ch, (_, nackers, _) in zip(live_chains, retx)]
            lost = _chain_losses(live_chains, pruned, [int(x) for x in u], rl, u_max, dev)
            got = want if lost is None else want & ~lost
            counts = got.sum((1, 2))
            hop_r = hop if topology is None else hop[rows][:, cols]
            arr = torch.where(got, inj_r.to(dev)[None] + hop_r, math.inf)
            jitter(arr, got, counts)
            t_done, rnr = _merged_pool(arr, counts, leaf_done[rows], workers, service,
                                       pk._BLOCK_ELEMS,
                                       None if pools is None else [pools[x] for x in rl], chunk)
            delivered = got & ~rnr
            rnr_total += int(rnr.sum())
            per_chain = delivered.sum((0, 2)).cpu().numpy()
            recovered_total += int(per_chain.sum())
            cleared = torch.zeros((rl.size, live.size, n + 1), dtype=torch.bool, device=dev)
            cleared.scatter_(2, upos[None].expand(rl.size, -1, -1), delivered)
            missing[rows[:, None], cols[None, :]] = miss & ~cleared[:, :, :n]
            leaf_done[rows] = t_done
            t_round_end = max(t_round_end, float(t_done.max()))
            for li, (flow, nackers, arrivals) in enumerate(retx):
                traces.append(pk.RoundTrace(
                    nack_leaves=int(nackers.size),
                    root_nack_msgs=int(arrivals.shape[0]),
                    union_chunks=int(u[li]),
                    t_nack_root=float(arrivals.max()),
                    t_retx_start=float(flow.t_start),
                    t_end=t_round_end,
                    recovered=int(per_chain[li]),
                ))
        left = int(missing.sum())
        completed &= left == 0
        undelivered += left
        rel_time += max(t_round_end - t_fast, 0.0)
        fast_total += m * (p - 1) * n
        # activation signal to the next generation's roots
        t = max(t_round_end + lat, eng.now)
    # fast = everything neither recovered nor still missing (max_rounds can
    # cut recovery short: completed=False, and the shortfall shows here)
    fast_total -= recovered_total + undelivered
    t_done = t + lat   # final handshake
    return pk.PacketAllgatherResult(
        time=t_done,
        phases=PhaseBreakdown(rnr_sync=t_rnr, multicast=mcast_time, reliability=rel_time,
                              handshake=lat),
        recovered=recovered_total,
        bytes_fast=fast_total * chunk,
        bytes_recovery=recovered_total * chunk,
        bytes_total=p * (p - 1) * n * chunk,
        per_rank_recv_tput=(p - 1) * n_bytes / t_done,
        link_bytes=eng.link_bytes() if topology is not None else {},
        rounds=traces,
        rnr_drops=rnr_total,
        retransmit_wire_bytes=retx_wire,
        completed=completed,
    )


# ------------------------------------------------------------------ execute


def execute(sched: Schedule, fabric: FabricParams | None = None,
            workers: WorkerParams | None = None, rng: np.random.Generator | None = None, *,
            fidelity: str = "fluid", topology=None, hosts=None, loss=None, device=None,
            **kw):
    """Lower ``sched`` onto the chosen fidelity and run it (reference
    sched_ir.py:2051), with the reference's guards: the analytic oracle
    takes no loss, no engine keyword and no ``topology=``/``hosts=``; the
    fluid fidelity takes no loss and no packet keyword; the ring schedules
    at packet fidelity take no packet keyword. Ported, on the abstract
    fabric or a routed topology: the fluid and analytic fidelities for the
    kinds ``broadcast``, ``allgather``, ``ring_allgather`` and
    ``reduce_scatter``; ``fidelity="packet"`` for ``broadcast``
    (``core/packet.simulate_packet_broadcast``), ``allgather``
    (``_packet_allgather``) and the ring kinds (``_packet_ring``), with the
    packet keywords (``max_rounds``, ``aggregate_nacks``, ``engine``, ...)
    in ``kw``; the composite kinds ``allreduce`` (barrier and pipelined)
    and ``hier_allgather`` at every fidelity, their legs through
    ``execute`` (the packet keywords to the multicast Allgather leg); and
    ``fsdp_step`` at the fluid and packet fidelities
    (``core/engine.simulate_fsdp_step`` over the schedule, its compute
    keywords in ``kw``). The engine's vectorized solve and the leaves'
    receive datapath run on ``device`` (default ``cuda``)."""
    if fidelity not in FIDELITIES:
        raise ValueError(f"fidelity must be one of {FIDELITIES}, got {fidelity!r}")
    fabric = fabric or FabricParams()
    workers = workers or WorkerParams()
    rng = rng if rng is not None else np.random.default_rng(0)

    if sched.kind == "fsdp_step":
        from repro_torch.core import engine as engine_mod   # deferred: engine imports us

        if fidelity not in ("fluid", "packet"):
            raise ValueError("fsdp_step supports the fluid and packet fidelities")
        meta = sched.meta
        return engine_mod.simulate_fsdp_step(
            n_layers=meta["n_layers"], layer_bytes=meta["layer_bytes"], p=sched.p,
            fabric=fabric, policy=meta["policy"], n_chains=meta["n_chains"],
            topology=topology, hosts=hosts, fidelity=fidelity, loss=loss, rng=rng,
            workers=workers, schedule=sched, device=device, **meta.get("compute", {}), **kw)

    if fidelity == "analytic":
        if loss is not None or kw:
            raise ValueError("the analytic oracle is lossless and takes no engine options")
        if topology is not None or hosts is not None:
            raise ValueError("the analytic oracle has no routed mode (topology=/hosts=)")
        return _exec_analytic(sched, fabric, workers)

    if fidelity == "fluid":
        if loss is not None:
            raise ValueError("loss models require fidelity='packet'")
        if kw:
            raise ValueError(f"{sorted(kw)} require fidelity='packet'")
    composite = {"hier_allgather": _exec_hier_allgather, "allreduce": _exec_allreduce}
    if sched.kind in composite:
        return composite[sched.kind](sched, fabric, workers, rng, fidelity=fidelity,
                                     topology=topology, hosts=hosts, loss=loss, kw=kw,
                                     device=device)
    if fidelity == "fluid":
        lower = {"broadcast": _fluid_broadcast, "allgather": _fluid_allgather,
                 "ring_allgather": _fluid_ring, "reduce_scatter": _fluid_ring}[sched.kind]
        return lower(sched, fabric, workers, rng, topology=topology, hosts=hosts,
                     device=device)

    if sched.kind == "broadcast":
        from repro_torch.core import packet as pk   # deferred: packet imports this module

        return pk.simulate_packet_broadcast(sched.p, sched.n_bytes, fabric, workers, rng,
                                            sched.ops[0].root, topology=topology, hosts=hosts,
                                            loss=loss, device=device, **kw)
    if sched.kind == "allgather":
        return _packet_allgather(sched, fabric, workers, rng, topology=topology, hosts=hosts,
                                 loss=loss, device=device, **kw)
    if kw:
        raise ValueError(f"{sorted(kw)} not supported for ring schedules (RC transport)")
    return _packet_ring(sched, fabric, workers, rng, topology=topology, hosts=hosts, loss=loss,
                        device=device)


# ------------------------------------------------------------------ autotune


def autotune_chains(schedule_builder, topology=None, *, p: int, n_bytes: int,
                    fabric: FabricParams | None = None, workers: WorkerParams | None = None,
                    candidates=None, fidelity: str = "fluid", seed: int = 0, cache=None,
                    device=None) -> tuple[int, dict[int, float]]:
    """Sweep the chain count M of ``schedule_builder(p, n_bytes, m)`` on a
    fabric and pick the fastest (reference sched_ir.py:2149): the §IV-A
    incast knob, full parallelism on flat fabrics, fewer chains where the
    fabric or the leaf pool is the bottleneck. Returns (best M, {M: time}).
    Candidates default to the divisors of P. The 1-D case of
    ``core/sched_search.py``: it delegates to ``sweep_chains`` with its
    memoized ``cache=`` (an ``EvalCache``), evaluating on ``device``."""
    from repro_torch.core import sched_search   # deferred: sched_search imports this module

    fabric = fabric or FabricParams(jitter=0.0)
    workers = workers or WorkerParams(n_recv_workers=8)
    if candidates is None:
        candidates = [m for m in range(1, p + 1) if p % m == 0]
    return sched_search.sweep_chains(schedule_builder, topology, p=p, n_bytes=n_bytes,
                                     fabric=fabric, workers=workers, candidates=candidates,
                                     fidelity=fidelity, seed=seed, cache=cache, device=device)
