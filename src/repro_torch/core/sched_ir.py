"""Collective schedule IR: the typed schedule graph of the paper's
collectives, and its packet-fidelity lowering for the Broadcast and the
M-chain Allgather.

Port of ``src/repro/core/sched_ir.py`` as far as the packet Broadcast and
Allgather in abstract-fabric mode use it:

- ``PhaseBreakdown``, ``_chunking``, ``_rnr_barrier`` (sched_ir.py:79-129;
  the fluid lowering's ``BcastResult`` and ``AllgatherResult`` come with it);
- the ops ``Multicast``, ``Unicast``, ``Reduce`` and ``Schedule`` with its
  activation DAG, ``rounds()`` and ``n_rounds`` (:136-243);
- ``payload_bytes``, ``canonical_key``, ``validate`` (:246-336);
- the builders ``build_broadcast_tree`` and ``build_allgather`` (:339-362);
- ``execute(..., fidelity="packet")`` for the kinds ``broadcast`` (which
  lowers to ``core/packet.simulate_packet_broadcast``) and ``allgather``
  (``_packet_allgather``, :1163-1879, its vectorized executor).

A Schedule is a DAG of typed ops joined by activation edges, the §IV-A
chain signal ("when I finish multicasting I activate my chain
successor"); "round r" is the r-th topological generation of the DAG. The
other builders (ring, hierarchical, reduce-scatter, all-reduce, pipelined,
``build_fsdp_step``) and the fluid and analytic lowerings are queued in
ROADMAP.md (§1, item 5): ``execute`` raises ``NotImplementedError`` for
them, naming that item.
"""
from __future__ import annotations

import hashlib
import math
from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import schedule as seq
from repro_torch.core.engine import Engine, FabricParams, WorkerParams, worker_pool_completion
from repro_torch.device import device_of
from repro_torch.kernels import bitmap, pool

FIDELITIES = ("analytic", "fluid", "packet")
KINDS = ("broadcast", "allgather", "ring_allgather", "reduce_scatter",
         "allreduce", "hier_allgather", "fsdp_step")
#: per-op transport tags (None: let the fabric route); multicast is
#: switched-only, islands have no switch replication
TRANSPORTS = (None, "intra_host", "island", "switched")
_QUEUED = "ROADMAP.md §1, item 5: the fluid and analytic lowerings and the other builders"


# -------------------------------------------------------------- shared pieces


@dataclass
class PhaseBreakdown:
    rnr_sync: float = 0.0
    multicast: float = 0.0
    reliability: float = 0.0
    handshake: float = 0.0

    def total(self) -> float:
        return self.rnr_sync + self.multicast + self.reliability + self.handshake


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


# --------------------------------------------------- packet-fidelity Allgather


def _check_packet_options(topology, hosts, dpa_fidelity: str, dpa, engine: str) -> None:
    """The reference's packet options that the port does not have raise, as
    ``simulate_packet_broadcast`` raises them."""
    if topology is not None or hosts is not None:
        raise NotImplementedError("topology=/hosts=: the routed FatTree mode is not "
                                  "ported yet (ROADMAP.md §1, item 6)")
    if dpa_fidelity != "scalar" or dpa is not None:
        raise NotImplementedError("dpa_fidelity='event' / dpa=: the event-level DPA is not "
                                  "ported yet (ROADMAP.md §1, item 7)")
    if engine == "reference":
        raise NotImplementedError("engine='reference': only the vectorized executor is "
                                  "ported (ROADMAP.md)")
    if engine not in ("auto", "vectorized"):
        raise ValueError(f"engine must be 'auto', 'vectorized' or 'reference', got {engine!r}")


def _draw_losses(models: list, leaves, sizes: np.ndarray) -> np.ndarray | None:
    """The drop masks of a pass, on the host, in the reference's order. For
    each leaf row k (``leaves[k]``), ``sizes[k]`` lists the packets of each
    of its sends in chain order (0: none); each leaf's loss process draws
    its sends in that order (``LossModel.sample_runs``). Returns the
    concatenation over the rows, row-major (None where no leaf has a loss
    process: nothing is drawn)."""
    if all(models[leaf] is None for leaf in leaves):
        return None
    parts = []
    for leaf, row in zip(leaves, sizes):
        runs = [int(s) for s in row if s]
        if models[leaf] is None:
            parts.append(np.zeros(sum(runs), dtype=bool))
        else:
            parts.append(models[leaf].sample_runs(runs))
    return np.concatenate(parts) if parts else np.zeros(0, dtype=bool)


def _merged_pool(arr: torch.Tensor, counts: torch.Tensor, t_floor: torch.Tensor,
                 workers: WorkerParams, service: float, block_elems: int):
    """Every leaf's worker pool fed the merged stream of all chains, as one
    pass over a (rows, chains, width) arrival matrix on its device. ``arr``
    holds each delivered chunk's arrival time and +inf where nothing
    arrives (a chain's own root, a lost or unwanted chunk); a row is laid
    out chains in order, chunks ascending, so the stable sort breaks the
    exact ties between chains (jitter 0) as the reference's stable argsort
    of its concatenated rows does, and the +inf sentinels sort past the
    real entries. ``counts`` (rows,) are the real entries a row. Rows go
    through the pool kernel in blocks of ``block_elems`` elements (one
    launch at every shape this port's checks run). Returns (t_done (rows,):
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
        vals, order = torch.sort(rows[b0:b1], dim=1, stable=True)
        done, drop = pool.pool_completion_rows(vals, workers.n_recv_workers, service,
                                               workers.staging_chunks)
        real = pos[None, :] < counts[b0:b1, None]
        last = torch.where(real, done, -math.inf).amax(1)
        t_done[b0:b1] = torch.where(counts[b0:b1] > 0, last, t_floor[b0:b1])
        rnr[b0:b1] = torch.zeros_like(drop).scatter_(1, order, drop)
    return t_done, rnr.view(b, m, w)


def _packet_allgather(sched: Schedule, fabric: FabricParams, workers: WorkerParams,
                      rng: np.random.Generator, *, topology=None, hosts=None, loss=None,
                      max_rounds: int | None = None, aggregate_nacks: bool = True,
                      dpa_fidelity: str = "scalar", dpa=None, engine: str = "auto",
                      device=None):
    """Packet-fidelity lowering of an allgather schedule (reference
    sched_ir.py:1210, the vectorized executor, abstract fabric, scalar DPA).

    Each generation of the activation DAG runs its chain roots' Broadcasts
    at once: every chain's flow, and every retransmission, shares the one
    link ``leaf.recv`` of a single fluid engine (host); every leaf's worker
    pool serves the merged arrivals of all chains; a generation's
    activation of the next waits for all its chains and their recovery.

    Host: the engine, and every random draw in the reference's order (one
    loss process per leaf for the whole Allgather, forked in leaf order
    0..P-1, drawn by each chain for its non-root leaves in chain order, and
    in recovery by each chain for its NACKing leaves; one sized jitter draw
    per pass, leaf-major and chain-minor). ``device``: the leaves x chains
    x chunks state (the missing flags (P, M, chunks), the merged arrival
    matrix, its stable sort, the pool pass on ``csrc/pool.cu``), and each
    round's NACK unions, every live chain's at once: the missing rows of
    the NACKing leaves packed to u32 words (``csrc/bitmap.cu``), the rows
    OR-ed, a popcount per chain. A generation's fast path is one pool
    launch and a recovery round one pool, pack, OR and popcount launch,
    whatever the number of leaves and chains (the pool's rows in blocks of
    ``_BLOCK_ELEMS`` elements)."""
    from repro_torch.core import packet as pk   # deferred: packet imports this module

    _check_packet_options(topology, hosts, dpa_fidelity, dpa, engine)
    dev = device_of("cuda" if device is None else device)
    p, n_bytes = sched.p, sched.n_bytes
    if max_rounds is None:
        max_rounds = pk.DEFAULT_MAX_ROUNDS
    generations = sched.rounds()
    n, chunk = _chunking(n_bytes, fabric.mtu)
    lat = fabric.latency
    t_rnr = _rnr_barrier(p, fabric, workers)
    template = pk.resolve_loss(loss, fabric)
    eng = Engine()
    recv_link = eng.add_link("leaf.recv", fabric.b_link)
    # one loss process per leaf (its ejection carrier), shared by every
    # chain that reaches it and persistent across generations
    models = [template.fork(rng) if template is not None else None for _ in range(p)]
    # at jitter 0 every draw is exactly 0.0 and x + 0.0 == x: nothing is drawn
    skip_jitter = fabric.jitter == 0.0
    service = chunk / workers.thread_tput
    nack_service = pk._nack_service(n, workers, fabric.mtu)
    leaves = np.arange(p)

    def jitter(arr: torch.Tensor, got: torch.Tensor, counts: torch.Tensor) -> None:
        """One sized draw for a pass, added to the arrivals row-major:
        leaf-major, chain-minor, chunks ascending, as the reference draws."""
        if not skip_jitter:
            jit = rng.uniform(0.0, fabric.jitter, size=int(counts.sum()))
            arr[got] = arr[got] + torch.from_numpy(jit).to(dev)

    t = t_rnr
    traces = []
    mcast_time = rel_time = 0.0
    recovered_total = rnr_total = retx_wire = fast_total = undelivered = 0
    completed = True
    for round_ops in generations:
        roots = np.array([sched.ops[i].root for i in round_ops])
        m = roots.size
        flows = [eng.submit(recv_link, n * chunk, t_start=t, tag=f"chain{r}") for r in roots]
        eng.run()
        inject = torch.from_numpy(np.stack([f.chunk_times(n, chunk) for f in flows])).to(dev)
        cutoff = max(f.t_end for f in flows) + fabric.alpha
        # fast path: (P, M, chunks); a chain sends nothing to its own root
        valid = leaves[:, None] != roots[None, :]
        lost_flat = _draw_losses(models, leaves, np.where(valid, n, 0))
        got = torch.from_numpy(valid).to(dev)[:, :, None].expand(p, m, n)
        if lost_flat is not None:
            lost = torch.zeros((p, m, n), dtype=torch.bool, device=dev)
            lost[got] = torch.from_numpy(lost_flat).to(dev)
            got = got & ~lost
        counts = got.sum((1, 2))
        arr = torch.where(got, inject[None] + lat, math.inf)
        jitter(arr, got, counts)
        t_floor = torch.full((p,), t, dtype=torch.float64, device=dev)
        leaf_done, rnr = _merged_pool(arr, counts, t_floor, workers, service, pk._BLOCK_ELEMS)
        rnr_total += int(rnr.sum())
        missing = rnr if lost_flat is None else lost | rnr
        t_fast = max(t, float(leaf_done.max()))
        mcast_time += max(t_fast - t, 0.0)
        # interleaved recovery: every incomplete chain NACKs and retransmits
        # at once; the retransmissions share the link and every leaf's pool
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
            agg = bitmap.bitmap_or_rows(bitmap.bitmap_pack(flags.view(rl.size, -1)))
            agg = agg.view(live.size, -1)
            u = bitmap.bitmap_popcount_rows(agg).cpu().numpy()         # (L,)
            union = bitmap.bitmap_unpack(agg, n)                       # (L, chunks)
            done_np = leaf_done.cpu().numpy()
            retx = []
            for li in range(live.size):   # the chain roots' NACK service (host)
                nackers = rl[nack_rl[:, li]]
                t_send = np.maximum(done_np[nackers], cutoff) + lat
                arrivals = np.array([t_send.max()]) if aggregate_nacks else np.sort(t_send)
                done, _ = worker_pool_completion(arrivals, workers.n_recv_workers,
                                                 nack_service, workers.staging_chunks)
                t_retx = max(float(done[-1]), eng.now)
                flow = eng.submit(recv_link, int(u[li]) * chunk, t_start=t_retx,
                                  tag=f"chain{roots[live[li]]}.retx")
                retx.append((flow, nackers.size, arrivals))
                retx_wire += int(u[li]) * chunk
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
            lost_flat = _draw_losses(models, rl, np.where(nack_rl, u[None, :], 0))
            got = want
            if lost_flat is not None:
                sent = torch.from_numpy(nack_rl).to(dev)[:, :, None] & (
                    pos[None, None, :] < torch.from_numpy(u).to(dev)[None, :, None])
                lost = torch.zeros_like(want)
                lost[sent] = torch.from_numpy(lost_flat).to(dev)
                got = want & ~lost
            counts = got.sum((1, 2))
            arr = torch.where(got, inj_r.to(dev)[None] + lat, math.inf)
            jitter(arr, got, counts)
            t_done, rnr = _merged_pool(arr, counts, leaf_done[rows], workers, service,
                                       pk._BLOCK_ELEMS)
            delivered = got & ~rnr
            rnr_total += int(rnr.sum())
            per_chain = delivered.sum((0, 2)).cpu().numpy()
            recovered_total += int(per_chain.sum())
            cleared = torch.zeros((rl.size, live.size, n + 1), dtype=torch.bool, device=dev)
            cleared.scatter_(2, upos[None].expand(rl.size, -1, -1), delivered)
            missing[rows[:, None], cols[None, :]] = miss & ~cleared[:, :, :n]
            leaf_done[rows] = t_done
            t_round_end = max(t_round_end, float(t_done.max()))
            for li, (flow, n_nack, arrivals) in enumerate(retx):
                traces.append(pk.RoundTrace(
                    nack_leaves=int(n_nack),
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
        link_bytes={},
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
    sched_ir.py:2051). Ported: ``fidelity="packet"`` for the kinds
    ``broadcast`` (``core/packet.simulate_packet_broadcast``) and
    ``allgather`` (``_packet_allgather``), with the packet keywords
    (``max_rounds``, ``aggregate_nacks``, ``engine``, ...) in ``kw``; the
    leaves' receive datapath runs on ``device`` (default ``cuda``). Every
    other fidelity or kind raises ``NotImplementedError``."""
    if fidelity not in FIDELITIES:
        raise ValueError(f"fidelity must be one of {FIDELITIES}, got {fidelity!r}")
    fabric = fabric or FabricParams()
    workers = workers or WorkerParams()
    rng = rng if rng is not None else np.random.default_rng(0)
    if fidelity != "packet":
        raise NotImplementedError(f"fidelity={fidelity!r} is not ported yet ({_QUEUED})")
    if sched.kind == "broadcast":
        from repro_torch.core import packet as pk   # deferred: packet imports this module

        return pk.simulate_packet_broadcast(sched.p, sched.n_bytes, fabric, workers, rng,
                                            sched.ops[0].root, topology=topology, hosts=hosts,
                                            loss=loss, device=device, **kw)
    if sched.kind == "allgather":
        return _packet_allgather(sched, fabric, workers, rng, topology=topology, hosts=hosts,
                                 loss=loss, device=device, **kw)
    raise NotImplementedError(f"kind {sched.kind!r} is not ported yet ({_QUEUED})")
