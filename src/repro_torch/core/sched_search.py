"""Throughput-optimal schedule search over the collective schedule IR.

Port of ``src/repro/core/sched_search.py``, its whole public surface. Given
a collective and a ``Topology`` (ForestColl, arXiv:2402.06787: optimal
schedules follow from the fabric's cuts), the searcher

  1. seeds the search with every builder of ``sched_ir`` (so it can only
     match or beat them),
  2. derives candidates from the fabric's structure: chain counts M from
     the tier capacities, the ring AG against the multicast AG, RS o AG
     pipelined in segments (``build_pipelined_allreduce``), and on island
     fabrics (``topology.IslandFatTree``) hierarchical Allgathers
     (``build_hierarchical_allgather``) moved by regrouping, fan-out and
     transport flips (``hier_candidates``),
  3. scores them with ``sched_ir.execute`` at fluid fidelity through a
     memoized cache keyed on the schedule's content hash and the
     evaluation's context, pruning branch-and-bound style: a candidate
     whose admissible lower bound (the ``protocol.analytic_*`` closed form,
     maxed with bytes across a fabric cut over its capacity) meets the
     incumbent is cut unsimulated,
  4. validates the winner at packet fidelity and reports a
     ``protocol.BoundCertificate``.

``sched_ir.autotune_chains`` is its 1-D case (``sweep_chains``), on the
same cache.

The evaluations run on ``device`` (default ``cuda``; ``device="cpu"`` on
request): the fluid engine's vectorized solve and the Allgather
generations' pool passes, and the packet validation's receive datapath.
``EvalContext`` carries the device, but its ``key()`` leaves it out and is
the reference's key for the same arguments: an evaluation on the card
equals the CPU's field for field, so one cache entry serves both.

The parallel tier (``search(n_jobs > 1)``) evaluates in a process pool
started with ``spawn`` on every device (a process forked after CUDA is
initialised cannot use the card), each child on the caller's device. The
children load the pool kernel the parent built: the parent builds it
before the pool starts (``kernels/build.py`` takes no lock).

Why the bounds are admissible:

* the closed forms: every host ingests the collective's bytes through its
  NIC at the slower of wire and worker pool; on a topology the host's
  attach capacity is at most the fastest tier's, so the closed form at
  ``b = max(tier_capacities)`` bounds the routed fluid time too (latency
  only grows with hops);
* the fabric cuts: in the max-min model the rate across a cut never
  exceeds its links' capacity, so the bytes that must cross it over its
  capacity bound the completion time. A multicast is counted once a
  crossing, which undercounts the routed lowering: conservative;
* the pipelined Allreduce: ``protocol.pipeline_schedule_time`` is monotone
  in every stage time, so per-segment lower bounds give a lower bound.
"""
from __future__ import annotations

import json
import math
import os
import time as _time
from dataclasses import astuple, dataclass

import numpy as np
import torch

from repro_torch.core import protocol, sched_ir
from repro_torch.core.engine import FabricParams, WorkerParams
from repro_torch.core.sched_ir import Multicast, Reduce, Schedule, Unicast

COLLECTIVES = ("broadcast", "allgather", "reduce_scatter", "allreduce")

# RS∘AG pipelining depths tried for derived allreduce candidates.
SEGMENT_CANDIDATES = (2, 4, 8)


# ------------------------------------------------------------ eval context


def _topology_key(topology):
    if topology is None:
        return None
    sig = getattr(topology, "signature", None)
    # shape-identical topologies share cache entries; anything without a
    # signature() is keyed by identity (deterministic: evaluate() resets it)
    return sig() if sig is not None else ("id", id(topology))


@dataclass(frozen=True)
class EvalContext:
    """Everything besides the schedule that determines an evaluation's
    outcome, the second half of the cache key; and the device the
    evaluation runs on, which ``key()`` leaves out (the card's evaluation
    equals the CPU's), so the key is the reference's."""
    fabric: FabricParams
    workers: WorkerParams
    topology: object = None
    hosts: tuple | None = None
    fidelity: str = "fluid"
    seed: int = 0
    device: object = None

    def key(self) -> tuple:
        return (astuple(self.fabric), astuple(self.workers),
                _topology_key(self.topology), self.hosts, self.fidelity,
                self.seed)


@dataclass
class EvalResult:
    time: float
    fabric_bytes: float          # routed bytes (sum of link_bytes on a
                                 # topology; payload bytes otherwise)


def _evaluate_uncached(sched: Schedule, ctx: EvalContext) -> EvalResult:
    """One fluid or analytic evaluation on ``ctx.device``, unmemoized: the
    unit of work the cache memoizes and the process pool ships out."""
    if ctx.topology is not None:
        ctx.topology.reset()
    if ctx.fidelity == "analytic":
        res = sched_ir.execute(sched, ctx.fabric, ctx.workers,
                               fidelity="analytic")
        return EvalResult(time=float(res),
                          fabric_bytes=sched_ir.payload_bytes(sched))
    res = sched_ir.execute(
        sched, ctx.fabric, ctx.workers,
        np.random.default_rng(ctx.seed), fidelity=ctx.fidelity,
        topology=ctx.topology,
        hosts=list(ctx.hosts) if ctx.hosts is not None else None,
        device=ctx.device)
    if ctx.topology is not None and res.link_bytes:
        fabric_bytes = float(sum(res.link_bytes.values()))
    else:
        fabric_bytes = sched_ir.payload_bytes(sched)
    return EvalResult(time=res.time, fabric_bytes=fabric_bytes)


def _key_persistable(key: tuple) -> bool:
    """Disk-persistable cache keys only: a topology keyed by object identity
    (no ``signature()``) is process-local, so its entries never leave RAM."""
    topo_key = key[1][2]
    return not (isinstance(topo_key, tuple) and len(topo_key) == 2
                and topo_key[0] == "id")


class EvalCache:
    """Memoized schedule evaluations keyed on (canonical schedule hash,
    context key). Shared between search(), sweep_chains() and
    sched_ir.autotune_chains so repeated sweeps over the same fabric never
    re-simulate a schedule.

    With ``path=`` the cache is *content-addressed on disk* too: entries
    load on construction (a disk hit counts toward ``hits`` like any other)
    and ``save()`` writes them back atomically, keyed by
    ``repr((canonical_key, ctx.key()))`` — repr of the float/str/tuple key
    is deterministic, so runs in different processes address the same
    entries. Identity-keyed topology entries (``("id", ...)`` — no
    ``signature()``) are never persisted: ids are process-local.
    ``search()``/``sweep_chains()`` save automatically on completion, so
    repeated runs and ``autotune_chains`` reuse scores across
    processes."""

    def __init__(self, path: str | None = None) -> None:
        self._store: dict[tuple, EvalResult] = {}
        self._bounds: dict[tuple, tuple[float, str]] = {}
        self.hits = 0
        self.misses = 0
        self.path = path
        self._disk: dict[str, list] = {}
        self._disk_bounds: dict[str, list] = {}
        self._spaces: dict[tuple, list[Candidate]] = {}
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    payload = json.load(f)
                if payload.get("version") != 1:
                    raise ValueError(f"cache version {payload.get('version')}")
                self._disk = payload["entries"]
                self._disk_bounds = payload.get("bounds", {})
            except (OSError, ValueError, KeyError):
                self._disk = {}    # corrupt/foreign file: start cold
                self._disk_bounds = {}

    @classmethod
    def persistent(cls) -> "EvalCache":
        """A cache at ``$REPRO_EVAL_CACHE`` (in-memory only when unset) —
        the hook that carries scores across runs."""
        return cls(os.environ.get("REPRO_EVAL_CACHE") or None)

    def __len__(self) -> int:
        return len(self._store)

    def evaluate(self, sched: Schedule, ctx: EvalContext) -> EvalResult:
        key = (sched_ir.canonical_key(sched), ctx.key())
        got = self._store.get(key)
        if got is None and self._disk:
            row = self._disk.get(repr(key))
            if row is not None:
                got = EvalResult(time=row[0], fabric_bytes=row[1])
                self._store[key] = got
        if got is not None:
            self.hits += 1
            return got
        self.misses += 1
        out = _evaluate_uncached(sched, ctx)
        self._store[key] = out
        return out

    def bound(self, sched: Schedule, ctx: EvalContext) -> tuple[float, str]:
        """Memoized ``lower_bound`` — the bound is a pure function of
        (schedule content, context), so warm searches skip the analytic
        executor entirely. Persisted alongside the evaluations (same
        identity-key exclusion)."""
        key = (sched_ir.canonical_key(sched), ctx.key())
        got = self._bounds.get(key)
        if got is None and self._disk_bounds:
            row = self._disk_bounds.get(repr(key))
            if row is not None:
                got = (row[0], row[1])
                self._bounds[key] = got
        if got is None:
            got = lower_bound(sched, ctx)
            self._bounds[key] = got
        return got

    def space(self, collective: str, p: int, n_bytes: int, topology=None) -> list[Candidate]:
        """``candidates(collective, p, n_bytes, topology)``, built once per
        fabric shape and move generators and kept in memory: a search that
        reruns on this cache reuses the schedules (their content hashes and
        validation with them) instead of building them anew. A fabric
        keyed by identity is built each time (an id can be reused)."""
        topo_key = _topology_key(topology)
        if isinstance(topo_key, tuple) and len(topo_key) == 2 and topo_key[0] == "id":
            return candidates(collective, p, n_bytes, topology)
        key = (collective, p, n_bytes, topo_key, hier_candidates, chain_candidates)
        if key not in self._spaces:
            self._spaces[key] = candidates(collective, p, n_bytes, topology)
        return list(self._spaces[key])

    def save(self) -> None:
        """Atomically persist the persistable entries (no-op without a
        path). Merges over what is already on disk, so concurrent sweeps
        only ever add entries."""
        if not self.path:
            return
        entries = dict(self._disk)
        entries.update({
            repr(k): [r.time, r.fabric_bytes]
            for k, r in self._store.items() if _key_persistable(k)})
        bounds = dict(self._disk_bounds)
        bounds.update({
            repr(k): [b, binding]
            for k, (b, binding) in self._bounds.items()
            if _key_persistable(k)})
        tmp = f"{self.path}.tmp.{os.getpid()}"
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        with open(tmp, "w") as f:
            json.dump({"version": 1, "entries": entries, "bounds": bounds}, f)
        os.replace(tmp, self.path)
        self._disk = entries
        self._disk_bounds = bounds


# ------------------------------------------------------------ lower bounds


def cut_lower_bound(sched: Schedule, topology, hosts=None) -> float:
    """max over bottleneck cuts of bytes-that-must-cross / cut-capacity.
    A true fluid-model lower bound (see module docstring); returns 0.0 when
    the topology exposes no cuts."""
    cuts = getattr(topology, "bottleneck_cuts", None)
    if cuts is None:
        return 0.0
    host_of = list(hosts) if hosts is not None else list(range(sched.p))
    best = 0.0
    for cut in cuts():
        inside = cut.hosts
        b_in = b_out = 0.0
        for op in sched.ops:
            if isinstance(op, Multicast):
                root_in = host_of[op.root] in inside
                memb = [host_of[r] in inside for r in op.group
                        if r != op.root]
                if not root_in and any(memb):
                    b_in += op.nbytes
                if root_in and not all(memb):
                    b_out += op.nbytes
            elif isinstance(op, Unicast):
                src_in = host_of[op.src] in inside
                dst_in = host_of[op.dst] in inside
                if not src_in and dst_in:
                    b_in += op.nbytes
                elif src_in and not dst_in:
                    b_out += op.nbytes
            elif isinstance(op, Reduce):
                dst_in = host_of[op.dst] in inside
                for s in op.srcs:
                    src_in = host_of[s] in inside
                    if not src_in and dst_in:
                        b_in += op.nbytes
                    elif src_in and not dst_in:
                        b_out += op.nbytes
        if cut.cap_in > 0:
            best = max(best, b_in / cut.cap_in)
        if cut.cap_out > 0:
            best = max(best, b_out / cut.cap_out)
    return best


def lower_bound(sched: Schedule, ctx: EvalContext) -> tuple[float, str]:
    """Admissible lower bound on ``sched``'s fluid time in ``ctx``; returns
    (bound, binding) where binding names the binding constraint
    ("analytic" or "cut:<name-of-tier>"). Tiered hier_allgather schedules
    get the tiered closed form (protocol.analytic_hier_allgather_time):
    the stripe term at the switched-tier host attach, the island-ring term
    at the fastest tier capacity — both upper bounds on the respective
    phase's ingest rate, so the form stays admissible per phase."""
    fabric = ctx.fabric
    binding = "analytic"
    tier_caps: dict[str, float] = {}
    if ctx.topology is not None:
        tiers = getattr(ctx.topology, "tier_capacities", None)
        tier_caps = tiers() if tiers is not None else {}
    if sched.kind == "hier_allgather":
        w = ctx.workers
        # switched attach for phase B ("host" NIC on island fabrics);
        # fastest tier for the phase-C ring hop — each generous, hence safe
        b_stripe = tier_caps.get("host", max(tier_caps.values())
                                 if tier_caps else fabric.b_link)
        b_ring = max(tier_caps.values()) if tier_caps else fabric.b_link
        bound = protocol.analytic_hier_allgather_time(
            sched.p, sched.n_bytes, b_stripe, fabric.latency,
            island_size=sched.meta["island_size"], m=sched.meta.get("m"),
            stripe_mode=sched.meta["stripe_mode"],
            pool_rate=w.n_recv_workers * w.thread_tput,
            rnr_hop=w.rnr_barrier_hop, b_island=b_ring)
        if ctx.topology is not None:
            cut = cut_lower_bound(sched, ctx.topology, ctx.hosts)
            if cut > bound:
                bound, binding = cut, "cut"
        return bound, binding
    if ctx.topology is not None:
        # the closed forms assume a single NIC at b_link; on a fabric a
        # host's attach capacity is its boundary cut (a Torus2D node has 4
        # incident links -> 4x one link's rate). Evaluate at the
        # representative single-host cut's capacity — an upper bound on
        # ingest rate for these tier-symmetric fabrics, so the closed form
        # stays a lower bound — falling back to the fastest tier.
        b_eff = None
        cuts_fn = getattr(ctx.topology, "bottleneck_cuts", None)
        if cuts_fn is not None:
            solo = [max(c.cap_in, c.cap_out) for c in cuts_fn()
                    if len(c.hosts) == 1]
            if solo:
                b_eff = max(solo)
        if b_eff is None:
            tiers = getattr(ctx.topology, "tier_capacities", None)
            caps = tiers() if tiers is not None else {}
            b_eff = max(caps.values()) if caps else None
        if b_eff is not None:
            from dataclasses import replace
            fabric = replace(fabric, b_link=b_eff)
    bound = sched_ir.execute(sched, fabric, ctx.workers, fidelity="analytic")
    if ctx.topology is not None:
        cut = cut_lower_bound(sched, ctx.topology, ctx.hosts)
        if cut > bound:
            bound, binding = cut, "cut"
    return bound, binding


# ------------------------------------------------------- candidate space


@dataclass(frozen=True)
class Candidate:
    name: str
    sched: Schedule
    origin: str                  # "builder" (seed) or "derived"


def chain_candidates(p: int, topology=None) -> list[int]:
    """Chain counts M to sweep: divisors of P (the autotune_chains default)
    plus cut-structure-derived suggestions — on an oversubscribed fabric
    the tier-capacity ratio says roughly how many concurrent chains the
    thin tier can carry, so P/ratio (and its neighbours) join the set."""
    ms = {m for m in range(1, p + 1) if p % m == 0}
    if topology is not None:
        tiers = getattr(topology, "tier_capacities", None)
        if tiers is not None:
            caps = tiers()
            if caps and min(caps.values()) > 0:
                ratio = max(caps.values()) / min(caps.values())
                m_star = max(1, min(p, round(p / ratio)))
                ms.update(x for x in (m_star, m_star + 1, max(1, m_star - 1))
                          if 1 <= x <= p)
    return sorted(ms)


def hier_candidates(p: int, n_bytes: int, topology=None, *,
                    fanout_moves: bool = True) -> list[Candidate]:
    """Tiered-fabric allgather candidates: on a topology exposing islands
    (``island_size``), seed the canonical hierarchical builder (the fabric's
    own island grouping, one chain per stripe) and derive the searcher's
    mutation moves around it —

      island-grouping: regroup into sub-islands g' | island_size (a smaller
        ring still rides the island-tier cables; g' = island_size is the
        physical grouping),
      chain-count: M per stripe seeded from ``tier_capacities()`` (the
        island/switched capacity ratio says how many switched chains the
        stripe NICs carry), plus the M=1 / full-parallel endpoints,
      fan-out/depth mutations: halve/double the chain fan-out around M*
        (M chains per generation is the activation tree's fan-out; the
        chain depth R = ceil(I/M) moves inversely), probing the incast
        knee the capacity-ratio seed can straddle — disable with
        ``fanout_moves=False`` (the never-worsened regression pin),
      transport flips: stripe multicast -> routed unicast ring
        (stripe_mode="ring") and island redistribution -> back over the
        switched tier (redistribute_transport="switched").
    """
    g0 = getattr(topology, "island_size", None)
    if g0 is None or p % g0 != 0 or p // g0 < 2:
        return []
    caps = topology.tier_capacities()
    ratio = (max(caps.values()) / min(caps.values())
             if caps and min(caps.values()) > 0 else 1.0)
    out: list[Candidate] = []
    for g in (d for d in range(2, g0 + 1) if g0 % d == 0):
        n_islands = p // g
        m_star = max(1, min(n_islands, round(n_islands / ratio)))
        base_ms = sorted({1, m_star, n_islands})
        for i, m in enumerate(base_ms):
            out.append(Candidate(
                f"{'builder' if (i == 0 and g == g0) else 'derived'}"
                f":hier[g={g},m={m}]",
                sched_ir.build_hierarchical_allgather(p, n_bytes, g, m),
                "builder" if (i == 0 and g == g0) else "derived"))
        if fanout_moves:
            for m in sorted({max(1, m_star // 2),
                             min(n_islands, 2 * m_star)} - set(base_ms)):
                out.append(Candidate(
                    f"derived:hier[g={g},m={m},fanout]",
                    sched_ir.build_hierarchical_allgather(p, n_bytes, g, m),
                    "derived"))
        out.append(Candidate(
            f"derived:hier[g={g},ring-stripe]",
            sched_ir.build_hierarchical_allgather(p, n_bytes, g,
                                                  stripe_mode="ring"),
            "derived"))
        out.append(Candidate(
            f"derived:hier[g={g},m={m_star},switched-redist]",
            sched_ir.build_hierarchical_allgather(
                p, n_bytes, g, m_star, redistribute_transport="switched"),
            "derived"))
    return out


def candidates(collective: str, p: int, n_bytes: int,
               topology=None) -> list[Candidate]:
    """The search space: builder seeds first (force-evaluated so the
    incumbent equals the best hand-written schedule before any pruning),
    then derived candidates."""
    if collective not in COLLECTIVES:
        raise ValueError(f"collective must be one of {COLLECTIVES}, got {collective!r}")
    out: list[Candidate] = []
    if collective == "broadcast":
        out.append(Candidate("builder:tree",
                             sched_ir.build_broadcast_tree(p, n_bytes),
                             "builder"))
        return out
    if collective == "reduce_scatter":
        out.append(Candidate("builder:ring",
                             sched_ir.build_ring_reduce_scatter(p, n_bytes),
                             "builder"))
        return out
    ms = chain_candidates(p, topology)
    if collective == "allgather":
        out.append(Candidate("builder:ring",
                             sched_ir.build_ring_allgather(p, n_bytes),
                             "builder"))
        for m in ms:
            origin = "builder" if p % m == 0 else "derived"
            out.append(Candidate(f"{origin}:mcast[m={m}]",
                                 sched_ir.build_allgather(p, n_bytes, m),
                                 origin))
        out += hier_candidates(p, n_bytes, topology)
        return out
    # allreduce: barrier builders (ring AG and every M-chain AG), then the
    # derived segment-pipelined schedules (extra Activation edges let
    # segment s+1's RS overlap segment s's AG)
    out.append(Candidate("builder:rs+ring_ag",
                         sched_ir.build_allreduce(p, n_bytes, None),
                         "builder"))
    builder_ms = [m for m in ms if p % m == 0]
    for m in builder_ms:
        out.append(Candidate(f"builder:rs+mcast_ag[m={m}]",
                             sched_ir.build_allreduce(p, n_bytes, m),
                             "builder"))
    # pipelined candidates sweep segments x a TRIMMED chain grid ({ring,
    # full-parallel, cut-derived}) — the full divisor grid already ran as
    # barrier seeds, and each pipelined eval costs n_segments engine runs,
    # so the 2-D product must stay small to hold the P<=64 wall budget
    cut_ms = sorted(set(ms) - set(m for m in ms if p % m == 0))
    seg_ms = [None, p] + [m for m in (p // 2,) if p % 2 == 0 and p // 2 >= 1] \
        + cut_ms
    seg_ms = list(dict.fromkeys(seg_ms))
    for s in SEGMENT_CANDIDATES:
        if s > max(n_bytes // max(p, 1), 1):
            continue
        for m in seg_ms:
            tag = f"m={m}" if m else "ring"
            out.append(Candidate(
                f"derived:pipelined[S={s},{tag}]",
                sched_ir.build_pipelined_allreduce(p, n_bytes, m,
                                                   n_segments=s),
                "derived"))
    return out


# ------------------------------------------------------------- the search


@dataclass
class CandidateReport:
    name: str
    origin: str
    bound: float
    time: float | None           # None -> pruned without simulation
    fabric_bytes: float | None


@dataclass
class SearchResult:
    collective: str
    p: int
    n_bytes: int
    winner: Candidate
    winner_time: float
    winner_fabric_bytes: float
    best_builder: Candidate
    best_builder_time: float
    best_builder_fabric_bytes: float
    certificate: protocol.BoundCertificate
    table: list[CandidateReport]
    evaluations: int
    cache_hits: int
    pruned: int
    wall_s: float
    packet_validated: bool | None = None

    @property
    def searched_vs_best_builder(self) -> float:
        return self.winner_time / self.best_builder_time


def _packet_converged(res) -> bool:
    """Walk a packet-fidelity result for convergence: every component that
    reports a ``completed`` flag (broadcast runs, allgather legs, pipelined
    segments) must have delivered everything within the round budget."""
    ok = True
    seen = False
    for attr in ("completed",):
        if hasattr(res, attr):
            ok &= bool(getattr(res, attr))
            seen = True
    for attr in ("rs", "ag", "stripe", "ring"):
        sub = getattr(res, attr, None)
        if sub is not None:
            sub_ok = _packet_converged(sub)
            ok &= sub_ok
            seen = True
    for pair in getattr(res, "segments", ()) or ():
        for sub in pair:
            ok &= _packet_converged(sub)
            seen = True
    return ok if seen else math.isfinite(res.time)


def _prefetch_parallel(scored, n_seeds, incumbent_time, ctx, cache,
                       n_jobs: int) -> dict[tuple, EvalResult]:
    """Evaluate not-yet-cached derived candidates at once in a ``spawn``
    process pool, each child on ``ctx.device``, gated by incumbent
    broadcast: candidates go out in ascending-bound order, and one is
    dispatched only while its bound beats the best time any finished
    worker has reported (the seeds' incumbent included). Returns {cache
    key: result} for the replay loop, which stays bitwise the serial
    search: a prefetched result lands where a serial evaluation would
    have run. A pickling failure gives an empty prefetch (the replay loop
    then evaluates serially). On the card the parent builds the pool
    kernel before the first child starts."""
    import multiprocessing as mp
    from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait

    todo = []
    queued: set[tuple] = set()
    for bound, _binding, cand in scored[n_seeds:]:
        if bound >= incumbent_time:
            break                          # sorted: the rest prune too
        key = (sched_ir.canonical_key(cand.sched), ctx.key())
        if key not in queued and cache._store.get(key) is None \
                and (not cache._disk or repr(key) not in cache._disk):
            queued.add(key)
            todo.append((bound, key, cand))
    prefetched: dict[tuple, EvalResult] = {}
    if not todo:
        return prefetched
    if ctx.device is None or torch.device(ctx.device).type == "cuda":
        from repro_torch.kernels import build   # deferred: nothing builds at import

        build.build(("pool",))
    try:
        with ProcessPoolExecutor(
                max_workers=min(n_jobs, len(todo)),
                mp_context=mp.get_context("spawn")) as pool:
            best_seen = incumbent_time
            pending: dict = {}
            i = 0
            while i < len(todo) or pending:
                while i < len(todo) and len(pending) < n_jobs:
                    bound, key, cand = todo[i]
                    i += 1
                    if bound >= best_seen:
                        continue           # incumbent broadcast: stale bound
                    fut = pool.submit(_evaluate_uncached, cand.sched, ctx)
                    pending[fut] = key
                if not pending:
                    continue
                done, _ = wait(pending, return_when=FIRST_COMPLETED)
                for fut in done:
                    key = pending.pop(fut)
                    res = fut.result()
                    prefetched[key] = res
                    best_seen = min(best_seen, res.time)
    except (TypeError, AttributeError, OSError, ImportError):
        return {}                          # unpicklable schedule/topology
    return prefetched


def search(collective: str, p: int, n_bytes: int, *, topology=None,
           hosts=None, fabric: FabricParams | None = None,
           workers: WorkerParams | None = None, cache: EvalCache | None = None,
           seed: int = 0, validate_packet: bool = True,
           loss=None, n_jobs: int | None = None, device=None) -> SearchResult:
    """Branch-and-bound schedule search (module docstring). Builder seeds
    are force-evaluated to establish the incumbent; derived candidates are
    visited in ascending bound order and pruned when their admissible lower
    bound already meets the incumbent. The winner is re-validated at packet
    fidelity (optionally under ``loss``). Every evaluation and the
    validation run on ``device`` (default ``cuda``).

    ``n_jobs`` > 1 turns on the parallel tier: derived candidates that the
    seeds' incumbent cannot prune are prefetched in a ``spawn`` process
    pool (incumbent-broadcast gating), then the serial loop replays over
    the prefetched results, so the SearchResult is bitwise that of
    ``n_jobs=1`` and only the wall clock moves. Defaults to
    ``$REPRO_SEARCH_WORKERS``, else serial."""
    t0 = _time.perf_counter()
    fabric = fabric or FabricParams(jitter=0.0)
    workers = workers or WorkerParams(n_recv_workers=8)
    cache = cache if cache is not None else EvalCache()
    if n_jobs is None:
        n_jobs = int(os.environ.get("REPRO_SEARCH_WORKERS", "0") or 0)
    ctx = EvalContext(fabric, workers, topology,
                      tuple(hosts) if hosts is not None else None,
                      "fluid", seed, device)
    pool = cache.space(collective, p, n_bytes, topology)
    for cand in pool:
        # a reused space's schedules were validated when it was first searched
        if not getattr(cand.sched, "_validated", False):
            sched_ir.validate(cand.sched)
            object.__setattr__(cand.sched, "_validated", True)

    hits0 = cache.hits
    table: list[CandidateReport] = []
    incumbent: Candidate | None = None
    incumbent_time = math.inf
    incumbent_bytes = math.inf
    best_builder: Candidate | None = None
    best_builder_time = math.inf
    best_builder_bytes = math.inf
    evaluations = pruned = 0
    min_bound = math.inf
    min_binding = "analytic"

    seeds = [c for c in pool if c.origin == "builder"]
    derived = [c for c in pool if c.origin != "builder"]

    scored: list[tuple[float, str, Candidate]] = []
    for cand in seeds + derived:
        bound, binding = cache.bound(cand.sched, ctx)
        if bound < min_bound:
            min_bound, min_binding = bound, binding
        scored.append((bound, binding, cand))
    n_seeds = len(seeds)
    # seeds keep submission order (all run); derived sorted by bound so the
    # most promising run first and tighten the incumbent for pruning
    scored[n_seeds:] = sorted(scored[n_seeds:], key=lambda t: t[0])

    prefetched: dict[tuple, EvalResult] = {}

    def _eval(cand: Candidate) -> EvalResult:
        # replay shim: a prefetched result lands exactly where the serial
        # loop would have evaluated — same miss accounting, same store
        nonlocal evaluations
        evaluations += 1
        key = (sched_ir.canonical_key(cand.sched), ctx.key())
        res = prefetched.pop(key, None)
        if res is not None and key not in cache._store:
            cache.misses += 1
            cache._store[key] = res
            return res
        return cache.evaluate(cand.sched, ctx)

    for i, (bound, binding, cand) in enumerate(scored):
        is_seed = i < n_seeds
        if i == n_seeds and n_jobs > 1:
            # seeds fixed the incumbent: fan the survivors out to workers
            prefetched = _prefetch_parallel(scored, n_seeds, incumbent_time,
                                            ctx, cache, n_jobs)
        if not is_seed and bound >= incumbent_time:
            pruned += 1
            table.append(CandidateReport(cand.name, cand.origin, bound,
                                         None, None))
            continue
        res = _eval(cand)
        table.append(CandidateReport(cand.name, cand.origin, bound,
                                     res.time, res.fabric_bytes))
        if is_seed and (res.time, res.fabric_bytes) < (best_builder_time,
                                                       best_builder_bytes):
            best_builder, best_builder_time, best_builder_bytes = \
                cand, res.time, res.fabric_bytes
        if (res.time, res.fabric_bytes) < (incumbent_time, incumbent_bytes):
            incumbent, incumbent_time, incumbent_bytes = \
                cand, res.time, res.fabric_bytes

    if incumbent is None or best_builder is None:
        raise ValueError(f"no builder seeds {collective} at p={p}")
    cert = protocol.BoundCertificate(
        kind=collective, p=p, n_bytes=n_bytes, bound=min_bound,
        winner_time=incumbent_time, binding=min_binding)

    packet_ok: bool | None = None
    if validate_packet:
        # every stock fabric resolves packet leaf paths via topology.host()
        # (supports_packet=True); a custom fabric that opts out falls back
        # to validating loss-recovery convergence on the abstract fabric
        pkt_topo = topology if getattr(topology, "supports_packet",
                                       topology is not None) else None
        if pkt_topo is not None:
            pkt_topo.reset()
        pres = sched_ir.execute(
            incumbent.sched, fabric, workers, np.random.default_rng(seed),
            fidelity="packet", topology=pkt_topo,
            hosts=list(hosts) if pkt_topo is not None and hosts is not None
            else None, loss=loss, device=device)
        packet_ok = _packet_converged(pres) and math.isfinite(pres.time)

    cache.save()
    return SearchResult(
        collective=collective, p=p, n_bytes=n_bytes,
        winner=incumbent, winner_time=incumbent_time,
        winner_fabric_bytes=incumbent_bytes,
        best_builder=best_builder, best_builder_time=best_builder_time,
        best_builder_fabric_bytes=best_builder_bytes,
        certificate=cert, table=table, evaluations=evaluations,
        cache_hits=cache.hits - hits0, pruned=pruned,
        wall_s=_time.perf_counter() - t0, packet_validated=packet_ok)


# -------------------------------------------- the 1-D special case (M sweep)


def sweep_chains(schedule_builder, topology=None, *, p: int, n_bytes: int,
                 fabric: FabricParams, workers: WorkerParams,
                 candidates, fidelity: str = "fluid", seed: int = 0,
                 cache: EvalCache | None = None,
                 device=None) -> tuple[int, dict[int, float]]:
    """The 1-D slice of the searcher: sweep the chain count M of
    ``schedule_builder(p, n_bytes, m)`` through the shared memoized cache
    on ``device`` and return (argmin, the full {m: time} sweep). Backs
    ``sched_ir.autotune_chains``."""
    cache = cache if cache is not None else EvalCache()
    ctx = EvalContext(fabric, workers, topology, None, fidelity, seed, device)
    times: dict[int, float] = {}
    for m in candidates:
        times[m] = cache.evaluate(schedule_builder(p, n_bytes, m), ctx).time
    best = min(times, key=lambda m: (times[m], m))
    cache.save()
    return best, times
