"""Fluid-flow event engine over routes, the leaf worker pool, and the FSDP
step's contention timeline.

Port of ``src/repro/core/engine.py``:

- ``FabricParams``, ``WorkerParams``: the same parameters and defaults;
  ``workers_from_dpa``, the leaf pool of the calibrated DPA model
  (``core/dpa.py``).
- ``Engine`` / ``Link`` / ``Flow``: the discrete-event fluid engine. A Link
  is a directed bandwidth server (one direction of a NIC or of a fabric
  cable, from ``core/topology.py`` or added by name); a Flow crosses an
  ordered set of links (a route, or the edge set of a multicast tree) at
  one rate, set by global max-min water-filling across every link it
  crosses, and charges its bytes to each of them (``link_bytes``, the
  switch-port counters of Fig. 12). Each flow records piecewise-linear
  progress from which ``Flow.chunk_times`` recovers per-chunk times exactly.
- The max-min solve, as in the reference: progressive filling by dicts
  (``_max_min_rates_py``) while the active flows cross fewer than
  ``_NUMPY_RATES_MIN_MEMBERS`` (flow, link) memberships, and over the
  flow-by-link incidence at or above (``_max_min_rates_vec``, the
  reference's ``_max_min_rates_np``), whose filling runs as tensor ops on
  the engine's ``device``. Each step is the reference's f64 operation, in
  its order, so the rates are bitwise numpy's on every device (a capped
  flow's subtraction, a weighted sum, is added on the host in the
  reference's order). The solve is incremental: only the connected
  component of the flow-link graph that an event touched is solved again,
  and ``ENGINE_MAXMIN=reference`` solves everything at every event, the
  oracle the incremental mode is held to.
- ``worker_pool_completion`` / ``staging_rnr_mask``: the 1-D T-server pool
  and its staging-ring rule in numpy (the root's NACK service, at most one
  arrival per leaf); ``worker_pool_completion_rows``, R rows of arrivals in
  one pass on the pool kernel (``kernels/pool.py``, ``csrc/pool.cu``).
- The FSDP timeline (engine.py:640-1154): ``simulate_fsdp_step`` (uniform
  layers, ``layers=`` of ``LayerProfile``s, or ``model=``; fluid, or packet
  with ``_make_ag_loss_overlay``), ``sweep_fsdp_contention`` and
  ``simulate_multi_job``, each Engine on the caller's ``device``. The flows
  come from ``sched_ir.fsdp_submitters``. ``progress_engine="host"`` runs
  the receive datapath on host cores, whose throughput the event-level DPA
  measures (``dpa_engine.pool_tput_event``).

The engine's ``device`` (default ``cuda``) is resolved at its first
vectorized solve: an engine whose solves all stay on the dict path never
touches it. Each engine keeps the reference's ``maxmin_solves`` and
``maxmin_flows_solved``; ``counts`` adds up every engine's work.
"""
from __future__ import annotations

import heapq
import itertools
import math
import os
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import dpa as dpa_model
from repro_torch.core import profiling
from repro_torch.device import device_of
from repro_torch.kernels import pool

# every engine's solves, flows solved, vectorized solves (on the engine's
# device) and filling iterations of those (a host sync each)
counts = dict.fromkeys(("solves", "flows_solved", "device_solves", "fill_iterations"), 0)

# ------------------------------------------------------------------ parameters


@dataclass(frozen=True)
class FabricParams:
    b_link: float = 200e9 / 8       # bytes/s per direction
    latency: float = 2e-6           # base one-way latency
    jitter: float = 1e-6            # max extra delay (adaptive routing, OOO)
    p_drop: float = 0.0             # per-datagram fabric drop probability
    mtu: int = 4096
    alpha: float = 50e-6            # cutoff-timer slack


@dataclass(frozen=True)
class WorkerParams:
    n_recv_workers: int = 1
    thread_tput: float = 5.2 * (1 << 30)   # bytes/s per worker (Table I UD)
    staging_chunks: int = 8192
    rnr_barrier_hop: float = 1.5e-6


def workers_from_dpa(cfg: dpa_model.DpaConfig, *, staging_chunks: int = 8192,
                     rnr_barrier_hop: float = 1.5e-6) -> WorkerParams:
    """The leaf worker pool of the calibrated DPA offload model (reference
    engine.py:92): ``dpa.pool_tput`` (within-core T^e latency hiding, the
    per-core NIC-interface cap, linear across cores) spread evenly over
    ``cfg.n_threads`` workers, so that 16 UD threads do not serve 16x one
    thread."""
    tput = dpa_model.pool_tput(cfg)
    return WorkerParams(n_recv_workers=cfg.n_threads, thread_tput=tput / cfg.n_threads,
                        staging_chunks=staging_chunks, rnr_barrier_hop=rnr_barrier_hop)


# ---------------------------------------------------------------- fluid engine


class Flow:
    """One byte stream across an ordered set of links, at one rate on all of
    them; progress is kept as segments (t0, t1, bytes_at_t0, rate)."""

    __slots__ = ("links", "n_bytes", "tag", "t_start", "rate_cap", "remaining", "t_end",
                 "segments", "_eps")

    def __init__(self, links: tuple["Link", ...], n_bytes: float, t_start: float,
                 tag: str | None, rate_cap: float | None):
        self.links = links
        self.n_bytes = float(n_bytes)
        self.tag = tag
        self.t_start = t_start
        self.rate_cap = rate_cap
        self.remaining = float(n_bytes)
        # finish threshold: a sub-byte relative epsilon absorbs the fp error
        # that fluid progress accumulates
        self._eps = 1e-9 + self.n_bytes * 1e-12
        self.t_end: float | None = None
        self.segments: list[tuple[float, float, float, float]] = []

    @property
    def link(self) -> "Link | None":
        """The first (injection-side) link."""
        return self.links[0] if self.links else None

    @property
    def done(self) -> bool:
        return self.t_end is not None

    def time_at_bytes(self, marks: np.ndarray) -> np.ndarray:
        """Times at which cumulative delivered bytes reach each mark (exact on
        the piecewise-linear progress curve)."""
        if not self.done:
            raise RuntimeError("flow not finished; run the engine first")
        if not self.segments:            # zero-byte flow
            return np.full(np.shape(marks), self.t_end)
        ts = [self.segments[0][0]]
        bs = [0.0]
        for t0, t1, b0, rate in self.segments:
            ts.append(t1)
            bs.append(b0 + rate * (t1 - t0))
        bs[-1] = self.n_bytes            # drop the accumulated fp error at the end
        return np.interp(np.asarray(marks, dtype=float), bs, ts)

    def chunk_times(self, n_chunks: int, chunk_bytes: float) -> np.ndarray:
        """Completion time of each chunk's last byte."""
        marks = (np.arange(n_chunks) + 1.0) * chunk_bytes
        return self.time_at_bytes(np.minimum(marks, self.n_bytes))


class Link:
    """Directed bandwidth server, max-min shared by the active flows that
    cross it. ``src``/``dst`` name its endpoints in a topology;
    ``bytes_served`` is its live byte counter; ``loss`` may carry a packet
    loss model, which the fluid engine ignores."""

    __slots__ = ("name", "capacity", "active", "bytes_served", "src", "dst", "loss")

    def __init__(self, name: str, capacity: float, src: str | None = None,
                 dst: str | None = None):
        if not capacity > 0:
            raise ValueError(f"link {name}: capacity must be > 0, got {capacity}")
        self.name = name
        self.capacity = float(capacity)
        self.active: list[Flow] = []
        self.bytes_served = 0.0
        self.src = src
        self.dst = dst
        self.loss = None

    def __repr__(self) -> str:
        return f"Link({self.name}, cap={self.capacity:g}, bytes={self.bytes_served:g})"


# Membership count at which the vectorized filling takes over from the dict
# one (the reference's crossover)
_NUMPY_RATES_MIN_MEMBERS = 512


def _max_min_rates_py(active: list[Flow]) -> dict[Flow, float]:
    """Global max-min fair allocation by progressive filling (dict path):
    find the smallest equal share among the links' unfrozen flows, freeze
    every unfrozen flow of every link at that share, subtract, repeat; a
    flow's rate cap freezes it early at the cap."""
    rem: dict[Link, float] = {}
    members: dict[Link, list[Flow]] = {}
    for f in active:
        for link in f.links:
            if link not in rem:
                rem[link] = link.capacity
                members[link] = []
            members[link].append(f)
    out: dict[Flow, float] = {}
    unfrozen: dict[Flow, None] = dict.fromkeys(active)   # insertion-ordered set
    while unfrozen:
        best = math.inf
        for link, fl in members.items():
            n = sum(1 for f in fl if f in unfrozen)
            if n:
                best = min(best, rem[link] / n)
        if best is math.inf:       # every remaining flow crosses no link
            for f in unfrozen:
                out[f] = f.rate_cap if f.rate_cap is not None else math.inf
            break
        capped = [f for f in unfrozen if f.rate_cap is not None and f.rate_cap < best]
        if capped:
            for f in capped:
                out[f] = f.rate_cap
                del unfrozen[f]
                for link in f.links:
                    rem[link] = max(rem[link] - f.rate_cap, 0.0)
            continue
        newly: dict[Flow, None] = {}
        for link, fl in members.items():
            n = sum(1 for f in fl if f in unfrozen)
            if n and rem[link] <= best * n * (1.0 + 1e-12):
                for f in fl:
                    if f in unfrozen:
                        newly[f] = None
        for f in newly:
            out[f] = best
            del unfrozen[f]
        for f in newly:
            for link in f.links:
                rem[link] = max(rem[link] - best, 0.0)
    return out


def _max_min_rates_vec(active: list[Flow], device: torch.device) -> dict[Flow, float]:
    """Progressive filling over the flow-link incidence (COO), as tensor ops
    on ``device``: the allocation of ``_max_min_rates_py``, bitwise the
    reference's ``_max_min_rates_np``. Per iteration: the unfrozen flows a
    link carries (an integer scatter-add, exact), each link's share
    ``rem / cnt``, the smallest share, the flows under their cap; then one
    host sync reads whether all flows are frozen, whether any link carries
    one, whether a cap bites, and the smallest share. A capped step
    subtracts the caps from their links on the host, summed in the
    reference's order (a weighted bincount); a filling step freezes the
    flows of every link within 1e-12 of the smallest share and subtracts
    ``best * count`` (a multiply, then a subtract)."""
    link_ix: dict[Link, int] = {}
    mf: list[int] = []
    ml: list[int] = []
    for i, f in enumerate(active):
        for link in f.links:
            ml.append(link_ix.setdefault(link, len(link_ix)))
            mf.append(i)
    n_flows, n_links = len(active), len(link_ix)
    mfa_np = np.asarray(mf, dtype=np.int64)
    mla_np = np.asarray(ml, dtype=np.int64)
    mfa = torch.from_numpy(mfa_np).to(device)
    mla = torch.from_numpy(mla_np).to(device)
    caps = np.empty(n_links)
    for link, j in link_ix.items():
        caps[j] = link.capacity
    fcap_np = np.array([math.inf if f.rate_cap is None else f.rate_cap for f in active])
    fcap = torch.from_numpy(fcap_np).to(device)
    rate = torch.zeros(n_flows, dtype=torch.float64, device=device)
    frozen = torch.zeros(n_flows, dtype=torch.bool, device=device)
    rem = torch.from_numpy(caps).to(device)
    inf = torch.tensor(math.inf, dtype=torch.float64, device=device)
    while True:
        counts["fill_iterations"] += 1
        live = ~frozen[mfa]
        cnt_i = torch.zeros(n_links, dtype=torch.int64, device=device).index_add_(
            0, mla, live.to(torch.int64))
        cnt = cnt_i.to(torch.float64)
        has = cnt_i > 0
        share = torch.where(has, rem / cnt, inf)
        best_t = share.min()
        cap_hit = ~frozen & (fcap < best_t)
        all_frozen, any_has, any_cap, best = torch.stack([
            frozen.all().to(torch.float64), has.any().to(torch.float64),
            cap_hit.any().to(torch.float64), best_t]).tolist()
        if all_frozen:
            break
        if not any_has:
            rate = torch.where(frozen, rate, fcap)
            break
        if any_cap:
            rate = torch.where(cap_hit, fcap, rate)
            frozen |= cap_hit
            hit_m = cap_hit[mfa].cpu().numpy()
            sub = np.bincount(mla_np[hit_m], weights=rate.cpu().numpy()[mfa_np[hit_m]],
                              minlength=n_links)
            rem = (rem - torch.from_numpy(sub).to(device)).clamp_min_(0.0)
            continue
        tight = has & (share <= best * (1.0 + 1e-12))
        hit = (tight[mla] & live).to(torch.int64)
        newly = torch.zeros(n_flows, dtype=torch.int64, device=device).index_add_(
            0, mfa, hit) > 0
        rate = torch.where(newly, best_t, rate)
        frozen |= newly
        n_new = torch.zeros(n_links, dtype=torch.int64, device=device).index_add_(
            0, mla, newly[mfa].to(torch.int64))
        rem = (rem - best_t * n_new.to(torch.float64)).clamp_min_(0.0)
    return dict(zip(active, rate.cpu().tolist()))


class Engine:
    """Event-driven fluid simulator. Flows may start in the future; the loop
    advances between starts and finishes, and the max-min allocation is
    solved again at every event, incrementally: every Link holds its active
    flows, and an arrival or completion solves only the connected component
    of the flow-link graph it touched (every event of one timestamp in one
    batch). Disjoint components share no links, so a component's filling
    runs the global solve's float operations in its order.
    ``ENGINE_MAXMIN=reference`` selects the global solve at every event
    instead. ``device``: where the vectorized solve runs (default ``cuda``)."""

    def __init__(self, t0: float = 0.0, *, device=None):
        self.now = t0
        self._links: dict[str, Link] = {}
        self._pending: list[tuple[float, int, Flow]] = []   # start events
        self._active: list[Flow] = []
        self._seq = itertools.count()
        mode = os.environ.get("ENGINE_MAXMIN", "") or "incremental"
        if mode not in ("incremental", "reference"):
            raise ValueError(f"ENGINE_MAXMIN must be 'incremental' or 'reference', got {mode!r}")
        self._maxmin_mode = mode
        self._device_name = "cuda" if device is None else device
        self._device: torch.device | None = None
        # cached rates (valid for the active set once _dirty drains), and the
        # flows whose arrival or completion invalidated their component
        self._rates_cache: dict[Flow, float] = {}
        self._dirty: list[Flow] = []
        self.maxmin_solves = 0
        self.maxmin_flows_solved = 0

    @property
    def device(self) -> torch.device:
        if self._device is None:
            self._device = device_of(self._device_name)
        return self._device

    # -- construction
    def add_link(self, name: str, capacity: float) -> Link:
        if name not in self._links:
            self._links[name] = Link(name, capacity)
        return self._links[name]

    def _resolve_links(self, route) -> tuple[Link, ...]:
        """A link name, a Link, or a sequence of either. A topology's Links
        are registered, so that ``utilization`` and ``link_bytes`` see them;
        a name taken by another Link, or a link twice in a route, raises."""
        if isinstance(route, (str, Link)):
            route = (route,)
        out: list[Link] = []
        seen: set[int] = set()
        for item in route:
            link = self._links[item] if isinstance(item, str) else item
            if not isinstance(link, Link):
                raise TypeError(f"not a link: {item!r}")
            if self._links.setdefault(link.name, link) is not link:
                raise ValueError(f"link name collision: {link.name}")
            if id(link) in seen:
                raise ValueError(f"duplicate link in route: {link.name}")
            seen.add(id(link))
            out.append(link)
        return tuple(out)

    def submit(self, route, n_bytes: float, *, t_start: float | None = None,
               tag: str | None = None, rate_cap: float | None = None) -> Flow:
        """A flow of ``n_bytes`` across ``route`` (a link name, a Link, or an
        ordered sequence of links: ``Topology.route`` or ``multicast_tree``),
        starting at ``t_start`` (default now), at its max-min share and at
        most ``rate_cap``; its bytes are charged to every link. An empty
        route completes at ``t_start``."""
        t = self.now if t_start is None else float(t_start)
        if t < self.now - 1e-12:
            raise ValueError(f"cannot submit at {t}, before now ({self.now})")
        flow = Flow(self._resolve_links(route), n_bytes, t, tag, rate_cap)
        heapq.heappush(self._pending, (t, next(self._seq), flow))
        return flow

    def submit_route(self, route, n_bytes: float, **kw) -> Flow:
        """Unicast flow along an ordered Link path (``submit``)."""
        return self.submit(route, n_bytes, **kw)

    def submit_tree(self, edges, n_bytes: float, **kw) -> Flow:
        """Multicast tree flow, the switches' replication: its rate is the
        smallest share over the tree's edges and each edge serves all its
        bytes (``submit``)."""
        return self.submit(edges, n_bytes, **kw)

    # -- event loop
    def _solve(self, flows: list[Flow]) -> dict[Flow, float]:
        """Progressive filling over ``flows``; the vectorized path by the
        global active membership count, as the reference chooses."""
        n_members = sum(len(f.links) for f in self._active)
        self.maxmin_solves += 1
        self.maxmin_flows_solved += len(flows)
        counts["solves"] += 1
        counts["flows_solved"] += len(flows)
        if n_members >= _NUMPY_RATES_MIN_MEMBERS:
            counts["device_solves"] += 1
            if profiling.ENABLED:
                with profiling.phase("engine_solve"):
                    return _max_min_rates_vec(flows, self.device)
            return _max_min_rates_vec(flows, self.device)
        if profiling.ENABLED:
            with profiling.phase("engine_solve"):
                return _max_min_rates_py(flows)
        return _max_min_rates_py(flows)

    def _rates(self) -> dict[Flow, float]:
        """The global allocation over the active set."""
        if not self._active:
            return {}
        return self._solve(self._active)

    def _component(self, seed_links) -> list[Flow]:
        """Flows joined (through shared links) to any seed link, in
        ``_active`` order, so that a component's filling visits its flows in
        the global solve's order."""
        seen_links: set[int] = set()
        stack: list[Link] = []
        for link in seed_links:
            if id(link) not in seen_links:
                seen_links.add(id(link))
                stack.append(link)
        comp_ids: set[int] = set()
        while stack:
            link = stack.pop()
            for f in link.active:
                if id(f) not in comp_ids:
                    comp_ids.add(id(f))
                    for l2 in f.links:
                        if id(l2) not in seen_links:
                            seen_links.add(id(l2))
                            stack.append(l2)
        return [f for f in self._active if id(f) in comp_ids]

    def _current_rates(self) -> dict[Flow, float]:
        """The cached allocation, the dirty components solved again (in
        "reference" mode: the global solve every time)."""
        if self._maxmin_mode == "reference":
            return self._rates()
        if self._dirty:
            dirty, self._dirty = self._dirty, []
            cache = self._rates_cache
            seed_links: list[Link] = []
            for f in dirty:
                if f.t_end is not None:
                    cache.pop(f, None)
                seed_links.extend(f.links)
            if not self._active:
                cache.clear()
            else:
                comp = self._component(seed_links)
                if comp:
                    cache.update(self._solve(comp))
        return self._rates_cache

    def _progress(self, dt: float, rates: dict[Flow, float]) -> None:
        if dt <= 0:
            return
        for f in self._active:
            r = rates.get(f, 0.0)
            f.segments.append((self.now, self.now + dt, f.n_bytes - f.remaining, r))
            moved = min(r * dt, f.remaining)
            f.remaining -= moved
            for link in f.links:
                link.bytes_served += moved

    def _step(self, t_limit: float = math.inf) -> bool:
        """Advance to the next event (or ``t_limit``). Returns False when idle."""
        rates = self._current_rates()
        t_next = t_limit
        if self._pending:
            t_next = min(t_next, self._pending[0][0])
        for f in self._active:
            r = rates.get(f, 0.0)
            if r > 0:
                t_next = min(t_next, self.now + f.remaining / r)
        if t_next == math.inf:
            return False
        self._progress(t_next - self.now, rates)
        self.now = t_next
        # finishes (also flows whose residual would not advance the clock)
        still = []
        touched: set[Link] = set()
        changed: list[Flow] = []
        for f in self._active:
            r = rates.get(f, 0.0)
            stalled = r > 0 and self.now + f.remaining / r <= self.now
            if f.remaining <= f._eps or stalled:
                f.remaining = 0.0
                f.t_end = self.now
                touched.update(f.links)
                changed.append(f)
            else:
                still.append(f)
        self._active = still
        for link in touched:
            link.active = [fl for fl in link.active if fl.t_end is None]
        # starts
        while self._pending and self._pending[0][0] <= self.now + 1e-15:
            _, _, f = heapq.heappop(self._pending)
            if f.n_bytes <= 0 or not f.links:
                f.t_end = max(self.now, f.t_start)
            else:
                for link in f.links:
                    link.active.append(f)
                self._active.append(f)
                changed.append(f)
        self._dirty.extend(changed)
        return bool(self._active or self._pending)

    def advance_to(self, t: float) -> None:
        while self.now < t and self._step(t):
            pass
        self.now = max(self.now, t)

    def wait(self, *flows: Flow) -> float:
        """Advance until every given flow completes; returns the latest end."""
        while any(not f.done for f in flows):
            if not self._step(math.inf):
                break
        if not all(f.done for f in flows):
            raise RuntimeError("deadlock: flows never started")
        return max(f.t_end for f in flows)

    def run(self) -> float:
        """Drain every submitted flow; returns the final time."""
        while self._step(math.inf):
            pass
        return self.now

    def utilization(self, horizon: float | None = None) -> dict[str, float]:
        """Per-link bytes_served / (capacity * horizon)."""
        h = horizon if horizon is not None else self.now
        if h <= 0:
            return {n: 0.0 for n in self._links}
        return {n: l.bytes_served / (l.capacity * h) for n, l in self._links.items()}

    def link_bytes(self) -> dict[str, float]:
        """Live per-link byte counters (the switch-port view of Fig. 12)."""
        return {n: l.bytes_served for n, l in self._links.items()}


# ------------------------------------------------- leaf worker pool (receive)


def worker_pool_completion_loop(arrivals: np.ndarray, n_workers: int, service: float,
                                staging: int) -> tuple[np.ndarray, int]:
    """The T-server queue one chunk at a time, with staging-ring (RNR)
    overflow counting; ``arrivals`` sorted. The oracle of the other forms."""
    n = arrivals.shape[0]
    done = np.empty(n)
    rnr = 0
    for k in range(n):
        start = arrivals[k] if k < n_workers else max(arrivals[k], done[k - n_workers])
        if k >= staging and done[k - staging] > arrivals[k]:
            rnr += 1
        done[k] = start + service
    return done, rnr


def staging_rnr_mask(done: np.ndarray, arrivals: np.ndarray,
                     staging: int) -> np.ndarray:
    """Chunk k is dropped when the chunk ``staging`` places ahead of it is
    still unserviced at k's arrival."""
    n = arrivals.shape[0]
    mask = np.zeros(n, dtype=bool)
    if n > staging:
        over = np.nonzero(done[: n - staging] > arrivals[staging:])[0]
        mask[staging + over] = True
    return mask


def worker_pool_completion(arrivals: np.ndarray, n_workers: int,
                           service: float, staging: int) -> tuple[np.ndarray, int]:
    """1-D sorted arrivals through a W-worker deterministic-service pool:
    per residue class mod W, ``done_i = (i+1)s + max_{j<=i}(a_j - j*s)``.
    Returns (done, number of staging-ring drops)."""
    if profiling.ENABLED:
        with profiling.phase("pool_solve"):
            return _pool_1d(arrivals, n_workers, service, staging)
    return _pool_1d(arrivals, n_workers, service, staging)


def _pool_1d(arrivals: np.ndarray, n_workers: int, service: float,
             staging: int) -> tuple[np.ndarray, int]:
    n = arrivals.shape[0]
    if n == 0:
        return np.empty(0), 0
    done = np.empty(n)
    w = max(int(n_workers), 1)
    for r in range(min(w, n)):
        idx = np.arange(r, n, w)
        i = np.arange(idx.size, dtype=float)
        shifted = arrivals[idx] - i * service
        done[idx] = np.maximum.accumulate(shifted) + (i + 1.0) * service
    rnr = int(staging_rnr_mask(done, arrivals, staging).sum())
    return done, rnr


def worker_pool_completion_rows(arrivals: torch.Tensor, n_workers: int, service: float,
                                staging: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``worker_pool_completion`` and ``staging_rnr_mask`` over R stacked
    rows at once: (R, n) f64 rows, each sorted, ragged rows padded at the
    end with +inf. Returns (done (R, n), rnr mask (R, n)); padded columns
    come back +inf and False. Bitwise the 1-D functions on each row's real
    prefix (a chunk's worker is its position mod W, which padding at the
    end does not move). One launch of the pool kernel for a CUDA tensor,
    the plain version for a CPU one; every pool pass of the port goes
    through here (the profiler's ``pool_solve``)."""
    if profiling.ENABLED:
        with profiling.phase("pool_solve"):
            return pool.pool_completion_rows(arrivals, n_workers, service, staging)
    return pool.pool_completion_rows(arrivals, n_workers, service, staging)


# ----------------------------------------------------- FSDP contention model


FSDP_POLICIES = ("naive", "mcast", "split")
PROGRESS_ENGINES = ("dpa", "host")


@dataclass
class FsdpStepResult:
    policy: str
    step_time: float                  # wall time of fwd + bwd (+ RS drain)
    compute_time: float               # sum of useful layer compute
    bubble_fraction: float            # 1 - compute_time / step_time
    phase_times: dict[str, float]     # forward / backward / rs_drain
    link_utilization: dict[str, float]
    ag_bytes: float                   # per-node AG bytes moved (dominant direction)
    rs_bytes: float
    n_layers: int
    p: int
    progress_engine: str = "dpa"      # who runs the reliability datapath
    datapath_tput: float | None = None  # host engine bytes/s (None: the DPA, line rate)


@dataclass(frozen=True)
class LayerProfile:
    """One layer of a heterogeneous FSDP step (``simulate_fsdp_step``
    ``layers=``): compute seconds at full-node capability and the layer's
    parameter bytes (its AG/RS wire volume)."""
    fwd_s: float          # forward compute seconds
    bwd_s: float          # backward compute seconds
    layer_bytes: float    # parameter bytes gathered and reduce-scattered

    def __post_init__(self):
        if not (self.fwd_s >= 0.0 and self.bwd_s >= 0.0):
            raise ValueError(f"compute seconds must be >= 0, got {self.fwd_s}, {self.bwd_s}")
        if not self.layer_bytes > 0.0:
            raise ValueError(f"layer_bytes must be > 0, got {self.layer_bytes}")


def _layer_bytes_from_model(model, dtype_bytes: int) -> tuple[int, float]:
    """(n_layers, parameter bytes a layer) of a registered config, from the
    port's copy of the reference's analytic parameter count (every
    family)."""
    from repro_torch.models.model_builder import count_params_analytic

    n_layers = model.num_layers
    return n_layers, count_params_analytic(model) / n_layers * dtype_bytes


def _make_ag_loss_overlay(fidelity: str, loss, rng, policy: str, topology, hosts, p: int,
                          gather_bytes: float, shard_bytes: float, fabric: FabricParams,
                          workers: "WorkerParams | None"):
    """A layer's AG loss and recovery penalty at ``fidelity="packet"``
    (reference engine.py:682). Multicast policies: per-link drops on every AG
    tree and the NACK and retransmission rounds of ``packet.
    recovery_overlay``, the worst tree's (a layer's AG is ready when every
    tree recovered); the links' processes are shared by every tree that
    crosses them. Unicast "naive": the RC goodput inflation 1/(1-q_path).
    The fluid fidelity pays nothing. The callable takes ``(gather_b,
    shard_b)`` so that a layer of ``layers=`` pays at its own volume."""
    if fidelity != "packet":
        return lambda *a: 0.0
    from repro_torch.core import packet as packet_mod   # deferred: packet imports this module
    from repro_torch.core.sched_ir import _chunking

    rng = rng if rng is not None else np.random.default_rng(0)
    template = packet_mod.resolve_loss(loss, fabric)
    if template is None:
        return lambda *a: 0.0
    if workers is None:
        # NACK service: one fully threaded DPA core
        workers = WorkerParams(n_recv_workers=16)
    hosts = list(hosts)

    if policy == "naive":
        if topology is not None:
            hops = [len(topology.route(hosts[i], hosts[(i + 1) % p])) for i in range(p)]
            path_len = max(sum(hops) / len(hops), 1.0)
        else:
            path_len = 1.0
        inflation = packet_mod.rc_goodput_inflation(template.mean_rate, path_len)

        def naive_overlay(gather_b: float = gather_bytes, shard_b: float = shard_bytes) -> float:
            return 2.0 * gather_b / fabric.b_link * inflation

        return naive_overlay

    tree_infos = []
    if topology is not None:
        all_models: dict[int, object] = {}
        for h in hosts:
            tree = topology.multicast_tree(h, hosts)
            paths = packet_mod.tree_paths(tree, topology.host(h),
                                          [topology.host(x) for x in hosts if x != h])
            for links in paths.values():
                for link in links:
                    if id(link) not in all_models:
                        all_models[id(link)] = link.loss or template.fork(rng)
            models = {id(link): all_models[id(link)] for links in paths.values()
                      for link in links}
            tree_infos.append((paths, models, min(link.capacity for link in tree)))
    else:
        # one carrier (one loss process) per leaf ejection link, shared by
        # every tree that crosses it
        carriers = {x: packet_mod._AbstractCarrier() for x in hosts}
        leaf_models = {x: template.fork(rng) for x in sorted(carriers)}
        for h in hosts:
            paths = {x: [carriers[x]] for x in hosts if x != h}
            models = {id(carriers[x]): leaf_models[x] for x in hosts if x != h}
            tree_infos.append((paths, models, fabric.b_link))

    def overlay(gather_b: float = gather_bytes, shard_b: float = shard_bytes) -> float:
        n_chunks, chunk = _chunking(int(shard_b), fabric.mtu)
        return max(packet_mod.recovery_overlay(paths, models, n_chunks, chunk, rate, fabric,
                                               workers, rng)
                   for paths, models, rate in tree_infos)

    return overlay


def simulate_fsdp_step(model=None, *, n_layers: int = 32, layer_bytes: float = 256e6,
                       layers: "list[LayerProfile] | None" = None, p: int = 16,
                       fabric: FabricParams | None = None, policy: str = "naive",
                       n_chains: int = 2, tokens_per_device: int = 4096,
                       hw_flops: float = 200e12, dtype_bytes: int = 2, topology=None,
                       hosts=None, fidelity: str = "fluid", loss=None,
                       rng: "np.random.Generator | None" = None,
                       workers: "WorkerParams | None" = None, progress_engine: str = "dpa",
                       host_cores: int = 2, host_total_cores: int = 108, schedule=None,
                       device=None) -> FsdpStepResult:
    """The interleaved forward-AG, backward-RS and compute timeline of one
    FSDP step (reference engine.py:752), equal field for field to the
    reference's on the same arguments and generator.

    Per layer the parameters are sharded 1/p a node; the forward pass
    gathers layer i+1 during layer i's compute (prefetch), the backward pass
    gathers again in reverse order while reduce-scattering each layer's
    gradients, so the AG and RS streams contend for the node's injection and
    ejection bandwidth. The flows come from ``sched_ir.fsdp_submitters``
    over ``sched_ir.build_fsdp_step`` (or ``schedule=``): the abstract NIC
    (naive: one shared half-duplex medium; mcast: a multicast AG whose
    receive stream shares the ejection link with the ring RS; split: the
    multicast AG and an in-network RS, opposite directions), or with
    ``topology=`` routed rings, multicast trees and aggregation trees on the
    fabric (ranks on ``hosts``). bubble_fraction = 1 - compute / step.

    ``fidelity="packet"`` adds each layer's AG loss overlay
    (``_make_ag_loss_overlay``; ``loss`` a rate or a ``LossModel``, ``rng``
    its generator, ``workers`` the NACK-service pool). ``layers=`` gives a
    heterogeneous per-layer profile, ``model=`` a registered config (the
    dense and moe families) whose analytic parameter count sets the layer
    bytes. Every Engine runs its vectorized max-min solve on ``device``
    (default ``cuda``).

    ``progress_engine`` is who runs the reliability datapath (§VII-d):
    ``"dpa"`` the SmartNIC, which keeps up with the wire and leaves the host
    cores to compute; ``"host"`` ``host_cores`` Epyc-class cores running it
    in software (``dpa_engine.EventDpaParams.host_cpu``). Then a layer's AG
    is not ready before its gathered bytes also drained through the
    engine's measured throughput (``datapath_tput``, from
    ``dpa_engine.pool_tput_event``), and every layer's compute stretches by
    host_total_cores / (host_total_cores - host_cores); the stretch counts
    as bubble, not as useful compute."""
    if policy not in FSDP_POLICIES:
        raise ValueError(f"policy must be one of {FSDP_POLICIES}, got {policy!r}")
    if fidelity not in ("fluid", "packet"):
        raise ValueError(f"fidelity must be 'fluid' or 'packet', got {fidelity!r}")
    if progress_engine not in PROGRESS_ENGINES:
        raise ValueError(f"progress_engine must be one of {PROGRESS_ENGINES}, "
                         f"got {progress_engine!r}")
    if fidelity != "packet" and loss is not None:
        raise ValueError("loss models require fidelity='packet'")
    if progress_engine == "host":
        from repro_torch.core import dpa_engine   # deferred: dpa_engine imports this module

        if not 1 <= host_cores < host_total_cores:
            raise ValueError(f"need 1 <= host_cores < host_total_cores, got {host_cores}, "
                             f"{host_total_cores}")
        datapath_cap = dpa_engine.pool_tput_event(dpa_engine.EventDpaParams.host_cpu(host_cores))
        compute_scale = host_total_cores / (host_total_cores - host_cores)
    else:
        datapath_cap = None
        compute_scale = 1.0
    dev = device_of("cuda" if device is None else device)
    fabric = fabric or FabricParams()
    if model is not None:
        if layers is not None:
            raise ValueError("pass model= or layers=, not both")
        n_layers, layer_bytes = _layer_bytes_from_model(model, dtype_bytes)
    if layers is not None:
        layers = list(layers)
        n_layers = len(layers)
        # the op template carries the largest layer; smaller layers scale
        # their flows down through the submitters' scale argument
        layer_bytes = max(lp.layer_bytes for lp in layers)
    if p < 2 or n_layers < 1:
        raise ValueError(f"need p >= 2 and n_layers >= 1, got {p}, {n_layers}")

    gather_bytes = (p - 1) / p * layer_bytes     # bytes a node must receive
    shard_bytes = layer_bytes / p
    if layers is None:
        fwd_t = 2.0 * (layer_bytes / dtype_bytes) * tokens_per_device / hw_flops * compute_scale
        bwd_t = 2.0 * fwd_t
        fwd_ts = [fwd_t] * n_layers
        bwd_ts = [bwd_t] * n_layers
        scales = [1.0] * n_layers                # x * 1.0 is bit-exact
        gathers = [gather_bytes] * n_layers
        shards = [shard_bytes] * n_layers
    else:
        fwd_ts = [lp.fwd_s * compute_scale for lp in layers]
        bwd_ts = [lp.bwd_s * compute_scale for lp in layers]
        scales = [lp.layer_bytes / layer_bytes for lp in layers]
        gathers = [(p - 1) / p * lp.layer_bytes for lp in layers]
        shards = [lp.layer_bytes / p for lp in layers]

    from repro_torch.core import sched_ir   # deferred: sched_ir imports this module

    sched = schedule
    if sched is None:
        sched = sched_ir.build_fsdp_step(p=p, n_layers=n_layers, layer_bytes=layer_bytes,
                                         policy=policy, n_chains=n_chains)
    elif sched.kind != "fsdp_step" or sched.p != p or sched.meta["policy"] != policy:
        raise ValueError(f"schedule {sched.kind} p={sched.p} {sched.meta.get('policy')} is not "
                         f"an fsdp_step of p={p} {policy}")
    eng = Engine(device=dev)
    if topology is not None:
        topology.reset()
    hosts = hosts if hosts is not None else range(p)
    submit_ag, submit_rs, ag_sync = sched_ir.fsdp_submitters(sched, eng, fabric,
                                                             topology=topology, hosts=hosts)
    ag_overlay = _make_ag_loss_overlay(fidelity, loss, rng, policy, topology, hosts, p,
                                       gather_bytes, shard_bytes, fabric, workers)
    compute_total = 0.0
    # useful compute at full-node capability: the host engine's stretch
    # (stolen cores) is protocol overhead and shows up as bubble
    fwd_useful = [ft / compute_scale for ft in fwd_ts]
    bwd_useful = [bt / compute_scale for bt in bwd_ts]

    def ag_ready(t_submit: float, flows, i: int) -> float:
        """A layer's parameters are usable when the wire delivered them (and,
        on the host progress engine, the gathered bytes drained through its
        software datapath), the chain activations passed and the loss
        overlay recovered."""
        t_wire = eng.wait(*flows)
        if datapath_cap is not None:
            t_wire = max(t_wire, t_submit + gathers[i] / datapath_cap)
        return t_wire + ag_sync + ag_overlay(gathers[i], shards[i])

    # forward: AG(i+1) prefetched at the compute start of layer i
    ag = [None] * n_layers
    ag[0] = (0.0, submit_ag(0.0, scales[0]))
    t = 0.0
    for i in range(n_layers):
        start = max(t, ag_ready(*ag[i], i))
        if i + 1 < n_layers:
            ag[i + 1] = (start, submit_ag(start, scales[i + 1]))
        t = start + fwd_ts[i]
        compute_total += fwd_useful[i]
    t_fwd_end = t

    # backward: gather the parameters again in reverse order, RS the grads
    ag_b = [None] * n_layers
    ag_b[n_layers - 1] = (t_fwd_end, submit_ag(t_fwd_end, scales[n_layers - 1]))
    rs_flows: list[Flow] = []
    for i in range(n_layers - 1, -1, -1):
        start = max(t, ag_ready(*ag_b[i], i))
        if i - 1 >= 0:
            ag_b[i - 1] = (start, submit_ag(start, scales[i - 1]))
        t = start + bwd_ts[i]
        compute_total += bwd_useful[i]
        rs_flows += submit_rs(t, scales[i])
    t_bwd_end = t

    t_rs_done = eng.wait(*rs_flows) if rs_flows else t_bwd_end
    step_time = max(t_bwd_end, t_rs_done)
    eng.advance_to(step_time)

    return FsdpStepResult(
        policy=policy,
        step_time=step_time,
        compute_time=compute_total,
        bubble_fraction=1.0 - compute_total / step_time,
        phase_times={
            "forward": t_fwd_end,
            "backward": t_bwd_end - t_fwd_end,
            "rs_drain": max(t_rs_done - t_bwd_end, 0.0),
        },
        link_utilization=eng.utilization(step_time),
        # forward prefetch + backward gather / one RS a layer
        ag_bytes=(gather_bytes * 2 * n_layers if layers is None else 2.0 * sum(gathers)),
        rs_bytes=(gather_bytes * n_layers if layers is None else float(sum(gathers))),
        n_layers=n_layers,
        p=p,
        progress_engine=progress_engine,
        datapath_tput=datapath_cap,
    )


def sweep_fsdp_contention(*, ps=(8, 16, 64), layer_bytes=(64e6, 256e6), n_layers: int = 8,
                          fabric: FabricParams | None = None, policies=FSDP_POLICIES,
                          hw_flops: float = 200e12, tokens_per_device: int = 4096,
                          device=None) -> list[dict]:
    """A grid of ``simulate_fsdp_step`` calls (reference engine.py:1003):
    one row a (p, layer bytes, policy); raises where split's bubble fraction
    is above naive's."""
    fabric = fabric or FabricParams()
    rows = []
    for p in ps:
        for lb in layer_bytes:
            per_policy = {}
            for pol in policies:
                r = simulate_fsdp_step(n_layers=n_layers, layer_bytes=lb, p=p, fabric=fabric,
                                       policy=pol, hw_flops=hw_flops,
                                       tokens_per_device=tokens_per_device, device=device)
                per_policy[pol] = r
                rows.append({
                    "p": p, "layer_bytes": lb, "policy": pol,
                    "step_time": r.step_time,
                    "bubble_fraction": r.bubble_fraction,
                    "link_utilization": r.link_utilization,
                })
            if "naive" in per_policy and "split" in per_policy:
                split, naive = (per_policy["split"].bubble_fraction,
                                per_policy["naive"].bubble_fraction)
                if not split <= naive + 1e-12:
                    raise AssertionError(f"split bubbles {split} above naive's {naive} at "
                                         f"p={p}, layer bytes {lb}")
    return rows


# ------------------------------------------------ multi-job fabric contention


@dataclass
class MultiJobResult:
    policy: str
    n_layers: int
    solo_time: dict[str, float]        # each job alone on the fabric
    contended_time: dict[str, float]   # all jobs co-scheduled
    slowdown: dict[str, float]         # contended / solo, per job
    core_bytes: float                  # contended-run bytes on the agg<->core tier
    link_utilization: dict[str, float]  # contended run, per fabric link


def simulate_multi_job(topology, jobs: dict[str, "list[int]"], *,
                       layer_bytes: float = 256e6, n_layers: int = 4,
                       policy: str = "mcast", fabric: FabricParams | None = None,
                       hw_flops: float = 200e12, tokens_per_device: int = 4096,
                       dtype_bytes: int = 2, device=None) -> MultiJobResult:
    """Several FSDP jobs on disjoint host sets of one fabric (reference
    engine.py:1055). Each job runs ``n_layers`` layer steps: gather the
    layer's parameters (routed as ``simulate_fsdp_step``'s topology mode),
    compute, gather the next. The jobs' flows meet on shared edge, agg and
    core links. Each job also runs alone on the same fabric; slowdown =
    contended / solo. The co-simulation interleaves the jobs on one engine:
    after every engine event a job whose AG completed submits its next
    layer at now + sync + compute. Every engine solves on ``device``
    (default ``cuda``)."""
    dev = device_of("cuda" if device is None else device)
    fabric = fabric or FabricParams()
    names = list(jobs)
    all_hosts = [h for hs in jobs.values() for h in hs]
    if len(set(all_hosts)) != len(all_hosts):
        raise ValueError("jobs must use disjoint hosts")
    if not all(len(hs) >= 2 for hs in jobs.values()):
        raise ValueError("every job needs at least two hosts")

    from repro_torch.core import sched_ir   # deferred: sched_ir imports this module

    def run(subset: list[str]) -> tuple[dict[str, float], Engine]:
        topology.reset()
        eng = Engine(device=dev)
        state: dict[str, dict] = {}
        for name in subset:
            hs = list(jobs[name])
            p = len(hs)
            sched = sched_ir.build_fsdp_step(p=p, n_layers=n_layers, layer_bytes=layer_bytes,
                                             policy=policy, n_chains=p)
            submit_ag, _, ag_sync = sched_ir.fsdp_submitters(sched, eng, fabric,
                                                             topology=topology, hosts=hs)
            state[name] = {
                "submit": submit_ag, "sync": ag_sync,
                "fwd": 2.0 * (layer_bytes / dtype_bytes) * tokens_per_device / hw_flops,
                "layer": 0, "flows": None, "end": None,
            }
        for st in state.values():
            st["flows"] = st["submit"](0.0)
        idle_seen = False
        while True:
            progressed = True
            while progressed:      # a finish may unblock several jobs at once
                progressed = False
                for st in state.values():
                    if st["end"] is None and all(f.done for f in st["flows"]):
                        st["layer"] += 1
                        t_next = eng.now + st["sync"] + st["fwd"]
                        if st["layer"] >= n_layers:
                            st["end"] = t_next
                        else:
                            st["flows"] = st["submit"](t_next)
                            progressed = True
            if all(st["end"] is not None for st in state.values()):
                break
            # _step returns False on the call that retires the last flows;
            # the completion pass above gets one more look before an idle
            # engine with unfinished jobs counts as a deadlock
            if not eng._step(math.inf):
                if idle_seen:
                    raise RuntimeError("multi-job co-simulation deadlocked")
                idle_seen = True
            else:
                idle_seen = False
        return {name: state[name]["end"] for name in subset}, eng

    solo: dict[str, float] = {}
    for name in names:
        solo.update(run([name])[0])
    contended, eng = run(names)
    horizon = max(contended.values())
    core = getattr(topology, "core_links", None)
    core_bytes = sum(link.bytes_served for link in core()) if core else 0.0
    return MultiJobResult(
        policy=policy,
        n_layers=n_layers,
        solo_time=solo,
        contended_time=contended,
        slowdown={n: contended[n] / solo[n] for n in names},
        core_bytes=core_bytes,
        link_utilization=eng.utilization(horizon),
    )
