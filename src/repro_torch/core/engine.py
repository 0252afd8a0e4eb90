"""Fluid-flow event engine and the 1-D worker pool, as far as the packet
Broadcast's abstract-fabric mode uses them.

Port of ``src/repro/core/engine.py``:

- ``FabricParams``, ``WorkerParams``: the same parameters and defaults.
- ``Engine`` / ``Link`` / ``Flow``: the discrete-event fluid engine for
  flows that each cross one named link. The flows on a link share it
  equally, which is the reference's max-min allocation for such flows; each
  flow records piecewise-linear progress from which ``Flow.chunk_times``
  recovers per-chunk times exactly. It is host code on Python floats and
  numpy, as in the reference. The Broadcast drives one link (the root's
  send link) with one flow at a time. Routes over several links and the
  max-min solve across them come with the routed FatTree mode (ROADMAP).
- ``worker_pool_completion`` / ``staging_rnr_mask``: the 1-D T-server pool
  and its staging-ring rule in numpy, for the root's NACK service (at most
  one arrival per leaf). The leaves' row-batched pool is the pool kernel
  (``kernels/pool.py``, ``csrc/pool.cu``).
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass

import numpy as np

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


# ---------------------------------------------------------------- fluid engine


class Link:
    """Directed bandwidth server, shared equally by the flows crossing it."""

    __slots__ = ("name", "capacity")

    def __init__(self, name: str, capacity: float):
        if not capacity > 0:
            raise ValueError(f"link {name}: capacity must be > 0, got {capacity}")
        self.name = name
        self.capacity = float(capacity)


class Flow:
    """One byte stream across one link; progress is kept as segments
    (t0, t1, bytes_at_t0, rate)."""

    __slots__ = ("link", "n_bytes", "tag", "t_start", "remaining", "t_end", "segments",
                 "_eps")

    def __init__(self, link: Link, n_bytes: float, t_start: float, tag: str | None):
        self.link = link
        self.n_bytes = float(n_bytes)
        self.tag = tag
        self.t_start = t_start
        self.remaining = float(n_bytes)
        # finish threshold: a sub-byte relative epsilon absorbs the fp error
        # that fluid progress accumulates
        self._eps = 1e-9 + self.n_bytes * 1e-12
        self.t_end: float | None = None
        self.segments: list[tuple[float, float, float, float]] = []

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


class Engine:
    """Event-driven fluid simulator. Flows may start in the future; the loop
    advances between starts and finishes and re-shares each link at every
    event."""

    def __init__(self, t0: float = 0.0):
        self.now = t0
        self._links: dict[str, Link] = {}
        self._pending: list[tuple[float, int, Flow]] = []   # start events
        self._active: list[Flow] = []
        self._seq = itertools.count()

    def add_link(self, name: str, capacity: float) -> Link:
        if name not in self._links:
            self._links[name] = Link(name, capacity)
        return self._links[name]

    def submit(self, link: str | Link, n_bytes: float, *, t_start: float | None = None,
               tag: str | None = None) -> Flow:
        """Submit a flow of ``n_bytes`` across ``link`` (a Link or the name
        of one added), starting at ``t_start`` (default now)."""
        t = self.now if t_start is None else float(t_start)
        if t < self.now - 1e-12:
            raise ValueError(f"cannot submit at {t}, before now ({self.now})")
        flow = Flow(self._links[link] if isinstance(link, str) else link, n_bytes, t, tag)
        heapq.heappush(self._pending, (t, next(self._seq), flow))
        return flow

    def _rates(self) -> dict[Flow, float]:
        sharing: dict[Link, int] = {}
        for f in self._active:
            sharing[f.link] = sharing.get(f.link, 0) + 1
        return {f: f.link.capacity / sharing[f.link] for f in self._active}

    def _step(self) -> bool:
        """Advance to the next event. Returns False when idle."""
        rates = self._rates()
        t_next = self._pending[0][0] if self._pending else math.inf
        for f in self._active:
            t_next = min(t_next, self.now + f.remaining / rates[f])
        if t_next == math.inf:
            return False
        dt = t_next - self.now
        if dt > 0:
            for f in self._active:
                r = rates[f]
                f.segments.append((self.now, self.now + dt, f.n_bytes - f.remaining, r))
                f.remaining -= min(r * dt, f.remaining)
        self.now = t_next
        # finishes (also flows whose residual would not advance the clock)
        still = []
        for f in self._active:
            if f.remaining <= f._eps or self.now + f.remaining / rates[f] <= self.now:
                f.remaining = 0.0
                f.t_end = self.now
            else:
                still.append(f)
        self._active = still
        # starts
        while self._pending and self._pending[0][0] <= self.now + 1e-15:
            _, _, f = heapq.heappop(self._pending)
            if f.n_bytes <= 0:
                f.t_end = max(self.now, f.t_start)
            else:
                self._active.append(f)
        return bool(self._active or self._pending)

    def run(self) -> float:
        """Drain every submitted flow; returns the final time."""
        while self._step():
            pass
        return self.now


# ------------------------------------------------- leaf worker pool (receive)


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
