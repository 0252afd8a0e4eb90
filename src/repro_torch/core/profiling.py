"""Opt-in wall-clock accounting of the simulator's host phases.

Port of ``src/repro/core/profiling.py``, with its phases, switches and
report keys. Disabled (the default), an instrumented hot path pays one
module-attribute check: no ``perf_counter`` call, no dict update. The
choke points are the four phase owners:

  engine_solve  the engine's max-min rate solves (``engine.Engine._solve``:
                the global and the incremental component solve, on either
                solver path)
  pool_solve    the worker pool scans (``engine.worker_pool_completion``,
                the 1-D host scan, and ``engine.worker_pool_completion_rows``,
                through which every launch of the pool kernel goes)
  rng           the loss-mask and jitter draws (``packet._sample_link_round``,
                ``packet._jitter_on``, the packet Broadcast's
                ``_draw_jitter``, the fluid Broadcast's and Allgather's draws)
  packing       the NACK rows' pack and OR (``packet.py``'s and the packet
                Allgather's) and the merged rows' stable sort
                (``sched_ir._merged_pool``)

No phase adds a device synchronisation. On the card a phase's ``wall_s``
is the host's time inside it: the time to issue its work, plus whatever
synchronisations the code already makes there (a solve's per-iteration
copy of its bottleneck to the host, a pool pass whose results the caller
reads back). The device time of the work a phase launches stays with the
profiler (``torch.profiler``), not here.

Not thread-safe, by design: the simulator is single-threaded, and the
searcher's worker processes (``sched_search.search(n_jobs > 1)``) keep
their own accumulators, which die with them: only the parent's phases are
reported.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

ENABLED = False

PHASES = ("engine_solve", "pool_solve", "rng", "packing")

_acc: dict[str, float] = {}
_calls: dict[str, int] = {}


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def reset() -> None:
    _acc.clear()
    _calls.clear()


def record(phase: str, seconds: float) -> None:
    _acc[phase] = _acc.get(phase, 0.0) + seconds
    _calls[phase] = _calls.get(phase, 0) + 1


@contextmanager
def phase(name: str):
    """Time a block into ``name``; a no-op (yield only) when disabled."""
    if not ENABLED:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(name, time.perf_counter() - t0)


def report() -> dict[str, dict[str, float | int]]:
    """{phase: {"wall_s": seconds, "calls": n}} for every phase seen."""
    return {name: {"wall_s": round(_acc[name], 4), "calls": _calls[name]}
            for name in sorted(_acc)}
