"""Collective bytes of a step, counted where the stacked backend executes
its collectives (counterpart of ``repro.launch.hlo_stats``).

The reference parses its collectives out of the compiled HLO text. The
port has no HLO: every collective it runs goes through
``core/collectives.py`` (the ring gathers' and ring reduce-scatters'
autograd Functions, forward and backward, concurrent AG/RS, the plain
gather and the pipelined broadcast; ``over_axis``, the FSDP gathers and
``sharding/tp.py`` all reach these), and each records itself here once per
execution: its kind, its group size g, the bytes of one rank's result and
the number of groups. The bytes are hlo_stats's ring-equivalent per-device
bytes of one instruction that runs all the groups:

    all-gather        (g-1)/g * result_bytes      (result = gathered buffer)
    reduce-scatter    (g-1)   * result_bytes      (input = g * result)
    all-reduce        2 (g-1)/g * result_bytes    (RS + AG)
    all-to-all        (g-1)/g * result_bytes
    collective-permute          result_bytes

and ``total_bytes`` adds per-device bytes times g (times the device count
for a collective-permute), as hlo_stats does. A tensor-parallel all-reduce
(``sharding/tp.all_reduce``) runs as a reduce-scatter and then a gather,
and is counted as the two, which sum to the all-reduce formula.

Counting executed calls replaces hlo_stats's ``_loop_multiplier``: XLA's
text holds a loop body once and the reference scales it by the loop's trip
count, where here a layer's collectives record themselves each time the
layer runs (and again where a recompute runs them again). The counts come
from shapes and dtypes alone: no host sync, no read of a device tensor,
so they are the same on CUDA, CPU and meta tensors. Autograd runs a CUDA
backward on a thread of its own, so the recorders are process-wide, not
thread-local.

    with counting(n_devices=mesh.n_ranks) as st:
        state, metrics = train_step(state, batch)
    st.as_dict()   # per_device_bytes, per_device_total, total_bytes, counts
"""
from __future__ import annotations

import contextlib
import threading
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class CollectiveStats:
    per_device_bytes: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    total_bytes: int = 0                 # summed over participating devices
    counts: dict[str, int] = field(default_factory=lambda: defaultdict(int))
    n_devices: int = 1
    # (kind, g, result bytes of one rank, groups) of every recorded collective
    records: list[tuple[str, int, int, int]] = field(default_factory=list)

    def as_dict(self) -> dict:
        return {
            "per_device_bytes": dict(self.per_device_bytes),
            "per_device_total": sum(self.per_device_bytes.values()),
            "total_bytes": self.total_bytes,
            "counts": dict(self.counts),
        }

    def add(self, kind: str, g: int, result_bytes: int, groups: int) -> None:
        per_dev = per_device_bytes(kind, result_bytes, g)
        self.per_device_bytes[kind] += per_dev
        self.total_bytes += per_dev * (self.n_devices if kind == "collective-permute" else g)
        self.counts[kind] += 1
        self.records.append((kind, g, result_bytes, groups))


def per_device_bytes(kind: str, result_bytes: int, g: int) -> int:
    """hlo_stats's ring-equivalent bytes a device moves in one collective."""
    g = max(g, 1)
    if kind == "all-gather":
        return result_bytes * (g - 1) // g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) // g
    if kind == "all-to-all":
        return result_bytes * (g - 1) // g
    if kind == "collective-permute":
        return result_bytes
    raise ValueError(f"unknown collective {kind!r}")


_active: list[CollectiveStats] = []
_lock = threading.Lock()
# one rank's rows of the collectives being issued: ``core.collectives.over_axis``
# folds a rank's inner dims into the groups of the (..., P, n) it hands them
_rows: list[int] = [1]


def recording() -> bool:
    """Whether a ``counting`` context is open (in any thread)."""
    return bool(_active)


def record(kind: str, g: int, result_bytes: int, groups: int = 1) -> None:
    """One executed collective: ``kind`` over groups of ``g`` ranks, each
    rank's result ``result_bytes`` bytes, ``groups`` groups at once."""
    if not _active:
        return
    with _lock:
        for st in _active:
            st.add(kind, g, result_bytes, groups)


def rows() -> int:
    """One rank's rows of the collectives being issued (``per_rank_rows``)."""
    return _rows[-1]


@contextlib.contextmanager
def per_rank_rows(n: int):
    """The collectives issued inside hold ``n`` rows a rank: ``n`` of the
    leading dims of their (..., P, m) results are one rank's data, not
    groups of other ranks. Issuing runs on the caller's thread; a backward
    records with the rows its forward saw (``core.collectives``)."""
    _rows.append(n)
    try:
        yield
    finally:
        _rows.pop()


def record_stacked(kind: str, result_shape, itemsize: int, rows: int = 1) -> None:
    """A collective whose stacked result is ``result_shape`` (..., P, m):
    the leading dims are its groups times ``rows`` rows a rank, P its group
    size, rows * m * itemsize the bytes of one rank's result."""
    if not _active:
        return
    *lead, p, m = result_shape
    groups = 1
    for d in lead:
        groups *= d
    record(kind, p, rows * m * itemsize, groups // rows)


@contextlib.contextmanager
def counting(n_devices: int = 1):
    """Count every collective executed until the block ends, by any thread.
    ``n_devices`` prices a collective-permute's total, as hlo_stats's."""
    st = CollectiveStats(n_devices=n_devices)
    with _lock:
        _active.append(st)
    try:
        yield st
    finally:
        with _lock:
            _active.remove(st)
