"""Distributed Broadcast sequencer (paper §IV-A + Appendix A): the pure
rank arithmetic of the M-chain Allgather.

A copy of ``src/repro/core/schedule.py`` (the whole module). The P
participants are split into M parallel broadcast chains; when M divides P
every chain has length R = P/M and at step i the active root group is

    G^i = { P_i, P_{R+i}, P_{2R+i}, ..., P_{(M-1)R+i} }        (Appendix A)

When M does not divide P the chains are uneven: the first P mod M chains
carry ceil(P/M) ranks, the rest floor(P/M), so R = ceil(P/M) and the last
steps activate fewer than M roots; every rank still broadcasts exactly
once. Within a chain the members broadcast one by one (the activation
signal travels along the chain); across chains everything is concurrent.
``core/sched_ir.py`` builds the schedule graph that the engines execute
from it.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class BroadcastStep:
    """One step of the Allgather schedule."""
    index: int
    roots: tuple[int, ...]          # active broadcasting processes G^i


def n_rounds(p: int, m: int) -> int:
    """Schedule length R = ceil(P/M) (== P/M when M | P)."""
    _check(p, m)
    return -(-p // m)


def chain_lengths(p: int, m: int) -> tuple[int, ...]:
    """Ranks per chain: the first P mod M chains take the extra rank, so the
    last chains are the shorter ones (even split when M | P)."""
    _check(p, m)
    r, rem = divmod(p, m)
    return (r + 1,) * rem + (r,) * (m - rem)


def _check(p: int, m: int) -> None:
    if not 1 <= m <= p:
        raise ValueError(f"need 1 <= M={m} <= P={p}")


def _chain_starts(p: int, m: int) -> tuple[int, ...]:
    starts, off = [], 0
    for ln in chain_lengths(p, m):
        starts.append(off)
        off += ln
    return tuple(starts)


def chain_of(rank: int, p: int, m: int) -> int:
    """Which chain a rank belongs to: chain c holds the contiguous block
    [start_c, start_c + len_c)."""
    assert 0 <= rank < p, (rank, p)
    starts = _chain_starts(p, m)
    for c in range(m - 1, -1, -1):
        if rank >= starts[c]:
            return c
    raise AssertionError(rank)


def chain_members(m_idx: int, p: int, m: int) -> tuple[int, ...]:
    start = _chain_starts(p, m)[m_idx]
    return tuple(range(start, start + chain_lengths(p, m)[m_idx]))


def active_group(step: int, p: int, m: int) -> tuple[int, ...]:
    """G^step per Appendix A, generalized to uneven chains: the step-th
    member of every chain still that long. For M | P this is exactly
    { step + j*R : j < M }."""
    r = n_rounds(p, m)
    if not 0 <= step < r:
        raise ValueError(f"step {step} out of range [0, {r})")
    starts = _chain_starts(p, m)
    lens = chain_lengths(p, m)
    return tuple(starts[c] + step for c in range(m) if lens[c] > step)


def allgather_schedule(p: int, m: int) -> list[BroadcastStep]:
    """The full R-step schedule; every rank roots exactly once."""
    return [BroadcastStep(i, active_group(i, p, m))
            for i in range(n_rounds(p, m))]


def activation_edges(p: int, m: int) -> list[tuple[int, int]]:
    """(from, to) pairs of the chain activation signal (§IV-A): when ``from``
    finishes multicasting it activates ``to`` — its successor in the chain."""
    edges = []
    for c in range(m):
        members = chain_members(c, p, m)
        edges += list(zip(members[:-1], members[1:]))
    return edges


def subgroup_assignment(n_subgroups: int, buffer_len: int) -> list[tuple[int, int]]:
    """Packet parallelism (§IV-C): split the send buffer into contiguous blocks,
    one per multicast subgroup / worker queue. Returns [start, end) per subgroup."""
    q, rem = divmod(buffer_len, n_subgroups)
    out, off = [], 0
    for i in range(n_subgroups):
        ln = q + (1 if i < rem else 0)
        out.append((off, off + ln))
        off += ln
    return out


def worker_split(n_subgroups: int, n_participants: int) -> tuple[int, int]:
    """Send/receive worker allocation (§IV-C discrepancy rule): the receive
    path handles (P-1)x the send-path bytes, so receive workers scale with
    the multicast subgroup count — but never beyond the P-1 peers that can
    be concurrently sending (extra workers past that would idle). One send
    worker serves all send queues. Paper example: 16 procs, 4 subgroups ->
    1 send worker / 4 receive workers."""
    assert n_subgroups >= 1 and n_participants >= 1, (n_subgroups,
                                                     n_participants)
    return 1, max(min(n_subgroups, n_participants - 1), 1)


def validate_schedule(p: int, m: int) -> None:
    """Invariants the hypothesis tests rely on (uneven chains included)."""
    sched = allgather_schedule(p, m)
    r = n_rounds(p, m)
    lens = chain_lengths(p, m)
    assert len(sched) == r
    assert sum(lens) == p
    assert max(lens) - min(lens) <= 1           # last chains at most 1 shorter
    seen: set[int] = set()
    for st in sched:
        live = {c for c in range(m) if lens[c] > st.index}
        assert len(st.roots) == len(live)
        # one root per still-active chain in every step
        assert {chain_of(x, p, m) for x in st.roots} == live
        assert not (set(st.roots) & seen)
        seen.update(st.roots)
    assert seen == set(range(p)), "every rank must broadcast exactly once"
