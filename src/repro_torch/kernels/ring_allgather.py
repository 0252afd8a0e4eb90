"""Ring kernels of the stacked collective backend: the allgather (a whole
schedule in one launch, or one step), its transpose (a whole schedule in one
launch), and the double-buffered drain.

``ring_allgather`` replaces ``ring_allgather_tpu``
(src/repro/kernels/ring_allgather.py:46), the Pallas kernel in which device
d remote-DMAs shard ``(d - s) % P`` to device ``(d + 1) % P`` at grid step s
of P - 1. On one GPU the P ranks are dim 1 of the stacked shards ``x (G,
P_rank, n)`` and of a buffer ``(G, P_rank, P_slot, n)``, and one launch of
``csrc/ring_allgather.cu`` installs each rank's own shard in its own slot,
as the TPU kernel does, then runs every entry of a schedule, in order, each
entry one ring step for every rank at once (a schedule longer than the
128 entries a launch carries takes one launch per 128). A schedule is a tuple of entries ``(step, direction,
split, rounds, active_round)`` (``split`` None: the whole slot), as
``core/collectives.py`` builds them for the ring, the bidirectional ring
and the composition of broadcasts; any prefix of one is a schedule too.
``ring_step`` is one entry, in place, in one launch of the same kernel with
no install (the shards pointer null); only the allgather-matmul's ring
schedule (``use_pallas=False``, and the CPU's) still takes it.

``ring_allgather_transpose`` (``csrc/ring_allgather_transpose.cu``) is the
adjoint of a whole gather: a cotangent ``g (G, P_rank, P_slot, n)`` ->
``(G, P, n)``, the schedule's steps transposed, ``g[..., snd, src] +=
g[..., rcv, src]`` over the same (sender, receiver, slot) triples, in
reverse order, then the diagonal. The data flows against the ring: a rank
takes its neighbour's partial sum, adds its own cotangent, and passes it
on at the next step. It is the backward of the gathers and the port's ring
reduce-scatter (``core/collectives.py``), one launch each; the TPU has no
kernel for it (JAX transposes the ``ppermute`` ring itself). On the ring,
bidi and broadcast schedules the launch only reads ``g`` and writes the
result; other schedules, P > 32 and more than 128 entries work in place on
a scratch copy (``_packed_transpose``). ``ring_step_transpose_plain``, one
transposed step in plain torch, is the transpose's plain version replayed
entry by entry; no kernel runs one step alone.

Bound: HBM bytes. A whole gather reads every rank's shard once and writes
every rank's gathered copy once, (P * P + P) * n * itemsize bytes per
group; its transpose reads every slot of ``g`` once and writes the result
once, the same bytes. A step copies one slot per rank, 2 * P * n * itemsize
bytes. At the shapes of a smollm-135m layer a step moves a few MB, about
a microsecond at HBM speed, so a launch per step is set by the host; one
launch per gather, and per gather backward, pays that once.

``local_double_buffer_drain`` replaces the Pallas kernel of the same name
(src/repro/kernels/ring_allgather.py:94): the local-copy half of the ring
engine, staged chunks drained in order through a two-slot staging ring
(``csrc/double_buffer_drain.cu``). It is an identity copy, bitwise, of
``staged (n_steps, rows, cols)`` in any dtype; bound by HBM bytes, 2 *
staged.nbytes.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version only for a CPU tensor. ``allgather_launches``,
``allgather_transpose_launches``, ``launches`` (the one-step launches of
the gather's kernel) and ``drain_launches`` count kernel launches; ``entries`` and
``transpose_entries`` count the schedule entries that the ``ring_allgather``
and ``ring_allgather_transpose`` launches ran, by kind: "ring", "bidi" (a
split inside the slot) and "bcast" (a round mask). The kernels are built
with ``nvcc`` into ``build/`` at their first launch and bound once
(``kernels/build.py``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

allgather_launches = 0   # ring_allgather kernel launches
entries = {"ring": 0, "bidi": 0, "bcast": 0}   # schedule entries those launches ran
allgather_transpose_launches = 0   # ring_allgather_transpose kernel launches
transpose_entries = {"ring": 0, "bidi": 0, "bcast": 0}   # schedule entries those launches ran
launches = 0             # ring_step launches (one entry of the ring_allgather kernel)
drain_launches = 0       # double_buffer_drain kernel launches

_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_MAX_ROWS = 65535  # gridDim.y
_MAX_ENTRIES = 128  # kMaxEntries of csrc/ring_allgather{,_transpose}.cu: entries per launch
_MAX_LANES = 32     # kMaxLanes: the most ranks whose column one warp holds
_ALLGATHER_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_longlong, ctypes.POINTER(ctypes.c_longlong),
                       ctypes.c_int, ctypes.c_void_p]
_TRANSPOSE_ARGTYPES = _ALLGATHER_ARGTYPES[:-1] + [ctypes.c_int, ctypes.c_void_p]   # + in_place


def ring_schedule(n_devices: int) -> list[list[tuple[int, int, int]]]:
    """The (sender, receiver, shard) triples per step of the ring allgather."""
    steps = []
    for s in range(n_devices - 1):
        trip = []
        for d in range(n_devices):
            src_shard = (d - s) % n_devices
            trip.append((d, (d + 1) % n_devices, src_shard))
        steps.append(trip)
    return steps


def _check_buf(buf: torch.Tensor) -> tuple[int, int]:
    """(P, n) of a ring buffer (..., P, P, n) that the kernels take."""
    if buf.dim() < 3:
        raise ValueError(f"ring buffer must be (..., P, P, n), got {tuple(buf.shape)}")
    p, p2, n = buf.shape[-3:]
    if p != p2:
        raise ValueError(f"ring buffer needs P ranks x P slots, got {tuple(buf.shape)}")
    if buf.dtype not in _DTYPES:
        raise TypeError(f"ring kernels support {_DTYPES}, got {buf.dtype}")
    if not buf.is_contiguous():
        raise ValueError("ring buffer must be contiguous")
    if n < 1:
        raise ValueError("ring buffer slots are empty")
    return p, n


def _check_entry(p: int, n: int, step: int, direction: int, split: int | None,
                 rounds: int, active_round: int) -> int:
    """The entry's split (n for None), after checking the entry against P and n."""
    if not 0 <= step < p - 1:
        raise ValueError(f"step {step} outside 0..{p - 2}")
    if direction not in (1, -1):
        raise ValueError(f"direction must be +1 or -1, got {direction}")
    if rounds < 1 or p % rounds or not 0 <= active_round < rounds:
        raise ValueError(f"bad round mask {active_round}/{rounds} for P={p}")
    split = n if split is None else split
    if not 0 <= split <= n:
        raise ValueError(f"split {split} outside 0..{n}")
    return split


def _check(buf: torch.Tensor, step: int, direction: int, split: int | None,
           rounds: int, active_round: int) -> int:
    p, n = _check_buf(buf)
    return _check_entry(p, n, step, direction, split, rounds, active_round)


def ring_step_plain(buf: torch.Tensor, step: int, *, direction: int = 1,
                    split: int | None = None, rounds: int = 1,
                    active_round: int = 0) -> torch.Tensor:
    """The same ring step in plain torch, in place on ``buf`` (..., P, P, n):
    ``buf[..., (d + dir) % P, src] = buf[..., d, src]`` with
    ``src = (d - dir * step) % P`` for elements [0, split) and the mirror
    step along ``-dir`` for [split, n); only slots with
    ``src % rounds == active_round`` move."""
    split = _check(buf, step, direction, split, rounds, active_round)
    p, n = buf.shape[-2], buf.shape[-1]
    d = torch.arange(p, device=buf.device)
    for lo, hi, dr in ((0, split, direction), (split, n, -direction)):
        if hi == lo:
            continue
        src = (d - dr * step) % p
        keep = src % rounds == active_round
        snd, src = d[keep], src[keep]
        rcv = (snd + dr) % p
        buf[..., rcv, src, lo:hi] = buf[..., snd, src, lo:hi]
    return buf


def ring_step_transpose_plain(buf: torch.Tensor, step: int, *, direction: int = 1,
                              split: int | None = None, rounds: int = 1,
                              active_round: int = 0) -> torch.Tensor:
    """The adjoint of ``ring_step_plain`` with the same arguments, in place
    on a cotangent buffer (..., P, P, n): ``buf[..., d, src] +=
    buf[..., (d + dir) % P, src]`` over the same triples and masks. The
    receiver's slot keeps its value: it is never read again in reverse
    order, and only the diagonal is read at the end."""
    split = _check(buf, step, direction, split, rounds, active_round)
    p, n = buf.shape[-2], buf.shape[-1]
    d = torch.arange(p, device=buf.device)
    for lo, hi, dr in ((0, split, direction), (split, n, -direction)):
        if hi == lo:
            continue
        src = (d - dr * step) % p
        keep = src % rounds == active_round
        snd, src = d[keep], src[keep]
        rcv = (snd + dr) % p
        buf[..., snd, src, lo:hi] += buf[..., rcv, src, lo:hi]
    return buf


def ring_step(buf: torch.Tensor, step: int, *, direction: int = 1,
              split: int | None = None, rounds: int = 1,
              active_round: int = 0) -> torch.Tensor:
    """One ring step, in place on ``buf`` (..., P, P, n); see ``ring_step_plain``.
    For a CUDA tensor one launch of the gather's kernel
    (``csrc/ring_allgather.cu``) runs this one entry on ``buf`` and installs
    nothing; a CPU tensor takes the plain version; any other device raises."""
    global launches
    if buf.is_cpu:
        return ring_step_plain(buf, step, direction=direction, split=split,
                               rounds=rounds, active_round=active_round)
    if not buf.is_cuda:
        raise ValueError(f"ring_step runs on cuda or cpu tensors, got {buf.device}")
    p, n = _check_buf(buf)
    chunks, _ = _packed(((step, direction, split, rounds, active_round),), p, n)
    launches += _gather_launches(None, buf, p, n, chunks)
    return buf


# ------------------------------------------------ a whole schedule, one launch


def _gather_out(x: torch.Tensor, out: torch.Tensor | None) -> torch.Tensor:
    """``out``, or a new buffer (..., P, P, n) for the shards x (..., P, n),
    after checking that it is one."""
    if x.dim() < 2:
        raise ValueError(f"shards must be (..., P, n), got {tuple(x.shape)}")
    shape = (*x.shape[:-2], x.shape[-2], *x.shape[-2:])
    if out is None:
        return x.new_empty(shape)
    if tuple(out.shape) != shape or out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"out {tuple(out.shape)} {out.dtype} on {out.device} is not "
                         f"{shape} {x.dtype} on {x.device}")
    return out


def ring_allgather_plain(x: torch.Tensor | None, schedule: tuple,
                         out: torch.Tensor | None = None) -> torch.Tensor:
    """The gather in plain torch: rank d's shard ``x[..., d, :]`` into slot
    d of its own row of ``out`` (..., P, P, n) (a new buffer if None), then
    ``ring_step_plain`` over the schedule's entries ``(step, direction,
    split, rounds, active_round)``, in order, in place. A slot that no entry
    reaches keeps what ``out`` held. x None installs nothing (``out`` must
    be given), as the kernel's launch with no shards, which ``ring_step``
    makes with one entry."""
    if x is None:
        if out is None:
            raise ValueError("a gather that installs no shards needs out")
        _check_buf(out)
    else:
        out = _gather_out(x, out)
        out.diagonal(dim1=-3, dim2=-2).copy_(x.transpose(-1, -2))
    for step, direction, split, rounds, active_round in schedule:
        ring_step_plain(out, step, direction=direction, split=split, rounds=rounds,
                        active_round=active_round)
    return out


def _checked(schedule: tuple, p: int, n: int) -> tuple[list[tuple], tuple[tuple[str, int], ...]]:
    """A schedule's entries checked against P and n, ``split`` resolved (n
    for None), and counted by kind."""
    flat, kinds = [], {}
    for step, direction, split, rounds, active_round in schedule:
        split = _check_entry(p, n, step, direction, split, rounds, active_round)
        flat.append((step, direction, split, rounds, active_round))
        kind = "bcast" if rounds > 1 else "bidi" if 0 < split < n else "ring"
        kinds[kind] = kinds.get(kind, 0) + 1
    return flat, tuple(kinds.items())


def _chunks(flat: list[tuple]) -> tuple[tuple[ctypes.Array, int], ...]:
    """Entries as the kernels take them: one (entries, count) per launch, at
    most 128 entries each and at least one launch, five int64 per entry
    (step, direction, split, rounds, active_round)."""
    chunks = tuple(flat[i:i + _MAX_ENTRIES] for i in range(0, len(flat), _MAX_ENTRIES)) or ((),)
    return tuple(((ctypes.c_longlong * (5 * len(c)))(*[v for e in c for v in e]), len(c))
                 for c in chunks)


@functools.lru_cache(maxsize=256)
def _packed(schedule: tuple, p: int, n: int) -> tuple[tuple[tuple[ctypes.Array, int], ...],
                                                      tuple[tuple[str, int], ...]]:
    """A schedule checked against P and n, as the kernel takes it (one
    launch per 128 entries, at least one: it installs the shards), and its
    entries counted by kind. Cached: a gather passes the same few
    schedules again and again."""
    flat, kinds = _checked(schedule, p, n)
    return _chunks(flat), kinds


def ring_allgather(x: torch.Tensor, schedule: tuple,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """The shards x (..., P, n) gathered by ``schedule`` (a tuple of
    ``(step, direction, split, rounds, active_round)`` tuples) into ``out``
    (..., P, P, n), a new buffer if None; see ``ring_allgather_plain``. For
    a CUDA tensor one launch of the kernel installs the shards and runs
    every entry (one more launch per further 128 entries); a CPU tensor
    takes the plain version; any other device raises."""
    global allgather_launches
    if x.is_cpu:
        return ring_allgather_plain(x, schedule, out)
    if not x.is_cuda:
        raise ValueError(f"ring_allgather runs on cuda or cpu tensors, got {x.device}")
    out = _gather_out(x, out)
    p, n = _check_buf(out)
    if not x.is_contiguous():
        raise ValueError("shards must be contiguous")
    chunks, kinds = _packed(tuple(schedule), p, n)
    allgather_launches += _gather_launches(x.data_ptr(), out, p, n, chunks)
    for kind, count in kinds:
        entries[kind] += count
    return out


def _gather_launches(src: int | None, out: torch.Tensor, p: int, n: int,
                     chunks: tuple[tuple[ctypes.Array, int], ...]) -> int:
    """The launches of ``csrc/ring_allgather.cu`` that run ``chunks`` (from
    ``_packed``) in order on ``out`` (..., P, P, n), the first installing
    the shards at data pointer ``src`` (None: no install). Returns how many
    it made."""
    groups = out.numel() // (p * p * n)
    if groups > _MAX_ROWS:
        raise ValueError(f"{groups} groups exceed {_MAX_ROWS} block rows")
    fn = build.function("ring_allgather", "ring_allgather", _ALLGATHER_ARGTYPES)
    for packed, count in chunks:   # only the first launch installs the shards
        build.launch(fn, out, src, out.data_ptr(), _DTYPE_CODES[out.dtype], groups, p, n,
                     packed, count)
        src = None
    return len(chunks)


# ---------------------------------------- a whole schedule's transpose, one launch


def ring_allgather_transpose_plain(g: torch.Tensor, schedule: tuple) -> torch.Tensor:
    """The gather's transpose in plain torch: a copy of the cotangent g
    (..., P, P, n), ``ring_step_transpose_plain`` over the schedule's
    entries in reverse order, in place on the copy, then its diagonal
    (..., P, n): rank d's slot d."""
    buf = g.clone(memory_format=torch.contiguous_format)
    _check_buf(buf)
    for step, direction, split, rounds, active_round in reversed(schedule):
        ring_step_transpose_plain(buf, step, direction=direction, split=split, rounds=rounds,
                                  active_round=active_round)
    return buf.diagonal(dim1=-3, dim2=-2).transpose(-1, -2).contiguous()


def _in_registers(flat: list[tuple], p: int, n: int) -> bool:
    """Whether the entries, in the order the kernel runs them, can run on a
    cotangent that is only read: every slot an entry reads still holds g's
    own value, or is the neighbour's slot that the entry before summed when
    the entry continues it (the same direction, split and round mask, one
    step back), which the kernel takes from the neighbour's lane. Checked
    on each span of elements between two splits, where every entry moves
    along one direction."""
    cuts = sorted({0, n, *(split for _, _, split, _, _ in flat)})
    for lo in cuts[:-1]:
        written, prev = set(), None
        for entry in flat:
            step, direction, split, rounds, active_round = entry
            dr = direction if lo < split else -direction
            chained = prev is not None and prev[0] == step + 1 and prev[1:] == entry[1:]
            moved = []
            for d in range(p):
                src = (d - dr * step) % p
                if src % rounds != active_round:
                    continue
                if (d, src) in written or (not chained and ((d + dr) % p, src) in written):
                    return False
                moved.append((d, src))
            written.update(moved)
            prev = entry
    return True


@functools.lru_cache(maxsize=256)
def _packed_transpose(schedule: tuple, p: int, n: int) -> tuple[
        tuple[tuple[ctypes.Array, int], ...], tuple[tuple[str, int], ...], bool]:
    """A schedule checked against P and n, its entries in the order the
    transpose kernel runs them (the schedule's reverse), one launch per 128
    entries and at least one (it reads the diagonal); the entries counted by
    kind; and whether the launches work in place on a scratch copy of the
    cotangent: for P > 32 (no warp holds a column), for more than one
    launch (the sums pass from launch to launch in memory), and for
    entries that ``_in_registers`` refuses. Cached, as ``_packed``."""
    flat, kinds = _checked(schedule, p, n)
    flat.reverse()
    in_place = p > _MAX_LANES or len(flat) > _MAX_ENTRIES or not _in_registers(flat, p, n)
    return _chunks(flat), kinds, in_place


def ring_allgather_transpose(g: torch.Tensor, schedule: tuple) -> torch.Tensor:
    """The transpose of the gather by ``schedule`` on a cotangent g (..., P,
    P, n) -> a new (..., P, n); see ``ring_allgather_transpose_plain``. For
    a CUDA tensor one launch of the kernel runs every entry and writes the
    result (one more launch per further 128 entries); g is read, never
    written (copied first where it is not contiguous, or where the
    launches work in place). A CPU tensor takes the plain version; any
    other device raises."""
    global allgather_transpose_launches
    if g.is_cpu:
        return ring_allgather_transpose_plain(g, schedule)
    if not g.is_cuda:
        raise ValueError(f"ring_allgather_transpose runs on cuda or cpu tensors, got {g.device}")
    buf = g.contiguous()
    p, n = _check_buf(buf)
    chunks, kinds, in_place = _packed_transpose(tuple(schedule), p, n)
    if in_place and g.is_contiguous():   # the launches write: never into autograd's g
        buf = g.clone()
    groups = buf.numel() // (p * p * n)
    if groups > _MAX_ROWS:
        raise ValueError(f"{groups} groups exceed {_MAX_ROWS} block rows")
    out = buf.new_empty(*buf.shape[:-3], p, n)
    fn = build.function("ring_allgather_transpose", "ring_allgather_transpose",
                        _TRANSPOSE_ARGTYPES)
    for i, (packed, count) in enumerate(chunks):   # only the last launch writes out
        build.launch(fn, buf, buf.data_ptr(), out.data_ptr() if i == len(chunks) - 1 else None,
                     _DTYPE_CODES[buf.dtype], groups, p, n, packed, count, int(in_place))
        allgather_transpose_launches += 1
    for kind, count in kinds:
        transpose_entries[kind] += count
    return out


# ------------------------------------------------- the double-buffered drain

_DRAIN_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p]


def _check_staged(staged: torch.Tensor) -> None:
    if staged.dim() != 3:
        raise ValueError(f"staged must be (n_steps, rows, cols), got {tuple(staged.shape)}")
    if not staged.is_contiguous():
        raise ValueError("staged must be contiguous")


def local_double_buffer_drain_plain(staged: torch.Tensor) -> torch.Tensor:
    """The same drain in plain torch: ``out[s] = staged[s]``, step by step,
    as the Pallas grid runs."""
    _check_staged(staged)
    out = torch.empty_like(staged)
    for s in range(staged.shape[0]):
        out[s] = staged[s]
    return out


def local_double_buffer_drain(staged: torch.Tensor) -> torch.Tensor:
    """staged (n_steps, rows, cols), the chunks received per step -> a new
    tensor holding them drained in order, equal to ``staged`` bitwise.
    Launches the CUDA kernel for a CUDA tensor, runs the plain version for
    a CPU tensor, and raises for any other device."""
    global drain_launches
    if staged.is_cpu:
        return local_double_buffer_drain_plain(staged)
    if not staged.is_cuda:
        raise ValueError(f"local_double_buffer_drain runs on cuda or cpu tensors, got "
                         f"{staged.device}")
    _check_staged(staged)
    n_steps = staged.shape[0]
    if n_steps > _MAX_ROWS:
        raise ValueError(f"{n_steps} steps exceed {_MAX_ROWS} block rows")
    out = torch.empty_like(staged)   # contiguous, as staged is
    if staged.numel() == 0:
        return out
    build.launch(build.function("double_buffer_drain", "double_buffer_drain", _DRAIN_ARGTYPES),
                 staged, staged.data_ptr(), out.data_ptr(), n_steps, staged.nbytes // n_steps)
    drain_launches += 1
    return out
