"""Ring-step kernels of the stacked collective backend: the allgather's
step and its exact transpose.

``ring_step`` replaces ``ring_allgather_tpu``
(src/repro/kernels/ring_allgather.py:46), the Pallas kernel in which device
d remote-DMAs shard ``(d - s) % P`` to device ``(d + 1) % P`` at grid step s
of P - 1. On one GPU the P ranks are dim 1 of a stacked buffer
``(G, P_rank, P_slot, n)`` and a launch of ``csrc/ring_step.cu`` does one
step for every rank at once, following the same ``ring_schedule``.

``ring_step_transpose`` (``csrc/ring_step_transpose.cu``) is the adjoint of
one such step over the same (sender, receiver, slot) triples:
``g[..., snd, src] += g[..., rcv, src]``. The data flows against the ring:
a rank receives its neighbour's partial sum, adds its own cotangent, and
passes it on at the next step. Replayed in reverse step order it is the
backward of the gathers (``core/collectives.py``) and the port's ring
reduce-scatter; the TPU has no kernel for it (JAX transposes the
``ppermute`` ring itself).

Bound: HBM bytes. A step copies one slot per rank, 2 * P * n * itemsize
bytes; the transposed step reads two slots and writes one, 3 * P * n *
itemsize. Both kernels walk 16-byte vectors in a grid-stride loop over one
rank's slot per block row, with a scalar head and tail for spans off a
16-byte boundary. At the shapes of a smollm-135m layer a step moves a few
MB, about a microsecond at HBM speed, so the launch itself dominates;
fusing steps is later work.

``local_double_buffer_drain`` replaces the Pallas kernel of the same name
(src/repro/kernels/ring_allgather.py:94): the local-copy half of the ring
engine, staged chunks drained in order through a two-slot staging ring
(``csrc/double_buffer_drain.cu``). It is an identity copy, bitwise, of
``staged (n_steps, rows, cols)`` in any dtype; bound by HBM bytes, 2 *
staged.nbytes.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version only for a CPU tensor. ``launches``, ``transpose_launches`` and
``drain_launches`` count kernel launches. The kernels are built with
``nvcc`` into ``build/`` at their first launch (``kernels/build.py``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0             # ring_step kernel launches
transpose_launches = 0   # ring_step_transpose kernel launches
drain_launches = 0       # double_buffer_drain kernel launches

_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
_MAX_ROWS = 65535  # gridDim.y
_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


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


def _check(buf: torch.Tensor, step: int, direction: int, split: int | None,
           rounds: int, active_round: int) -> int:
    if buf.dim() < 3:
        raise ValueError(f"ring buffer must be (..., P, P, n), got {tuple(buf.shape)}")
    p, p2, n = buf.shape[-3:]
    if p != p2:
        raise ValueError(f"ring buffer needs P ranks x P slots, got {tuple(buf.shape)}")
    if buf.dtype not in _DTYPES:
        raise TypeError(f"ring_step supports {_DTYPES}, got {buf.dtype}")
    if not buf.is_contiguous():
        raise ValueError("ring buffer must be contiguous")
    if n < 1:
        raise ValueError("ring buffer slots are empty")
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


def _launch(name: str, buf: torch.Tensor, step: int, direction: int, split: int | None,
            rounds: int, active_round: int) -> None:
    if buf.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {buf.device}")
    split = _check(buf, step, direction, split, rounds, active_round)
    p, n = buf.shape[-2], buf.shape[-1]
    if split == 0:  # everything moves along -direction
        direction, split = -direction, n
    groups = buf.numel() // (p * p * n)
    if groups * p > _MAX_ROWS:
        raise ValueError(f"{groups} groups x {p} ranks exceed {_MAX_ROWS} block rows")
    fn = getattr(build.load(name), name)
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    dtype_code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[buf.dtype]
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        err = fn(buf.data_ptr(), dtype_code, groups, p, n, step, direction, split, rounds,
                 active_round, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def ring_step(buf: torch.Tensor, step: int, *, direction: int = 1,
              split: int | None = None, rounds: int = 1,
              active_round: int = 0) -> torch.Tensor:
    """One ring step, in place on ``buf`` (..., P, P, n); see ``ring_step_plain``.
    Launches the CUDA kernel for a CUDA tensor, runs the plain version for a
    CPU tensor, and raises for any other device."""
    global launches
    if buf.device.type == "cpu":
        return ring_step_plain(buf, step, direction=direction, split=split,
                               rounds=rounds, active_round=active_round)
    _launch("ring_step", buf, step, direction, split, rounds, active_round)
    launches += 1
    return buf


def ring_step_transpose(buf: torch.Tensor, step: int, *, direction: int = 1,
                        split: int | None = None, rounds: int = 1,
                        active_round: int = 0) -> torch.Tensor:
    """The transposed ring step, in place on a cotangent buffer (..., P, P, n);
    see ``ring_step_transpose_plain``. Launches the CUDA kernel for a CUDA
    tensor, runs the plain version for a CPU tensor, raises otherwise."""
    global transpose_launches
    if buf.device.type == "cpu":
        return ring_step_transpose_plain(buf, step, direction=direction, split=split,
                                         rounds=rounds, active_round=active_round)
    _launch("ring_step_transpose", buf, step, direction, split, rounds, active_round)
    transpose_launches += 1
    return buf


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
    if staged.device.type == "cpu":
        return local_double_buffer_drain_plain(staged)
    if staged.device.type != "cuda":
        raise ValueError(f"local_double_buffer_drain runs on cuda or cpu tensors, got "
                         f"{staged.device}")
    _check_staged(staged)
    n_steps = staged.shape[0]
    if n_steps > _MAX_ROWS:
        raise ValueError(f"{n_steps} steps exceed {_MAX_ROWS} block rows")
    out = torch.empty_like(staged, memory_format=torch.contiguous_format)
    if staged.numel() == 0:
        return out
    fn = build.load("double_buffer_drain").double_buffer_drain
    fn.argtypes, fn.restype = _DRAIN_ARGTYPES, ctypes.c_int
    with torch.cuda.device(staged.device):
        stream = torch.cuda.current_stream(staged.device).cuda_stream
        err = fn(staged.data_ptr(), out.data_ptr(), n_steps,
                 staged.numel() // n_steps * staged.element_size(), stream)
    if err:
        raise RuntimeError(f"double_buffer_drain launch failed: cudaError {err}")
    drain_launches += 1
    return out
