"""Rank-batched matmul kernel with an f32 accumulator, and the
allgather-fused matmul built on it: the ports of ``matmul_pallas`` and
``allgather_matmul_local`` (src/repro/kernels/collective_matmul.py:43, :68).

``matmul(x, w)`` computes ``(R, M, K) @ (R, K, N) -> (R, M, N)`` rank by rank,
summing in f32 and rounding once to ``x.dtype``, for bf16 and f32. It is the
product under every gathered weight: the FSDP hot loop that module names,
allgather(weights) -> matmul. Operands may be strided views (a transposed
weight, the tied head ``embed^T``), so the backward products need no copies;
the output is a new contiguous tensor, or ``out=``, which may be a strided
view. ``csrc/matmul.cu`` says how the kernel is built and what bounds it.

``matmul`` launches the kernel for CUDA tensors and runs ``matmul_plain``
only for CPU tensors; ``launches`` counts kernel launches. ``RankMatmul``
is the autograd Function whose forward and both backward products go
through ``matmul``.

``allgather_matmul_local(x, w)`` is ``allgather(x) @ w`` for activation
rows sharded over the ranks of a stacked ``x (..., P, m, K)`` and a
replicated ``w (K, N)``, on the reference's schedule: at step s rank d
multiplies the shard ``(d - s) % P`` it holds while passing that shard on
to rank d + 1. On the card the products run on the current stream and the
ring steps (``ring_allgather.ring_step``) on a side stream, so product s
and ring step s overlap; one event per ring step holds product s + 1 back
until its shard has landed. ``make_allgather_matmul`` runs it over one axis
of a ``StackedMesh``. There is no TPU kernel of its own: on the TPU it is
``matmul_pallas`` under a ``lax.scan`` of ``ppermute``s, here the ring-step
and matmul kernels on two streams. ``allgather_launches`` counts the calls
that ran that two-stream schedule on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import collectives as C
from repro_torch.device import overlapped
from repro_torch.kernels import build
from repro_torch.kernels.ring_allgather import ring_step
from repro_torch.launch.mesh import StackedMesh

launches = 0
allgather_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_RANKS = 65535        # gridDim.z
_MAX_ROWS = 65535 * 64    # gridDim.y times the smaller (f32) row tile
_ARGTYPES = [ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"matmul takes (R, M, K) and (R, K, N), got {tuple(x.shape)} "
                         f"and {tuple(w.shape)}")
    if x.shape[0] != w.shape[0] or x.shape[2] != w.shape[1]:
        raise ValueError(f"shapes {tuple(x.shape)} and {tuple(w.shape)} do not multiply")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"matmul takes two tensors of one of {list(_DTYPES)}, "
                        f"got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"operands on {x.device} and {w.device}")
    if min(x.shape) < 1 or w.shape[2] < 1:
        raise ValueError("matmul operands must not be empty")


def _check_out(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor) -> None:
    want = (x.shape[0], x.shape[1], w.shape[2])
    if tuple(out.shape) != want or out.dtype != x.dtype or out.device != x.device:
        raise ValueError(f"out must be {want} {x.dtype} on {x.device}, got "
                         f"{tuple(out.shape)} {out.dtype} on {out.device}")


def matmul_plain(x: torch.Tensor, w: torch.Tensor, *,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """The same product in plain torch: f32 sums, rounded once to x.dtype."""
    _check(x, w)
    y = torch.bmm(x.float(), w.float()).to(x.dtype)
    if out is None:
        return y
    _check_out(x, w, out)
    return out.copy_(y)


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """(R, M, K) @ (R, K, N) -> (R, M, N) in x.dtype, into ``out`` when given
    (any strides whose elements do not overlap). Launches the CUDA kernel
    for CUDA tensors, runs the plain version for CPU tensors, and raises for
    any other device."""
    global launches
    if x.device.type == "cpu" and w.device.type == "cpu":
        return matmul_plain(x, w, out=out)
    if x.device.type != "cuda":
        raise ValueError(f"matmul runs on cuda or cpu tensors, got {x.device}")
    _check(x, w)
    r, m, k = x.shape
    n = w.shape[2]
    if r > _MAX_RANKS or m > _MAX_ROWS:
        raise ValueError(f"{r} ranks x {m} rows exceed the kernel's grid")
    if out is None:
        out = torch.empty((r, m, n), dtype=x.dtype, device=x.device)
    else:
        _check_out(x, w, out)
    fn = build.load("matmul").matmul
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(_DTYPES[x.dtype], x.data_ptr(), *x.stride(), w.data_ptr(), *w.stride(),
                 out.data_ptr(), *out.stride(), r, m, n, k, stream)
    if err:
        raise RuntimeError(f"matmul launch failed: cudaError {err}")
    launches += 1
    return out


class RankMatmul(torch.autograd.Function):
    """y = x @ w rank by rank; dx = dy @ w^T and dw = x^T @ dy, all three on
    ``matmul`` (the transposes are views)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x, w)
        return matmul(x, w)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy: torch.Tensor):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype)
        dx = matmul(dy, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        dw = matmul(x.transpose(1, 2), dy) if ctx.needs_input_grad[1] else None
        return dx, dw


# ------------------------------------------------------ allgather-matmul


def check_tile(dim: int, tile: int, name: str) -> None:
    """The reference's precondition on a Pallas tile (collective_matmul.py:52):
    ``dim`` a multiple of ``min(tile, dim)``. The tiles pick nothing here:
    the kernels' own tiles are fixed."""
    if tile < 1 or dim % min(tile, dim):
        raise ValueError(f"{name}={dim} is not a multiple of its tile {min(tile, dim)}")


def _check_tiles(m: int, k: int, n: int, bm: int, bk: int, bn: int) -> None:
    for dim, tile, name in ((m, bm, "m"), (k, bk, "k"), (n, bn, "n")):
        check_tile(dim, tile, name)


def _diagonals(t: torch.Tensor, s: int) -> list[torch.Tensor]:
    """Block ``(d - s) % P`` of rank d of ``t (P, P, rows, cols)``, for every
    rank d, as (ranks, rows, cols) views: ranks d >= s, then ranks d < s."""
    p = t.shape[0]
    views = [t.diagonal(offset=-s, dim1=0, dim2=1).movedim(-1, 0)]
    if s:
        views.append(t.diagonal(offset=p - s, dim1=0, dim2=1).movedim(-1, 0))
    return views


def _allgather_matmul(x: torch.Tensor, w: torch.Tensor, mm, overlap: bool) -> torch.Tensor:
    """The schedule of ``allgather_matmul_local`` with product ``mm``: with
    ``overlap``, the ring steps on the side stream; without, every step in
    order on the current stream."""
    *lead, p, m, k = x.shape
    n = w.shape[1]
    buf = C._ring_buffer(x.reshape(*lead, p, m * k))          # (..., P, P, m K)
    out = torch.empty((*lead, p, p * m, n), dtype=x.dtype, device=x.device)
    pairs = list(zip(buf.view(-1, p, p, m, k), out.view(-1, p, p, m, n)))

    def products(s: int) -> None:
        for xs, ys in pairs:                                   # one group at a time
            for a, y in zip(_diagonals(xs, s), _diagonals(ys, s)):
                mm(a, w.expand(a.shape[0], k, n), out=y)

    if not overlap:
        for s in range(p):
            products(s)
            if s < p - 1:
                ring_step(buf, s)
        return out
    global allgather_launches
    main = torch.cuda.current_stream(x.device)
    with overlapped(x.device, buf) as side:
        # ring step s reads the slot product s reads and writes one that only
        # product s + 1 reads: the two run at once, product s + 1 waits
        landed = []
        for s in range(p):
            if s < p - 1:
                with torch.cuda.stream(side):
                    ring_step(buf, s)
                    landed.append(torch.cuda.Event())
                    landed[s].record(side)
            if s:
                main.wait_event(landed[s - 1])
            products(s)
    allgather_launches += 1
    return out


def allgather_matmul_local(x: torch.Tensor, w: torch.Tensor, *, use_pallas: bool = True,
                           bm: int = 128, bk: int = 128, bn: int = 128) -> torch.Tensor:
    """``allgather(x) @ w`` on the stacked backend: x (..., P, m, K), rank
    d's row shard at [..., d, :, :] (leading dims are independent groups),
    w (K, N) replicated -> (..., P, P m, N), every rank's copy of the
    product of all P m rows. ``use_pallas`` picks the matmul kernel (True)
    or the reference's ``jnp.dot`` branch, the same f32-summed product in
    plain torch (False); the tiles only pass the reference's precondition.
    On a CUDA tensor the ring steps run on a side stream beside the
    products; on a CPU tensor the same steps run in order on the plain
    versions. Either way the result equals the plain gather followed by one
    ``matmul`` of the gathered rows, bitwise (the kernel has no split-K,
    so a row's sums do not depend on the rows beside it; torch's CPU
    product of a single row, m = 1, sums in another order)."""
    if x.dim() < 3 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"allgather_matmul takes x (..., P, m, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.requires_grad or w.requires_grad:
        raise NotImplementedError("allgather_matmul_local has no backward in the port; the "
                                  "FSDP path's gathers and RankMatmul have theirs")
    m, k = x.shape[-2:]
    if use_pallas:
        _check_tiles(m, k, w.shape[1], bm, bk, bn)
    mm = matmul if use_pallas else matmul_plain
    if x.device.type == "cpu":
        return _allgather_matmul(x, w, mm, overlap=False)
    if x.device.type != "cuda":
        raise ValueError(f"allgather_matmul runs on cuda or cpu tensors, got {x.device}")
    return _allgather_matmul(x, w, mm, overlap=True)


def make_allgather_matmul(mesh: StackedMesh, axis: str, **kw):
    """``allgather(x, axis) @ w`` over ``axis`` of a stacked mesh: x (R, m, K),
    R = mesh.n_ranks, row-sharded over ``axis`` (the other dp axes are
    groups, as in ``core.collectives.over_axis``), w (K, N) replicated ->
    (R, P m, N), every rank's copy. ``kw`` as ``allgather_matmul_local``."""
    def run(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        r, m, k = x.shape
        local = functools.partial(_flat_local, m=m, w=w, kw=kw)
        return C.over_axis(x.reshape(r, m * k), mesh, axis, local).reshape(r, -1, w.shape[1])

    return run


def _flat_local(x: torch.Tensor, *, m: int, w: torch.Tensor, kw: dict) -> torch.Tensor:
    """(..., P, m K) -> (..., P, P m N): ``allgather_matmul_local`` on flat rows."""
    y = allgather_matmul_local(x.reshape(*x.shape[:-1], m, -1), w, **kw)
    return y.reshape(*y.shape[:-2], -1)
