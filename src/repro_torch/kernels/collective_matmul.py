"""Rank-batched matmul kernel with an f32 accumulator, and the
allgather-fused matmul built on it: the ports of ``matmul_pallas`` and
``allgather_matmul_local`` (src/repro/kernels/collective_matmul.py:43, :68).

``matmul(x, w)`` computes ``(R, M, K) @ (R, K, N) -> (R, M, N)`` rank by rank,
summing in f32 and rounding once to ``x.dtype``, for bf16 and f32. It is the
product under every gathered weight: the FSDP hot loop that module names,
allgather(weights) -> matmul. Operands may be strided views (a transposed
weight, the tied head ``embed^T``, a weight expanded over the ranks), so the
backward products need no copies; the output is a new contiguous tensor, or
``out=``, which may be a strided view. ``csrc/matmul.cu`` says how the
kernels are built and what bounds them.

``matmul`` launches a kernel for CUDA tensors and runs ``matmul_plain``
only for CPU tensors. ``path`` picks the kernel from dtype, alignment and
strides alone: bf16 operands that TMA can describe (``tma_layout``) go to
the wgmma kernel, other bf16 operands to the wmma kernel, f32 to the FMA
kernel. ``launches``, ``launches_wmma`` and ``launches_f32`` count each
path's launches. ``rank_matmul`` is the op (``repro_torch::rank_matmul``)
whose forward and both backward products go through ``matmul``.

``allgather_matmul_local(x, w)`` is ``allgather(x) @ w`` for activation
rows sharded over the ranks of a stacked ``x (..., P, m, K)`` and a
replicated ``w (K, N)``. On one card the P stacked ranks share one memory,
so on a CUDA tensor every rank's product reads all P shards where they lie
in ``x``: one ``matmul`` launch per group of the leading dims, with A the
group's P m rows at a rank stride of 0 (the kernel's TMA loads are the
ring's hops). Each rank still computes its own copy, the P-fold work of P
ranks. On a CPU tensor it runs the reference's schedule with the plain
products: at step s rank d multiplies the shard ``(d - s) % P`` it holds
while passing that shard on to rank d + 1 (``ring_allgather.ring_step``).
``make_allgather_matmul`` runs it over one axis of a ``StackedMesh``. There
is no TPU kernel of its own: on the TPU it is ``matmul_pallas`` under a
``lax.scan`` of ``ppermute``s. ``allgather_launches`` counts the calls that
ran as one launch per group on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.core import collectives as C
from repro_torch.kernels import build
from repro_torch.kernels.ring_allgather import ring_step
from repro_torch.launch import collective_stats as stats
from repro_torch.launch.mesh import StackedMesh

launches = 0         # the wgmma + TMA kernel (bf16)
launches_wmma = 0    # the wmma kernel (bf16 operands TMA cannot describe)
launches_f32 = 0     # the FMA kernel (f32)
allgather_launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_RANKS = 65535        # gridDim.z
_MAX_ROWS = 65535 * 64    # gridDim.y times the smaller (f32) row tile
_ARGTYPES = [ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_WGMMA_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
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


def tma_layout(t: torch.Tensor, k_dim: int) -> tuple[bool, int, int] | None:
    """How TMA reads the bf16 operand ``t`` (R, rows, cols) whose K dim is
    ``k_dim`` (2 for A, 1 for B): ``(k_major, outer stride, rank stride)``
    in elements, the inner dim being the one of unit stride. None where TMA
    cannot: another dtype, a base off a 16-byte boundary, neither inner dim
    of unit stride, or another stride not a multiple of 16 bytes (or 0). A
    dim of extent 1 takes any stride; the rank stride is 0 where every rank
    reads one matrix (R = 1, or an expanded view). The boxes are 64 x 64,
    within TMA's 256."""
    if t.dtype != torch.bfloat16 or t.data_ptr() % 16:
        return None
    per16 = 16 // t.element_size()
    r, *extent = t.shape
    rank_stride, *stride = t.stride()
    rank_stride = 0 if r == 1 else rank_stride
    if rank_stride % per16:
        return None
    for inner in (1, 0):
        outer = 1 - inner
        if stride[inner] != 1 and extent[inner] != 1:
            continue
        outer_stride = stride[outer]
        if extent[outer] == 1:   # one row: any stride that TMA takes
            outer_stride = -(-extent[inner] // per16) * per16
        if outer_stride > 0 and outer_stride % per16 == 0:
            return inner + 1 == k_dim, outer_stride, rank_stride
    return None


def _plan(x: torch.Tensor, w: torch.Tensor) -> tuple[str, tuple | None, tuple | None]:
    """``path`` with the operands' TMA layouts of the wgmma path."""
    if x.dtype == torch.float32:
        return "f32", None, None
    a, b = tma_layout(x, 2), tma_layout(w, 1)
    return ("wmma", None, None) if a is None or b is None else ("wgmma", a, b)


def path(x: torch.Tensor, w: torch.Tensor) -> str:
    """The kernel ``matmul`` launches for these operands: "wgmma" where TMA
    can describe both (``tma_layout``), "wmma" for other bf16 operands,
    "f32" for f32. Pure: dtype, base alignment and strides alone."""
    return _plan(x, w)[0]


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """(R, M, K) @ (R, K, N) -> (R, M, N) in x.dtype, into ``out`` when given
    (any strides whose elements do not overlap). Launches the kernel that
    ``path`` picks for CUDA tensors, runs the plain version for CPU
    tensors, gives meta tensors (the dry-run) the empty output of
    ``rank_matmul``'s fake, which ``FlopCounterMode`` counts, and raises
    for any other device."""
    global launches, launches_wmma, launches_f32
    if x.is_cpu and w.is_cpu:
        return matmul_plain(x, w, out=out)
    if x.is_meta:
        _check(x, w)
        if out is not None:
            _check_out(x, w, out)
            return out
        with torch.no_grad():
            return rank_matmul(x, w)
    if not x.is_cuda:
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
    kind, la, lb = _plan(x, w)
    if kind == "wgmma":
        build.launch(build.function("matmul", "matmul_wgmma", _WGMMA_ARGTYPES), x,
                     x.data_ptr(), *la, w.data_ptr(), *lb, out.data_ptr(), *out.stride(),
                     r, m, n, k)
    else:
        build.launch(build.function("matmul", "matmul", _ARGTYPES), x, _DTYPES[x.dtype],
                     x.data_ptr(), *x.stride(), w.data_ptr(), *w.stride(), out.data_ptr(),
                     *out.stride(), r, m, n, k)
    if kind == "wgmma":
        launches += 1
    elif kind == "wmma":
        launches_wmma += 1
    else:
        launches_f32 += 1
    return out


@torch.library.custom_op("repro_torch::rank_matmul", mutates_args=())
def rank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = x @ w rank by rank on ``matmul``, as one dispatcher op, so that a
    selective-checkpoint policy can name it (``remat="dots"`` keeps its
    output); its backward, dx = dy @ w^T and dw = x^T @ dy, runs on
    ``matmul`` too (the transposes are views)."""
    return matmul(x, w)


def _rank_matmul_setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(*inputs)


def _rank_matmul_backward(ctx, dy: torch.Tensor):
    x, w = ctx.saved_tensors
    dy = dy.to(x.dtype)
    dx = matmul(dy, w.transpose(1, 2)) if ctx.needs_input_grad[0] else None
    dw = matmul(x.transpose(1, 2), dy) if ctx.needs_input_grad[1] else None
    return dx, dw


rank_matmul.register_autograd(_rank_matmul_backward, setup_context=_rank_matmul_setup)


@rank_matmul.register_fake
def _rank_matmul_fake(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The output of a product on meta or fake tensors: no data."""
    _check(x, w)
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))


@register_flop_formula(torch.ops.repro_torch.rank_matmul)
def _rank_matmul_flops(x_shape, w_shape, *args, **kwargs) -> int:
    """2 R M K N: the count ``FlopCounterMode`` gives ``torch.bmm``."""
    r, m, k = x_shape
    return 2 * r * m * k * w_shape[2]


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


def _allgather_matmul(x: torch.Tensor, w: torch.Tensor, mm) -> torch.Tensor:
    """The reference's ring schedule with product ``mm``, every step in order
    on the current stream: at step s each rank multiplies the shard it
    holds into its diagonal of the output, then the ring passes it on."""
    *lead, p, m, k = x.shape
    n = w.shape[1]
    buf = C._ring_buffer(x.reshape(*lead, p, m * k))          # (..., P, P, m K)
    out = torch.empty((*lead, p, p * m, n), dtype=x.dtype, device=x.device)
    pairs = list(zip(buf.view(-1, p, p, m, k), out.view(-1, p, p, m, n)))
    for s in range(p):
        for xs, ys in pairs:                                   # one group at a time
            for a, y in zip(_diagonals(xs, s), _diagonals(ys, s)):
                mm(a, w.expand(a.shape[0], k, n), out=y)
        if s < p - 1:
            ring_step(buf, s)
    return out


def _one_launch(x: torch.Tensor, w: torch.Tensor, mm) -> torch.Tensor:
    """``allgather(x) @ w`` as one product ``mm`` per group of the leading
    dims: rank d's A is the group's P m rows where they lie in ``x`` (a
    rank stride of 0), its B the replicated ``w``, so
    ``out[g] = mm(x[g].reshape(1, P m, K).expand(P, P m, K), w.expand(P, K, N))``."""
    *lead, p, m, k = x.shape
    n = w.shape[1]
    out = torch.empty((*lead, p, p * m, n), dtype=x.dtype, device=x.device)
    rows, outs, wr = x.reshape(-1, p * m, k), out.view(-1, p, p * m, n), w.expand(p, k, n)
    for g in range(rows.shape[0]):
        mm(rows[g].expand(p, p * m, k), wr, out=outs[g])
    return out


def allgather_matmul_local(x: torch.Tensor, w: torch.Tensor, *, use_pallas: bool = True,
                           bm: int = 128, bk: int = 128, bn: int = 128) -> torch.Tensor:
    """``allgather(x) @ w`` on the stacked backend: x (..., P, m, K), rank
    d's row shard at [..., d, :, :] (leading dims are independent groups),
    w (K, N) replicated -> (..., P, P m, N), every rank's copy of the
    product of all P m rows. ``use_pallas`` picks the matmul kernel (True)
    or the reference's ``jnp.dot`` branch, the same f32-summed product in
    plain torch on the ring schedule (False); the tiles only pass the
    reference's precondition. On a CUDA tensor with ``use_pallas`` each
    group is one ``matmul`` launch that reads every rank's shard in place;
    on a CPU tensor the ring schedule runs with the plain products. Either
    way the result equals the plain gather followed by one ``matmul`` of the
    gathered rows, bitwise (the kernels have no split-K, so a row's sums do
    not depend on the rows beside it; torch's CPU product of a single row,
    m = 1, sums in another order).

    Differentiable in x and w (``_AllgatherMatmul``): for the cotangent g_d
    of rank d's copy, dx is the gather's transpose of the per-rank products
    g_d w^T (one ``ring_allgather_transpose`` launch of the ring schedule,
    the gathers' backward), and dw the sum over ranks of X^T g_d, X the
    gathered rows; the products run on ``matmul`` (``matmul_plain`` with
    ``use_pallas=False``)."""
    if x.dim() < 3 or w.dim() != 2 or x.shape[-1] != w.shape[0]:
        raise ValueError(f"allgather_matmul takes x (..., P, m, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"allgather_matmul runs on cuda or cpu tensors, got {x.device}")
    m, k = x.shape[-2:]
    if use_pallas:
        _check_tiles(m, k, w.shape[1], bm, bk, bn)
    return _AllgatherMatmul.apply(x, w, use_pallas)


class _AllgatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, w: torch.Tensor, use_pallas: bool) -> torch.Tensor:
        global allgather_launches
        ctx.mm = matmul if use_pallas else matmul_plain
        ctx.save_for_backward(x, w)
        *lead, p, m, k = x.shape
        ctx.rows = stats.rows()
        stats.record_stacked("all-gather", (*lead, p, p * m * k), x.element_size(), ctx.rows)
        if not use_pallas:
            return _allgather_matmul(x, w, matmul_plain)
        if x.device.type == "cpu":
            return _allgather_matmul(x, w, matmul)
        allgather_launches += 1
        return _one_launch(x, w, matmul)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        x, w = ctx.saved_tensors
        *lead, p, m, k = x.shape
        n = w.shape[1]
        g = g.to(x.dtype).reshape(-1, p * m, n)                 # (groups P, P m, N)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # every rank's full contribution g_d w^T, then the gather's transpose
            contrib = ctx.mm(g, w.t().expand(g.shape[0], n, k))
            dx = C._reduced(C._transposed(contrib.view(*lead, p, p * m * k),
                                          C._ring_schedule(p)), ctx.rows).view(x.shape)
        if ctx.needs_input_grad[1]:
            rows = x.reshape(-1, 1, p * m, k)
            per_rank = [ctx.mm(rows[i].transpose(1, 2).expand(p, k, p * m), gi)
                        for i, gi in enumerate(g.view(-1, p, p * m, n))]
            dw = torch.stack(per_rank).sum((0, 1))
        return dx, dw, None


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
