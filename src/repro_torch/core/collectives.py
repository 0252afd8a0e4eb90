"""The paper's allgathers on the stacked backend, and their transposes.

Counterpart of the allgathers and reduce-scatters of
``repro.core.collectives``. There each device holds its shard and
``lax.ppermute`` moves it along the ring. Here the P ranks of one mesh axis
are one dim of a tensor on one device: a stacked input ``(..., P, n)`` holds
rank d's shard at ``[..., d, :]`` (leading dims are independent groups, e.g.
the other dp axis of a hierarchical mesh), and the output ``(..., P, P * n)``
is every rank's own gathered copy, in rank order. A gather's schedule is the
reference's step for step, on the buffer ``(..., P_rank, P_slot, n)``; on the
card one launch of the ring-allgather kernel runs all of its steps.

  ring_allgather_local   unidirectional ring, P - 1 steps
  bidi_ring_allgather    half of each shard travels each direction, both
                         halves in the same launch
  bcast_allgather        Appendix A: P / M sequential rounds of M parallel
                         broadcast chains, P - 1 masked steps per round
  plain_allgather        the plain tensor gather: the counterpart of the
                         gather GSPMD inserts in the reference (``xla``)
  pipelined_broadcast    constant-time Broadcast (§III): root's buffer in
                         C chunks down the chain, C + P - 2 steps
  concurrent_ag_rs       Insight 2: a ring allgather along +1 and a ring
                         reduce-scatter along -1 at once: the gather one
                         launch on a side CUDA stream, the reduce-scatter
                         one launch of the transpose on the current one

The three ring gathers are ``torch.autograd.Function``s. The forward fills
the ring buffer out of autograd's sight (``ring_allgather``: one launch per
gather installs each rank's shard and runs the schedule); the backward is one
launch too (``ring_allgather_transpose``): the same steps in reverse order
(rounds too), each adding a receiver's cotangent into its sender's, then the
diagonal: rank d's gradient is the sum of every rank's cotangent of shard d,
summed along the chain from its far end as JAX's transpose of the ring sums
it. The launch reads the cotangent once and writes the (..., P, n) result
once, (P * P + P) * n * itemsize bytes, with no copy of the cotangent and
no copy of the diagonal. The ring reduce-scatters are the same transpose
applied to each rank's own full contribution.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.device import SideStream
from repro_torch.kernels.ring_allgather import ring_allgather, ring_allgather_transpose
from repro_torch.launch.mesh import StackedMesh

# ((step, direction, split, rounds, active_round), ...) in launch order; split
# None moves the whole slot along direction
Schedule = tuple


def _ring_buffer(x: torch.Tensor) -> torch.Tensor:
    """(..., P, n) -> zeros (..., P, P, n) with rank d's shard in its slot d:
    the buffer that the allgather-matmul's ring steps start from."""
    p, n = x.shape[-2:]
    buf = x.new_zeros(*x.shape[:-2], p, p, n)
    buf.diagonal(dim1=-3, dim2=-2).copy_(x.transpose(-1, -2))
    return buf


def _flat(buf: torch.Tensor) -> torch.Tensor:
    p, n = buf.shape[-2:]
    return buf.reshape(*buf.shape[:-3], p, p * n)


def _transposed(g: torch.Tensor, schedule: Schedule) -> torch.Tensor:
    """(..., P, P * n) per-rank cotangents (or contributions) -> (..., P, n):
    the schedule's steps transposed, in reverse order, then the diagonal."""
    p = g.shape[-2]
    return ring_allgather_transpose(g.reshape(*g.shape[:-1], p, g.shape[-1] // p), schedule)


class _RingGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, schedule: Schedule) -> torch.Tensor:
        ctx.schedule = schedule
        return _flat(ring_allgather(x.contiguous(), schedule))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        return _transposed(g, ctx.schedule), None


def _ring_schedule(p: int, direction: int = +1) -> Schedule:
    return tuple((s, direction, None, 1, 0) for s in range(p - 1))


def _bidi_schedule(p: int, n: int, direction: int = +1) -> Schedule:
    return tuple((s, direction, n // 2, 1, 0) for s in range(p - 1))


def _bcast_schedule(p: int, n_chains: int) -> Schedule:
    if p % n_chains:
        raise ValueError(f"{p} ranks do not split into {n_chains} chains")
    rounds = p // n_chains
    return tuple((s, 1, None, rounds, r) for r in range(rounds) for s in range(p - 1))


def ring_allgather_local(x: torch.Tensor, *, direction: int = +1) -> torch.Tensor:
    """Unidirectional ring allgather: P - 1 forwarding steps."""
    return _RingGather.apply(x, _ring_schedule(x.shape[-2], direction))


def bidi_ring_allgather_local(x: torch.Tensor) -> torch.Tensor:
    """Bidirectional ring allgather (Fig. 1's two trees): the first half of
    each shard travels +1, the rest -1, both in the same launch."""
    return _RingGather.apply(x, _bidi_schedule(*x.shape[-2:]))


def bcast_allgather_local(x: torch.Tensor, *, n_chains: int) -> torch.Tensor:
    """Allgather as a composition of broadcasts with M = n_chains parallel
    chains (Appendix A). In round r the roots {r, R + r, 2R + r, ...} each
    broadcast their shard around the ring; M = P is the plain ring."""
    return _RingGather.apply(x, _bcast_schedule(x.shape[-2], n_chains))


def ring_reduce_scatter_local(x: torch.Tensor, *, direction: int = +1) -> torch.Tensor:
    """Ring reduce-scatter. x (..., P, P * n): each rank's full contribution;
    returns (..., P, n), rank d holding the sum over ranks of shard d. The
    partial sums travel along ``direction``, so this is the transpose of the
    ring allgather along ``-direction``; the sum of shard d starts at rank
    d + direction and ends at d, as in the reference."""
    return _transposed(x, _ring_schedule(x.shape[-2], -direction))


def bidi_ring_reduce_scatter_local(x: torch.Tensor) -> torch.Tensor:
    """Both directions carry half of each shard: the first half reduces
    along +1, the rest along -1, both in the same launch."""
    p = x.shape[-2]
    return _transposed(x, _bidi_schedule(p, x.shape[-1] // p, direction=-1))


def plain_allgather_local(x: torch.Tensor) -> torch.Tensor:
    """Every rank's copy of the concatenated shards, as one tensor op."""
    p, n = x.shape[-2:]
    full = x.reshape(*x.shape[:-2], 1, p * n)
    return full.expand(*x.shape[:-2], p, p * n).contiguous()


def pipelined_broadcast_local(x: torch.Tensor, *, root: int = 0,
                              n_chunks: int = 8) -> torch.Tensor:
    """Chain-pipelined broadcast of rank ``root``'s row of x (..., P, n) (the
    other ranks' rows are ignored) -> (..., P, n), every rank holding it.
    The reference's schedule step for step (core/collectives.py:46): the
    buffer is C = n_chunks chunks; at step t of C + P - 2 the root sends
    chunk min(t, C - 1), every other rank forwards what it received at step
    t - 1, all along +1, and the rank at distance dist from the root keeps
    what it receives as chunk t - (dist - 1) where that is a chunk. The
    chunk indices depend on nothing but t and dist, so they are worked out
    on the host; the moves are plain tensor ops (no TPU kernel computes
    this)."""
    p, n = x.shape[-2:]
    if n % n_chunks:
        raise ValueError(f"{n} elements do not split into {n_chunks} chunks")
    root %= p
    xc = x.reshape(*x.shape[:-1], n_chunks, n // n_chunks)
    dist = [(d - root) % p for d in range(p)]
    out = torch.zeros_like(xc)
    out[..., root, :, :] = xc[..., root, :, :]
    cur = x.new_zeros(*x.shape[:-1], n // n_chunks)
    for t in range(n_chunks + p - 2):
        cur[..., root, :] = xc[..., root, min(t, n_chunks - 1), :]
        cur = cur.roll(1, dims=-2)                 # rank d receives from d - 1
        ranks = [d for d in range(p) if dist[d] > 0 and 0 <= t - (dist[d] - 1) < n_chunks]
        if ranks:
            chunk = [t - (dist[d] - 1) for d in ranks]
            out[..., ranks, chunk, :] = cur[..., ranks, :]
    return out.reshape(x.shape)


def concurrent_ag_rs_local(ag: torch.Tensor, rs: torch.Tensor) -> tuple[torch.Tensor,
                                                                         torch.Tensor]:
    """Insight 2: a ring allgather along +1 and a ring reduce-scatter along
    -1, progressed together. ag (..., P, n) rank shards, rs (..., P, P m)
    per-rank full contributions -> (ag gathered (..., P, P n), rs reduced
    (..., P, m)), each equal, bitwise, to ``ring_allgather_local(ag)`` and
    ``ring_reduce_scatter_local(rs, direction=-1)`` (the reference's
    ``concurrent_ag_rs_local``, core/collectives.py:190: the partial sums
    start at rank d + 1 and travel -1). On the card the allgather is one
    ``ring_allgather`` launch of the whole ring schedule on the side stream,
    and the reduce-scatter one ``ring_allgather_transpose`` launch of the
    same schedule on the current stream: the port's form of "the two
    streams use opposite directions"."""
    if ag.requires_grad or rs.requires_grad:
        raise NotImplementedError("concurrent_ag_rs_local has no backward in the port; "
                                  "use ring_allgather_local and ring_reduce_scatter_local")
    return _concurrent_ag_rs(ag, rs, overlap=ag.device.type == "cuda")


def _concurrent_ag_rs(ag: torch.Tensor, rs: torch.Tensor,
                      overlap: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """The work of ``concurrent_ag_rs_local``: with ``overlap`` the
    allgather on the side stream; without, the allgather and then the
    reduce-scatter on the current stream."""
    p = ag.shape[-2]
    if rs.shape[-2] != p or rs.shape[-1] % p:
        raise ValueError(f"rs {tuple(rs.shape)} is not (..., {p}, {p} m)")
    if ag.device != rs.device:
        raise ValueError(f"ag on {ag.device}, rs on {rs.device}")
    ag, schedule = ag.contiguous(), _ring_schedule(p)
    if not overlap:
        return _flat(ring_allgather(ag, schedule)), ring_reduce_scatter_local(rs, direction=-1)
    side = SideStream(ag.device)
    gathered, done = side.issue(ring_allgather, ag, schedule)
    reduced = ring_reduce_scatter_local(rs, direction=-1)
    side.join(done)
    return _flat(gathered), reduced


def over_axis(x: torch.Tensor, mesh: StackedMesh, axis: str,
              gather: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """Run ``gather`` over mesh axis ``axis`` of a stacked (R, n) tensor,
    R = mesh.n_ranks; the other dp axes are its groups. Returns (R, P * n)."""
    sizes = [mesh.shape[a] for a in mesh.rank_axes]
    i = mesh.rank_axes.index(axis)
    y = x.reshape(*sizes, x.shape[-1]).movedim(i, -2)
    return gather(y).movedim(-2, i).reshape(x.shape[0], -1)


def local_allgather(mode: str, n_chains: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """The (..., P, n) -> (..., P, P * n) gather of ``mode``."""
    if mode == "xla":
        return plain_allgather_local
    if mode == "ring":
        return ring_allgather_local
    if mode == "bidi":
        return bidi_ring_allgather_local
    if mode == "bcast":
        return lambda x: bcast_allgather_local(x, n_chains=n_chains)
    raise ValueError(f"unknown allgather mode {mode!r}")


def make_allgather(mesh: StackedMesh, axis: str, mode: str = "bidi", *,
                   n_chains: int | None = None):
    """Stacked allgather over ``axis``: (R, n) rank shards -> (R, P * n),
    every rank's gathered copy. mode: ring | bidi | bcast | xla."""
    gather = local_allgather(mode, n_chains or mesh.shape[axis])
    return lambda x: over_axis(x, mesh, axis, gather)


def make_reduce_scatter(mesh: StackedMesh, axis: str, mode: str = "bidi"):
    """Stacked reduce-scatter over ``axis``: (R, P * n) per-rank full
    contributions -> (R, n), rank r holding its shard of the sum over the
    axis. mode: ring | bidi."""
    local = {"ring": ring_reduce_scatter_local,
             "bidi": bidi_ring_reduce_scatter_local}[mode]
    return lambda x: over_axis(x, mesh, axis, local)


def make_broadcast(mesh: StackedMesh, axis: str, *, root: int = 0, n_chunks: int = 8):
    """Stacked broadcast over ``axis``: (R, n) rank rows -> (R, n), every
    rank of each group holding the row of the group's rank ``root``."""
    local = functools.partial(pipelined_broadcast_local, root=root, n_chunks=n_chunks)
    return lambda x: over_axis(x, mesh, axis, local)
