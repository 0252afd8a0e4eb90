"""The paper's allgathers on the stacked backend, and their transposes.

Counterpart of the allgathers and reduce-scatters of
``repro.core.collectives``. There each device holds its shard and
``lax.ppermute`` moves it along the ring. Here the P ranks of one mesh axis
are one dim of a tensor on one device: a stacked input ``(..., P, n)`` holds
rank d's shard at ``[..., d, :]`` (leading dims are independent groups, e.g.
the other dp axis of a hierarchical mesh), and the output ``(..., P, P * n)``
is every rank's own gathered copy, in rank order. Each ring step is one
launch of the ring-step kernel on the buffer ``(..., P_rank, P_slot, n)``, so
the schedule is the reference's step for step.

  ring_allgather_local   unidirectional ring, P - 1 steps
  bidi_ring_allgather    half of each shard travels each direction; one
                         launch per step moves both halves
  bcast_allgather        Appendix A: P / M sequential rounds of M parallel
                         broadcast chains, P - 1 masked steps per round
  plain_allgather        the plain tensor gather: the counterpart of the
                         gather GSPMD inserts in the reference (``xla``)

The three ring gathers are ``torch.autograd.Function``s. The forward fills
the ring buffer in place, out of autograd's sight; the backward replays the
same steps in reverse order (rounds too) through the transposed ring step,
which adds each receiver's cotangent into its sender's, and reads the
diagonal: rank d's gradient is the sum of every rank's cotangent of shard d,
summed along the chain from its far end as JAX's transpose of the ring sums
it. The ring reduce-scatters are the same transposed steps applied to each
rank's own full contribution.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.kernels.ring_allgather import ring_step, ring_step_transpose
from repro_torch.launch.mesh import StackedMesh

Schedule = tuple  # ((step, kwargs of ring_step), ...) in launch order


def _ring_buffer(x: torch.Tensor) -> torch.Tensor:
    """(..., P, n) -> zeros (..., P, P, n) with rank d's shard in its slot d."""
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
    # a copy: the transposed steps write in place
    buf = g.reshape(*g.shape[:-1], p, g.shape[-1] // p).clone(
        memory_format=torch.contiguous_format)
    for step, kw in reversed(schedule):
        ring_step_transpose(buf, step, **kw)
    return buf.diagonal(dim1=-3, dim2=-2).transpose(-1, -2).contiguous()


class _RingGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, schedule: Schedule) -> torch.Tensor:
        ctx.schedule = schedule
        buf = _ring_buffer(x)
        for step, kw in schedule:
            ring_step(buf, step, **kw)
        return _flat(buf)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        return _transposed(g, ctx.schedule), None


def _ring_schedule(p: int, direction: int = +1) -> Schedule:
    return tuple((s, dict(direction=direction)) for s in range(p - 1))


def _bidi_schedule(p: int, n: int, direction: int = +1) -> Schedule:
    return tuple((s, dict(direction=direction, split=n // 2)) for s in range(p - 1))


def _bcast_schedule(p: int, n_chains: int) -> Schedule:
    if p % n_chains:
        raise ValueError(f"{p} ranks do not split into {n_chains} chains")
    rounds = p // n_chains
    return tuple((s, dict(rounds=rounds, active_round=r))
                 for r in range(rounds) for s in range(p - 1))


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
