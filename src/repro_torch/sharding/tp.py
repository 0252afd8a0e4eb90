"""Tensor and sequence parallelism over the physical ``model`` axis.

The reference places its tensors with GSPMD: ``shard(x, "dp", "sp", None)``
constraints, weights split over ``model`` by the rules, and XLA inserts the
collectives. The stacked backend places them explicitly: the model code
calls these collectives where GSPMD would put its own, each over the
``model`` ranks of every dp rank (the tp groups of the stacked rank dim,
rank ``d * tp + m``), on the ring kernels:

    gather          one ring allgather of a dim (``csrc/ring_allgather.cu``,
                    #1); its backward the ring reduce-scatter (#1b)
    reduce_scatter  one ring reduce-scatter of a dim
                    (``csrc/ring_allgather_transpose.cu``, #1b); its backward
                    the gather (#1)
    all_reduce      the two in turn, on the last dim

Every one runs the same unidirectional ring whatever ``fsdp_mode`` is, so
that the modes differ only in the dp gather. ``chunk`` and ``groups`` are
plain indexing: each rank's own chunk of a dim that every tp rank holds
whole, and the (dp, tp) view of the rank dim. At tp = 1 every function
returns its input.

A stacked tensor here is (R, ...) with R = mesh.n_ranks, or (tp, ...): the
serving layout's weights, one copy a tp rank (``fsdp.replicate_over_dp``),
which rank r reads at r % tp.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import collectives as C
from repro_torch.launch.mesh import TP_AXIS
from repro_torch.sharding.ctx import get_ctx


def size() -> int:
    """The size of the physical ``model`` axis of the active context (1
    without a mesh)."""
    c = get_ctx()
    return c.mesh.tp if c.mesh is not None and c.tp_axis else 1


def seq_split(s: int) -> bool:
    """Whether a sequence of length s runs sequence-parallel: the context
    shards the residual stream over ``model`` and s divides."""
    t = size()
    return get_ctx().seq_parallel and t > 1 and s % t == 0


def _over(x: torch.Tensor, dim: int, local) -> torch.Tensor:
    shape = x.shape
    flat = x.reshape(shape[0], math.prod(shape[1:dim]), math.prod(shape[dim:]))
    return C.over_axis(flat, get_ctx().mesh, TP_AXIS, local)


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Dim ``dim`` (>= 1) of a stacked x gathered over ``model``: every tp
    rank's chunks joined in rank order, one ring allgather launch."""
    t = size()
    if t == 1:
        return x
    dim %= x.dim()
    y = _over(x, dim, C.ring_allgather_local)
    return y.reshape(*x.shape[:dim], t * x.shape[dim], *x.shape[dim + 1:])


def reduce_scatter(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Each tp rank's partial sums x summed over ``model``, rank m keeping
    chunk m of dim ``dim`` (>= 1): one ring reduce-scatter launch."""
    t = size()
    if t == 1:
        return x
    dim %= x.dim()
    if x.shape[dim] % t:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {t} tp ranks")
    y = _over(x, dim, C.ring_reduce_scatter_local)
    return y.reshape(*x.shape[:dim], x.shape[dim] // t, *x.shape[dim + 1:])


def all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Each tp rank's partial sums x summed over ``model``, every tp rank
    the sum: the reduce-scatter of the last dim (zero-padded to a multiple
    of tp), then its gather."""
    t = size()
    if t == 1:
        return x
    n = x.shape[-1]
    pad = -n % t
    y = F.pad(x, (0, pad)) if pad else x
    y = gather(reduce_scatter(y, y.dim() - 1), y.dim() - 1)
    return y[..., :n] if pad else y


def rank_index(n: int, device) -> torch.Tensor:
    """(n,) the tp index of each of the n stacked ranks (r % tp)."""
    return torch.arange(n, device=device) % size()


def chunk(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Rank r's chunk r % tp of dim ``dim`` of a stacked x that every tp rank
    holds whole: the slice the reference's sharding constraint takes of a
    replicated value (no communication)."""
    t = size()
    if t == 1:
        return x
    dim %= x.dim()
    v = x.unflatten(dim, (t, x.shape[dim] // t))
    idx = rank_index(x.shape[0], x.device).view(-1, *([1] * (v.dim() - 1)))
    idx = idx.expand(*v.shape[:dim], 1, *v.shape[dim + 1:])
    return torch.take_along_dim(v, idx, dim=dim).squeeze(dim)


def groups(x: torch.Tensor) -> torch.Tensor:
    """(R, ...) -> (R / tp, tp, ...): the dp ranks by their tp ranks."""
    return x.view(x.shape[0] // size(), size(), *x.shape[1:])
