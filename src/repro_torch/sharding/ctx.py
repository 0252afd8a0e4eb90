"""Sharding context of the port (counterpart of ``repro.sharding.ctx``).

Model code consults ``get_ctx()`` for the mesh and for the per-layer
parameter gather. On the stacked backend only the dp axes are physical, so
``shard`` (a sharding constraint in the reference) is a no-op and ``spec``
only names the layout.

``dims`` vocabulary (resolved against the active context):
    "dp"    -> the data-parallel axes ("data",) or ("pod", "data")
    "tp"    -> the tensor-parallel axis "model"
    "sp"    -> the sequence dim over "model" when seq_parallel
    None    -> replicated
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch

from repro_torch.launch.mesh import StackedMesh
from repro_torch.sharding.specs import Stacked, is_sharded, tree_map


@dataclass(frozen=True)
class ShardCtx:
    mesh: StackedMesh | None = None
    dp_axes: tuple[str, ...] = ("data",)
    tp_axis: str | None = "model"
    # batch sharding disabled when global batch < |dp| (e.g. long_500k B=1)
    shard_batch: bool = True
    # sequence-parallel residual stream (layout only on the stacked backend)
    seq_parallel: bool = True
    # per-layer parameter gather (sharding/fsdp.make_param_gather): the
    # paper's allgathers in the mcast modes, the plain gather otherwise
    gather_params: object = None
    # explicit compute/gather overlap: gather layer i+1's params during layer
    # i (models/transformer._scan_blocks_prefetch); set only where the
    # reference installs a gather of its own (the mcast modes)
    prefetch_params: bool = False


_CTX: list[ShardCtx] = [ShardCtx(mesh=None)]


def get_ctx() -> ShardCtx:
    return _CTX[-1]


@contextlib.contextmanager
def use_ctx(ctx: ShardCtx):
    _CTX.append(ctx)
    try:
        yield ctx
    finally:
        _CTX.pop()


def _resolve(dim) -> object:
    c = get_ctx()
    if dim is None:
        return None
    if dim == "dp":
        return c.dp_axes if c.shard_batch else None
    if dim == "tp":
        return c.tp_axis
    if dim == "sp":
        return c.tp_axis if c.seq_parallel else None
    raise ValueError(dim)


def _unsharded(leaf: Stacked) -> torch.Tensor:
    if is_sharded(leaf.spec, get_ctx().dp_axes):
        raise ValueError(f"leaf with spec {leaf.spec} is sharded but no gather is active")
    return leaf.local


def maybe_gather_params(tree):
    """Hook called per layer: each ``Stacked`` leaf becomes every rank's
    gathered copy, (R, *global shape). The active gather is the paper's
    (mcast modes) or the plain one (xla, decode); with no gather installed
    nothing may be sharded and the leaves pass through."""
    c = get_ctx()
    if c.gather_params is None:
        return tree_map(_unsharded, tree)
    return c.gather_params(tree)


def shard(x: torch.Tensor, *dims) -> torch.Tensor:
    """No-op: on the stacked backend the layout is fixed by the rank dim."""
    return x


def spec(*dims) -> tuple:
    return tuple(_resolve(d) for d in dims)


def mesh_axis_size(axis: str) -> int:
    c = get_ctx()
    if c.mesh is None:
        return 1
    if axis == "dp":
        return math.prod(c.mesh.shape[a] for a in c.dp_axes)
    return c.mesh.shape[c.tp_axis] if c.tp_axis else 1
