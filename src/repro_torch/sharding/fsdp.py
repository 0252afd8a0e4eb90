"""FSDP (ZeRO-3) parameter gathering with the paper's collectives, on the
stacked backend (counterpart of ``repro.sharding.fsdp``).

  "xla"   — the plain gather: the counterpart of the all-gather GSPMD inserts
            in the reference. The port has no GSPMD, so ``make_param_gather``
            returns this gather for ``xla`` where the reference returns None.
  "mcast" / "mcast_ring" / "mcast_bcast"
          — the paper's schedule, explicit: per layer, each dp-sharded weight
            is gathered by the bidirectional ring, the ring, or the M-chain
            broadcast composition, each gather's steps in one launch of
            the ring-allgather kernel.

On a multi-pod mesh the gather is hierarchical: the intra-pod "data" ring
first, then the "pod" axis through the M-chain broadcast composition. A
leaf's ``model`` shard stays where it is, as in the reference: the model
code uses it tensor-parallel, or gathers it over ``model`` where its split
does not fall on whole heads (``sharding/tp.py``).

Layouts of a leaf split over some physical axes (``specs.shard_axes``):
the ranked layout ``(R, *local)`` that the model takes (rank r's shard at
r, a shard held once per rank of the axes that do not split it), and the
trainable layout that the optimizer and the checkpoints keep: each distinct
shard once, ``(N, *local)`` in row-major order over the splitting axes, or
the one global tensor where no axis splits it. ``at_use`` makes the first
from the second inside autograd's sight, so a shard's gradient is the sum
over the ranks that hold it.
"""
from __future__ import annotations

import math
from typing import Callable

import torch

from repro_torch.configs.base import CollectiveConfig, MeshConfig
from repro_torch.core import collectives as C
from repro_torch.launch.mesh import TP_AXIS, StackedMesh
from repro_torch.sharding.specs import (Spec, Stacked, dp_axes, entry_axes, shard_axes,
                                       strip_dp, tree_map, tree_map_with_path)


def _remove_axis(entry, axis):
    if entry is None:
        return None
    if isinstance(entry, str):
        return None if entry == axis else entry
    rest = tuple(a for a in entry if a != axis)
    return rest if len(rest) > 1 else (rest[0] if rest else None)


def _ag_local(flat: torch.Tensor, mode: str, n_chains: int) -> torch.Tensor:
    if mode == "bidi" and flat.shape[-1] % 2:
        mode = "ring"  # the two half-shards need an even flat length
    return C.local_allgather(mode, n_chains)(flat)


def gather_dim(x: torch.Tensor, spec: Spec, axis: str, dim: int, mesh: StackedMesh,
               mode: str, n_chains: int) -> tuple[torch.Tensor, Spec]:
    """Allgather mesh axis ``axis`` out of dim ``dim`` of a stacked leaf
    x (R, *local). Returns (R, *local with dim grown P-fold) and its spec."""
    out_entries = list(spec) + [None] * (x.dim() - 1 - len(spec))
    out_entries[dim] = _remove_axis(out_entries[dim], axis)
    p = mesh.shape[axis]
    moved = torch.movedim(x, dim + 1, 1)
    flat = moved.reshape(moved.shape[0], -1)
    full = C.over_axis(flat, mesh, axis, lambda f: _ag_local(f, mode, min(n_chains, p)))
    out = full.reshape(moved.shape[0], p * moved.shape[1], *moved.shape[2:])
    return torch.movedim(out, 1, dim + 1), tuple(out_entries)


def gather_leaf(x: torch.Tensor, spec: Spec, mesh: StackedMesh, dp: tuple[str, ...],
                mode: str, n_chains: int) -> torch.Tensor:
    """Gather every dp axis out of a stacked weight x (R, *local); its
    ``model`` shard stays in place (each tp group's dp ring runs over ranks
    strided by tp, addressed where they lie). Hierarchical: the minor
    (intra-pod "data") axis first, then the "pod" axis via the M-chain
    broadcast composition."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in [ax for ax in reversed(dp) if ax in axes]:
            # the switched pod axis always uses the paper's M-chain
            # broadcast-composed schedule; intra-pod uses `mode`
            pod_mode = "bcast" if a == "pod" and mode != "xla" else mode
            x, spec = gather_dim(x, spec, a, dim, mesh, pod_mode, n_chains)
    return x


def _local_shape(shape, spec: Spec, mesh: StackedMesh) -> list[int]:
    """A global shape divided by the physical axes that split each dim."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in entry_axes(entry):
            if a in mesh.rank_axes:
                out[d] //= mesh.shape[a]
    return out


def unique_shards(leaf: Stacked) -> torch.Tensor:
    """The trainable layout of a leaf of the ranked layout: (N, *local), each
    distinct shard once (rank 0's copy over the axes that do not split
    it), or the global tensor where nothing splits it (a leaf without a
    mesh is split by nothing)."""
    axes = shard_axes(leaf.spec, leaf.mesh)
    if not axes:
        return leaf.local[0]
    mesh = leaf.mesh
    if len(axes) == len(mesh.rank_axes):
        return leaf.local
    t = leaf.local.reshape(*[mesh.shape[a] for a in mesh.rank_axes], *leaf.local.shape[1:])
    t = t[tuple(slice(None) if a in axes else 0 for a in mesh.rank_axes)]
    return t.reshape(-1, *leaf.local.shape[1:])


def expand_ranks(t: torch.Tensor, spec: Spec, mesh: StackedMesh | None,
                 n_ranks: int) -> torch.Tensor:
    """The inverse of ``unique_shards``: (N, *local) or the global tensor ->
    (R, *local), every rank its shard. A view where every physical axis
    splits the leaf or none does; a copy where only some do (each shard
    once per rank of the others)."""
    axes = shard_axes(spec, mesh)
    if not axes:
        return t.expand(n_ranks, *t.shape)
    if len(axes) == len(mesh.rank_axes):
        return t
    full = [mesh.shape[a] for a in mesh.rank_axes]
    kept = [mesh.shape[a] if a in axes else 1 for a in mesh.rank_axes]
    local = t.shape[1:]
    return t.reshape(*kept, *local).expand(*full, *local).reshape(n_ranks, *local)


def trainable(params, dp: tuple[str, ...]):
    """A tree of ``Stacked`` leaves -> the same tree in the trainable layout
    over fresh leaf tensors that require grad: each distinct shard once
    (``unique_shards``); a replicated leaf its one (*global) tensor, so its
    gradient is the sum over ranks (the all-reduce GSPMD inserts in the
    reference: over the sequence shards of ``model`` too, where each tp
    rank saw only its part) and an optimizer step updates it once.
    ``at_use`` makes the ranked layout again."""
    def one(leaf: Stacked) -> Stacked:
        t = unique_shards(leaf)
        return leaf._replace(local=t.detach().clone().requires_grad_())

    return tree_map(one, params)


def at_use(params, n_ranks: int, dp: tuple[str, ...]):
    """A trainable tree (``trainable``) -> the tree of ``Stacked`` leaves the
    model takes, (R, *local) each (``expand_ranks``), inside autograd's
    sight."""
    def one(leaf: Stacked) -> Stacked:
        return leaf._replace(local=expand_ranks(leaf.local, leaf.spec, leaf.mesh, n_ranks))

    return tree_map(one, params)


def _rank_dim(spec: Spec) -> int | None:
    """The dim that ``spec`` splits over the dp ranks (the rules split one
    dim over every dp axis, or none), or None."""
    for dim, entry in enumerate(spec):
        if any(a != TP_AXIS for a in entry_axes(entry)):
            return dim
    return None


def global_shape(leaf: Stacked) -> tuple[int, ...]:
    """The global shape of a leaf of the trainable layout (``trainable``)."""
    if not shard_axes(leaf.spec, leaf.mesh):
        return tuple(leaf.local.shape)
    shape = list(leaf.local.shape[1:])
    for d, entry in enumerate(leaf.spec):
        for a in entry_axes(entry):
            if a in leaf.mesh.rank_axes:
                shape[d] *= leaf.mesh.shape[a]
    return tuple(shape)


def _split_dims(spec: Spec, mesh: StackedMesh, shape) -> tuple[list[int], list[int]]:
    """The global shape with each split dim cut into (its axes' sizes,
    major first, then the local extent), and the order of the cut dims that
    puts the axes first, in mesh order, then the local extents."""
    cut, labels = [], []
    for d, size in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        axes = [a for a in entry_axes(entry) if a in mesh.rank_axes]
        k = math.prod(mesh.shape[a] for a in axes)
        for a in axes:
            cut.append(mesh.shape[a])
            labels.append(a)
        cut.append(size // k)
        labels.append(None)
    order = ([labels.index(a) for a in shard_axes(spec, mesh)]
             + [i for i, lab in enumerate(labels) if lab is None])
    return cut, order


def global_tensor(leaf: Stacked) -> torch.Tensor:
    """The global tensor of a leaf of the trainable layout: a split leaf's
    shards (N, *local) joined along their split dims in rank order (a new
    tensor); a replicated leaf its one tensor."""
    t = leaf.local.detach()
    if not shard_axes(leaf.spec, leaf.mesh):
        return t
    shape = global_shape(leaf)
    cut, order = _split_dims(leaf.spec, leaf.mesh, shape)
    inverse = [order.index(i) for i in range(len(order))]
    return t.reshape([cut[i] for i in order]).permute(inverse).reshape(shape)


def split_global(t: torch.Tensor, spec: Spec, mesh: StackedMesh | int) -> torch.Tensor:
    """The inverse of ``global_tensor``: a global tensor -> its leaf of the
    trainable layout for ``spec`` on ``mesh``, the distinct shards in
    row-major order over the splitting axes (a new tensor where split).
    ``mesh`` may be a rank count for a spec that splits one dim over the dp
    ranks alone (rank r's chunk at index r)."""
    if isinstance(mesh, int):
        d = _rank_dim(spec)
        if d is None:
            return t
        chunked = t.reshape(*t.shape[:d], mesh, t.shape[d] // mesh, *t.shape[d + 1:])
        return chunked.movedim(d, 0).clone(memory_format=torch.contiguous_format)
    axes = shard_axes(spec, mesh)
    if not axes:
        return t
    cut, order = _split_dims(spec, mesh, t.shape)
    local = _local_shape(t.shape, spec, mesh)
    out = t.reshape(cut).permute(order).reshape(-1, *local)
    return out.clone(memory_format=torch.contiguous_format)


def make_param_gather(mesh: StackedMesh, mesh_cfg: MeshConfig,
                      coll: CollectiveConfig) -> Callable:
    """The ShardCtx.gather_params hook: maps the gather of ``coll.fsdp_mode``
    over a one-layer tree of ``Stacked`` leaves, giving (R, *global) tensors."""
    dp = dp_axes(mesh_cfg)
    mode = {"xla": "xla", "mcast": "bidi", "mcast_ring": "ring",
            "mcast_bcast": "bcast"}.get(coll.fsdp_mode, "bidi")

    def one(leaf: Stacked) -> torch.Tensor:
        return gather_leaf(leaf.local, leaf.spec, mesh, dp, mode, coll.n_chains)

    return lambda tree: tree_map(one, tree)


def replicate_over_dp(params, mesh: StackedMesh, dp: tuple[str, ...], keep_tp) -> dict:
    """The serving layout of ``CollectiveConfig.serve_params_replicated``:
    every leaf replicated over dp and still split over ``model`` (the
    reference's ``serve_shardings``), so that no step gathers over dp. A
    leaf split over ``model`` whose split the model code keeps
    (``keep_tp(path, leaf)``) is its tp shards, (tp, *local): one copy a tp
    rank, which every dp rank reads (rank r reads copy r % tp); any other
    leaf is its global tensor expanded over the ranks (a view). Built once,
    from each leaf's global tensor."""
    def one(path, leaf: Stacked) -> Stacked:
        full = global_tensor(leaf._replace(local=unique_shards(leaf)))
        spec = strip_dp(leaf.spec, dp)
        if not (shard_axes(spec, mesh) and keep_tp(path, leaf)):
            spec = tuple(None for _ in spec)
            return Stacked(full.expand(mesh.n_ranks, *full.shape), spec, mesh)
        tp_mesh = StackedMesh(**{TP_AXIS: mesh.tp})
        return Stacked(split_global(full, spec, tp_mesh), spec, tp_mesh)

    return tree_map_with_path(one, params)


# ----------------------------------------------------- flat-bucket utilities


def _leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples in JAX's order: a
    dict's keys sorted (``jax.tree.flatten``), sequences in order, None an
    empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for item in tree for leaf in _leaves(item)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree`` with its tensors replaced, in ``_leaves`` order, from the
    iterator ``leaves``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        new = {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
        return {key: new[key] for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(item, leaves) for item in tree)
    return next(leaves)


def flatten_bucket(tree, pad_to: int = 1):
    """A tree of tensors -> (one contiguous f32 bucket, zero-padded to a
    multiple of ``pad_to``; ``unflatten``, which cuts a bucket back into
    the tree's shapes and dtypes). The paper's collectives move flat
    buffers; the leaf order is the reference's (``sharding/fsdp.py:122``),
    so the bucket equals its bucket element for element."""
    leaves = _leaves(tree)
    flat = torch.cat([leaf.reshape(-1).to(torch.float32) for leaf in leaves])
    n = flat.shape[0]
    padded = -(-n // pad_to) * pad_to
    if padded != n:
        flat = torch.nn.functional.pad(flat, (0, padded - n))
    shapes = [(leaf.shape, leaf.dtype) for leaf in leaves]

    def unflatten(buf: torch.Tensor):
        out, off = [], 0
        for shape, dtype in shapes:
            k = shape.numel()
            out.append(buf[off:off + k].reshape(shape).to(dtype))
            off += k
        return _rebuild(tree, iter(out))

    return flat, unflatten
