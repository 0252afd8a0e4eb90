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
first, then the "pod" axis through the M-chain broadcast composition.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.configs.base import CollectiveConfig, MeshConfig
from repro_torch.core import collectives as C
from repro_torch.launch.mesh import TP_AXIS, StackedMesh
from repro_torch.sharding.specs import Spec, Stacked, dp_axes, is_sharded, tree_map


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
    """Gather every dp axis out of a stacked weight x (R, *local); tp stays
    layout. Hierarchical: the minor (intra-pod "data") axis first, then the
    "pod" axis via the M-chain broadcast composition."""
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


def trainable(params, dp: tuple[str, ...]):
    """A tree of ``Stacked`` leaves -> the same tree over fresh leaf tensors
    that require grad: a dp-sharded leaf keeps its (R, *local) layout; a
    replicated leaf is its one (*global) tensor, so its gradient is the sum
    over ranks (the all-reduce GSPMD inserts in the reference) and an
    optimizer step updates it once. ``at_use`` expands it over the ranks."""
    def one(leaf: Stacked) -> Stacked:
        t = leaf.local if is_sharded(leaf.spec, dp) else leaf.local[0]
        return Stacked(t.detach().clone().requires_grad_(), leaf.spec)

    return tree_map(one, params)


def at_use(params, n_ranks: int, dp: tuple[str, ...]):
    """A trainable tree (``trainable``) -> the tree of ``Stacked`` leaves the
    model takes: every replicated leaf expanded over the ``n_ranks`` ranks,
    inside autograd's sight."""
    def one(leaf: Stacked) -> Stacked:
        if is_sharded(leaf.spec, dp):
            return leaf
        return Stacked(leaf.local.expand(n_ranks, *leaf.local.shape), leaf.spec)

    return tree_map(one, params)


def _rank_dim(spec: Spec) -> int | None:
    """The dim that a leaf of the trainable layout splits over the ranks (the
    rules split one dim over every dp axis, or none), or None."""
    for dim, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if any(a != TP_AXIS for a in axes):
            return dim
    return None


def global_shape(leaf: Stacked) -> tuple[int, ...]:
    """The global shape of a leaf of the trainable layout (``trainable``)."""
    d = _rank_dim(leaf.spec)
    if d is None:
        return tuple(leaf.local.shape)
    shape = list(leaf.local.shape[1:])
    shape[d] *= leaf.local.shape[0]
    return tuple(shape)


def global_tensor(leaf: Stacked) -> torch.Tensor:
    """The global tensor of a leaf of the trainable layout: a split leaf's
    shards (R, *local) joined along its split dim in rank order (a new
    tensor); a replicated leaf its one tensor."""
    t = leaf.local.detach()
    d = _rank_dim(leaf.spec)
    if d is None:
        return t
    moved = t.movedim(0, d)   # (*local[:d], R, local[d], ...)
    return moved.reshape(*moved.shape[:d], -1, *moved.shape[d + 2:])


def split_global(t: torch.Tensor, spec: Spec, n_ranks: int) -> torch.Tensor:
    """The inverse of ``global_tensor``: a global tensor -> its leaf of the
    trainable layout for ``spec`` over ``n_ranks`` ranks, rank r's chunk of
    the split dim at index r (a new tensor where split)."""
    d = _rank_dim(spec)
    if d is None:
        return t
    chunked = t.reshape(*t.shape[:d], n_ranks, t.shape[d] // n_ranks, *t.shape[d + 1:])
    return chunked.movedim(d, 0).clone(memory_format=torch.contiguous_format)


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
