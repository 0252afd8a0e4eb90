"""Parameter / batch / cache sharding specs, and the stacked parameter leaf.

The rules are the reference's (``repro.sharding.specs``): keyed by leaf name,
applied to the trailing dims, with any dim that does not divide its mesh axes
left replicated. A spec is a plain tuple with one entry per dim: None, an
axis name, or a tuple of axis names (the reference's ``PartitionSpec``
entries).

A parameter leaf of the port is a ``Stacked``: rank r's shard of the global
tensor at ``local[r]``, with the global tensor's spec and the mesh beside
it. Every physical axis of the mesh (the dp axes, and ``model`` where it is
above 1) splits the dims the rules give it; a leaf replicated over every
axis is one tensor expanded over the rank dim, and a leaf split over some
axes only holds its shard once per rank of the others.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.launch.mesh import TP_AXIS, StackedMesh

Axes = Any  # str | tuple[str, ...] | None
Spec = tuple  # one Axes entry per dim


class Stacked(NamedTuple):
    local: torch.Tensor  # (R, *local shape): rank r's shard at local[r]
    spec: Spec           # spec of the global tensor
    # the mesh the spec splits over; None where no leaf is split over more
    # than one axis (a leaf made before the model axis was physical)
    mesh: StackedMesh | None = None


def tree_map(fn: Callable, tree):
    """Map ``fn`` over the leaves of nested dicts (``Stacked`` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts, in key order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """Like ``tree_map``; ``fn(path, leaf)`` gets the tuple of dict keys."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


# trailing-dims sharding rule per leaf name: "dp" = FSDP axes, "tp" = model
_IN_OUT = ("dp", "tp")     # (fan_in, fan_out) matrices
_OUT_IN = ("tp", "dp")     # (fan_out-side, fan_in-side): wo / w_down style
_RULES: dict[str, tuple] = {
    "embed": ("tp", "dp"),           # vocab x d_model
    "lm_head": ("dp", "tp"),
    "patch_proj": (None, None),
    # dense attention + mlp
    "wq": _IN_OUT, "wk": _IN_OUT, "wv": _IN_OUT, "wo": _OUT_IN,
    "w_gate": _IN_OUT, "w_up": _IN_OUT, "w_down": _OUT_IN,
    "w_in": _IN_OUT, "w_out_mlp": _OUT_IN,
    # rwkv
    "wg": _IN_OUT, "wr": _IN_OUT,
    "cm_wk": _IN_OUT, "cm_wv": _OUT_IN, "cm_wr": _IN_OUT,
    "ts_w1": ("dp", None), "ts_w2": (None, None, "dp"),
    "decay_w1": ("dp", None), "decay_w2": (None, "dp"),
    # rg-lru
    "w_gate_in": _IN_OUT, "w_rec_in": _IN_OUT,
    "lru_a_gate": _IN_OUT, "lru_x_gate": _IN_OUT,
    "conv_w": (None, "tp"),
    "lru_a_bias": ("tp",), "lru_x_bias": ("tp",), "lru_lam": ("tp",),
    "conv_b": ("tp",),
}
# MoE expert tensors carry a leading E dim sharded over tp (EP):
_MOE_RULES = {
    "w_gate": ("tp", "dp", None),
    "w_up": ("tp", "dp", None),
    "w_down": ("tp", None, "dp"),
    "router": ("dp", None),
}


def dp_axes(mesh_cfg: MeshConfig) -> tuple[str, ...]:
    return ("pod", "data") if mesh_cfg.multi_pod else ("data",)


def _axes_size(mesh: StackedMesh, axes: Axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def _resolve_dim(dim_size: int, tag, mesh: StackedMesh, dp: tuple[str, ...]):
    if tag is None:
        return None
    axes = dp if tag == "dp" else TP_AXIS
    return axes if dim_size % _axes_size(mesh, axes) == 0 else None


def _leaf_spec(path: tuple, leaf, mesh: StackedMesh, dp: tuple[str, ...]) -> Spec:
    """Spec of a global leaf (anything with ``.shape``) named by ``path``:
    the MoE rules inside ``moe`` but not inside its ``shared`` experts
    (reference ``sharding/specs.py:78``)."""
    name = path[-1]
    in_moe = "moe" in path and "shared" not in path
    rules = _MOE_RULES if (in_moe and name in _MOE_RULES) else _RULES
    if name == "w_out":
        rules = {"w_out": _OUT_IN}
    if name not in rules:
        return ()  # replicate (norms, biases)
    tags = rules[name]
    nd = len(leaf.shape)
    k = len(tags)
    if nd < k:
        return ()
    lead = [None] * (nd - k)
    dims = [_resolve_dim(leaf.shape[nd - k + i], tags[i], mesh, dp) for i in range(k)]
    return (*lead, *dims)


def param_pspecs(params, mesh: StackedMesh | None, mesh_cfg: MeshConfig):
    """Tree of specs matching a tree of global leaves (numpy arrays or tensors);
    everything is replicated without a mesh."""
    if mesh is None:
        return tree_map(lambda leaf: (), params)
    dp = dp_axes(mesh_cfg)
    return tree_map_with_path(lambda p, leaf: _leaf_spec(p, leaf, mesh, dp), params)


def batch_pspecs(cfg: ModelConfig, shape: ShapeConfig, mesh: StackedMesh,
                 mesh_cfg: MeshConfig):
    """Input batch specs: batch dim over dp (when divisible), rest replicated
    (over ``model`` too: every tp rank of a dp rank holds its rows)."""
    from repro_torch.models.model_builder import batch_dims

    dp = dp_axes(mesh_cfg)
    ndp = _axes_size(mesh, dp)
    out = {}
    for name, shp in batch_dims(cfg, shape).items():
        bspec = dp if shp[0] % ndp == 0 else None
        out[name] = (bspec, *([None] * (len(shp) - 1)))
    return out


def cache_pspecs(cfg: ModelConfig, cache, mesh: StackedMesh, mesh_cfg: MeshConfig):
    """Decode caches, the reference's rules: batch over dp; a dense cache
    (L, B, KV, S, hd|1), the int8 cache's scales ``ks``/``vs`` and the
    encdec's cross K/V ``xk``/``xv`` too, its sequence over ``model`` where
    it divides (the flash-decoding layout);
    the hybrid's window rings (G, B, KV, W, hd) whole over ``model``; the
    recurrent states' heads or channels over ``model`` where they divide.
    The stacked backend keeps the cache as the global tensor, batch
    rank-major and sequence shard-major, and rank (d, m) reads and writes
    its view of rows d and positions m (``models.transformer.cache_view``):
    the shards are where the spec puts them, with no copy per rank."""
    dp = dp_axes(mesh_cfg)
    ndp = _axes_size(mesh, dp)
    tp = mesh.shape[TP_AXIS]

    def spec_for(path, leaf):
        name = path[-1]
        bspec = dp if leaf.shape[1] % ndp == 0 else None

        def over(dim):   # ``model`` on dim where it divides
            return TP_AXIS if leaf.shape[dim] % tp == 0 else None

        if name in ("k", "v", "xk", "xv", "ks", "vs"):
            return (None, bspec, None, over(3), None)
        if name in ("attn_k", "attn_v"):
            return (None, bspec, None, None, None)
        if name == "wkv":
            return (None, bspec, over(2), None, None)
        if name in ("tm_x", "cm_x", "h"):
            return (None, bspec, over(2))
        if name == "conv":
            return (None, bspec, None, over(3))
        return ()

    return tree_map_with_path(spec_for, cache)


def entry_axes(entry: Axes) -> tuple[str, ...]:
    """The axis names of one spec entry, major first."""
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


def is_sharded(spec: Spec, dp: tuple[str, ...]) -> bool:
    """Whether any dim of ``spec`` is split over a dp axis."""
    return any(a in dp for entry in spec for a in entry_axes(entry))


def is_tp_sharded(spec: Spec, mesh: StackedMesh | None) -> bool:
    """Whether a dim of ``spec`` is split over a physical ``model`` axis."""
    return (mesh is not None and mesh.tp > 1
            and any(a == TP_AXIS for entry in spec for a in entry_axes(entry)))


def shard_axes(spec: Spec, mesh: StackedMesh | None) -> tuple[str, ...]:
    """The physical axes that split a leaf of ``spec``, in mesh order."""
    if mesh is None:
        return ()
    used = {a for entry in spec for a in entry_axes(entry)}
    return tuple(a for a in mesh.rank_axes if a in used)


def strip_dp(spec: Spec, dp: tuple[str, ...]) -> Spec:
    """``spec`` with the dp axes removed: the leaf replicated over dp, still
    split over ``model`` (the reference's ``serve_loop._strip_dp``)."""
    def strip(entry):
        rest = tuple(a for a in entry_axes(entry) if a not in dp)
        return rest if len(rest) > 1 else (rest[0] if rest else None)

    return tuple(strip(e) for e in spec)
