"""Parameter / batch / cache sharding specs, and the stacked parameter leaf.

The rules are the reference's (``repro.sharding.specs``): keyed by leaf name,
applied to the trailing dims, with any dim that does not divide its mesh axes
left replicated. A spec is a plain tuple with one entry per dim: None, an
axis name, or a tuple of axis names (the reference's ``PartitionSpec``
entries).

A parameter leaf of the port is a ``Stacked``: rank r's shard of the global
tensor at ``local[r]``, with the global tensor's spec beside it. Only the dp
axes are physical; a leaf replicated over them is one tensor expanded over
the rank dim.
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
    """Spec of a global leaf (anything with ``.shape``) named by ``path``."""
    name = path[-1]
    rules = {"w_out": _OUT_IN} if name == "w_out" else _RULES
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
    """Input batch specs: batch dim over dp (when divisible), rest replicated."""
    from repro_torch.models.model_builder import batch_dims

    dp = dp_axes(mesh_cfg)
    ndp = _axes_size(mesh, dp)
    out = {}
    for name, shp in batch_dims(cfg, shape).items():
        bspec = dp if shp[0] % ndp == 0 else None
        out[name] = (bspec, *([None] * (len(shp) - 1)))
    return out


def cache_pspecs(cfg: ModelConfig, cache, mesh: StackedMesh, mesh_cfg: MeshConfig):
    """Dense decode caches (L, B, KV, S, hd): batch over dp, KV sequence over
    ``model`` (flash-decoding layout). The stacked backend keeps the cache in
    global batch order, rank-major, which is this layout at tp = 1."""
    dp = dp_axes(mesh_cfg)
    ndp = _axes_size(mesh, dp)
    tp = mesh.shape[TP_AXIS]

    def spec_for(path, leaf):
        if path[-1] not in ("k", "v"):
            return ()
        bspec = dp if leaf.shape[1] % ndp == 0 else None
        sspec = TP_AXIS if leaf.shape[3] % tp == 0 else None
        return (None, bspec, None, sspec, None)

    return tree_map_with_path(spec_for, cache)


def is_sharded(spec: Spec, dp: tuple[str, ...]) -> bool:
    """Whether any dim of ``spec`` is split over a dp axis."""
    for entry in spec:
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        if any(a in dp for a in axes):
            return True
    return False
