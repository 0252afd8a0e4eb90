"""Carries a parameter tree into the port.

``to_torch`` takes the JAX package's dense or MoE parameter tree as numpy
arrays, ``{"embed", "final_ln", "blocks": {...stacked on L}}``, and returns the port's
tree of ``Stacked`` leaves: every leaf is split as ``param_pspecs`` splits
it over the mesh's physical axes (dp, and ``model`` where it is above 1)
into the stacked (R, *local) layout, rank r's shard at index r (a shard
held once per rank of the axes that do not split it); a leaf that no axis
splits is one tensor expanded over the rank dim.

``to_numpy`` is the inverse: stacked leaves back to the global numpy tree,
so that tests can compare parameters and optimizer moments after steps.

``random_params`` draws such a tree from a seed with numpy, in the
reference's init scales (``repro.models.layers``, ``repro.models.moe``), for
runs without a checkpoint. ``device_params`` draws a tree of the same
shapes, scales and layout directly into each rank's shards on the device,
for models too large for a host draw.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import MeshConfig, ModelConfig
from repro_torch.device import device_of
from repro_torch.launch.mesh import StackedMesh
from repro_torch.sharding.fsdp import (_local_shape, expand_ranks, global_tensor,
                                       split_global, unique_shards)
from repro_torch.sharding.specs import (Stacked, _leaf_spec, dp_axes, shard_axes, tree_map,
                                       tree_map_with_path)

# norm scales and the MoE router stay float32 whatever the weights' dtype,
# as the reference initialises them
_F32_LEAVES = ("ln1", "ln2", "final_ln", "router")


def to_torch(tree, mesh: StackedMesh | None, mesh_cfg: MeshConfig, *,
             dtype: torch.dtype, device: str | torch.device = "cuda"):
    """numpy parameter tree -> tree of ``Stacked`` on ``device``. Weights are
    cast to ``dtype``; the norm scales stay float32."""
    dev = device_of(device)
    dp = dp_axes(mesh_cfg)
    if mesh is not None and mesh.dp_rank_axes != dp:
        raise ValueError(f"{mesh} must stack exactly the dp axes {dp}")
    n = 1 if mesh is None else mesh.n_ranks

    def leaf(path, a):
        a = np.asarray(a)
        dt = torch.float32 if path[-1] in _F32_LEAVES else dtype
        full = torch.from_numpy(np.ascontiguousarray(a)).to(device=dev, dtype=dt)
        if mesh is None:
            return Stacked(full.expand(1, *full.shape), ())
        spec = _leaf_spec(path, a, mesh, dp)
        return Stacked(expand_ranks(split_global(full, spec, mesh), spec, mesh, n), spec, mesh)

    return tree_map_with_path(leaf, tree)


def to_numpy(params, mesh: StackedMesh | None, mesh_cfg: MeshConfig) -> dict:
    """The inverse of ``to_torch``: a tree of ``Stacked`` leaves (R, ...) ->
    the global numpy tree, float32 for floating leaves (numpy has no
    bfloat16). A shard held by several ranks is read from the first."""
    def leaf(s: Stacked) -> np.ndarray:
        if mesh is None or not shard_axes(s.spec, mesh):
            t = s.local.detach()[0]
        else:
            s = s._replace(mesh=mesh)
            t = global_tensor(s._replace(local=unique_shards(s)))
        return (t.float() if t.is_floating_point() else t).cpu().numpy()

    return tree_map(leaf, params)


class _Leaf(NamedTuple):
    shape: tuple[int, ...]
    scale: float   # std of the normal draw; 0 for a leaf of zeros (norm scales)


def _param_table(cfg: ModelConfig) -> dict:
    """The parameter tree's leaves as (global shape, init scale), in the
    reference's init scales (``layers.mlp_init``, ``moe.moe_init``) and in
    the order in which ``random_params`` draws them."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"family {cfg.family!r} is not ported; only dense and moe")
    d, h, kvh, hd, n_l = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    blocks = {
        "ln1": _Leaf((n_l, d), 0.0),
        "attn": {
            "wq": _Leaf((n_l, d, h * hd), 1 / np.sqrt(d)),
            "wk": _Leaf((n_l, d, kvh * hd), 1 / np.sqrt(d)),
            "wv": _Leaf((n_l, d, kvh * hd), 1 / np.sqrt(d)),
            "wo": _Leaf((n_l, h * hd, d), 1 / np.sqrt(h * hd)),
        },
        "ln2": _Leaf((n_l, d), 0.0),
    }
    if cfg.family == "moe":
        m = cfg.moe
        e, fe = m.n_routed_experts, m.d_ff_expert
        blocks["moe"] = {
            "router": _Leaf((n_l, d, e), 1 / np.sqrt(d)),
            "w_gate": _Leaf((n_l, e, d, fe), 1 / np.sqrt(d)),
            "w_up": _Leaf((n_l, e, d, fe), 1 / np.sqrt(d)),
            "w_down": _Leaf((n_l, e, fe, d), 1 / np.sqrt(fe)),
        }
        if m.n_shared_experts:
            blocks["moe"]["shared"] = _swiglu_table(n_l, d, fe * m.n_shared_experts)
    elif cfg.act == "swiglu":
        blocks["mlp"] = _swiglu_table(n_l, d, cfg.d_ff)
    else:
        # any other activation: the plain two-layer MLP (layers.mlp_init)
        blocks["mlp"] = {"w_in": _Leaf((n_l, d, cfg.d_ff), 1 / np.sqrt(d)),
                         "w_out": _Leaf((n_l, cfg.d_ff, d), 1 / np.sqrt(cfg.d_ff))}
    table = {"embed": _Leaf((cfg.vocab_size, d), 0.02), "final_ln": _Leaf((d,), 0.0),
             "blocks": blocks}
    if not cfg.tie_embeddings:
        table["lm_head"] = _Leaf((d, cfg.vocab_size), 1 / np.sqrt(d))
    return table


def _swiglu_table(n_l: int, d: int, f: int) -> dict:
    return {"w_gate": _Leaf((n_l, d, f), 1 / np.sqrt(d)),
            "w_up": _Leaf((n_l, d, f), 1 / np.sqrt(d)),
            "w_down": _Leaf((n_l, f, d), 1 / np.sqrt(f))}


def random_params(cfg: ModelConfig, seed: int) -> dict:
    """Dense or MoE parameter tree drawn with numpy from ``seed``, float32,
    in the reference's init scales (norm scales zero, as initialised there)."""
    rng = np.random.default_rng(seed)

    def draw(leaf: _Leaf) -> np.ndarray:
        if not leaf.scale:
            return np.zeros(leaf.shape, np.float32)
        return rng.standard_normal(leaf.shape, dtype=np.float32) * np.float32(leaf.scale)

    return tree_map(draw, _param_table(cfg))


def device_params(cfg: ModelConfig, mesh: StackedMesh | None, mesh_cfg: MeshConfig, *,
                  seed: int, dtype: torch.dtype, device: str | torch.device = "cuda"):
    """A tree of ``Stacked`` leaves as ``to_torch`` lays it out, drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``: each rank's
    shard of a split leaf directly (a global tensor is never made), a
    replicated leaf once, expanded over the ranks. Same shapes, init scales
    and dtypes as ``to_torch(random_params(cfg, seed), ...)`` (norm scales
    zero and, with the router, float32), but not its numbers: this is not
    the numpy draw. The reference's launchers draw on their device too
    (``init_state``); a host draw of deepseek-moe-16b's 16.9 B parameters
    would take 67.6 GB of float32."""
    dev = device_of(device)
    dp = dp_axes(mesh_cfg)
    if mesh is not None and mesh.dp_rank_axes != dp:
        raise ValueError(f"{mesh} must stack exactly the dp axes {dp}")
    n = 1 if mesh is None else mesh.n_ranks
    gen = torch.Generator(device=dev).manual_seed(seed)

    def leaf(path, spec_leaf: _Leaf) -> Stacked:
        spec = () if mesh is None else _leaf_spec(path, spec_leaf, mesh, dp)
        dt = torch.float32 if path[-1] in _F32_LEAVES else dtype
        axes = shard_axes(spec, mesh)
        shape = list(spec_leaf.shape)
        if axes:
            shape = [math.prod(mesh.shape[a] for a in axes), *_local_shape(shape, spec, mesh)]
        t = torch.empty(shape, dtype=dt, device=dev)
        if spec_leaf.scale:
            t.normal_(0.0, float(spec_leaf.scale), generator=gen)
        else:
            t.zero_()
        if mesh is None:
            return Stacked(t.expand(n, *shape), spec)
        return Stacked(expand_ranks(t, spec, mesh, n), spec, mesh)

    return tree_map_with_path(leaf, _param_table(cfg))
