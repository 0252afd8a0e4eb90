"""Carries a parameter tree into the port.

``to_torch`` takes the JAX package's parameter tree as numpy arrays (dense,
MoE, VLM and RWKV ``{"embed", "final_ln", "blocks": {...stacked on L}}``,
the VLM's ``patch_proj`` beside them; the hybrid's blocks in
``grp_rec_a``, ``grp_rec_b``, ``grp_attn`` and ``tail_rec``; the encdec's
in ``enc_blocks`` and ``dec_blocks``, with ``enc_ln`` and ``lm_head``),
and returns the port's
tree of ``Stacked`` leaves: every leaf is split as ``param_pspecs`` splits
it over the mesh's physical axes (dp, and ``model`` where it is above 1)
into the stacked (R, *local) layout, rank r's shard at index r (a shard
held once per rank of the axes that do not split it); a leaf that no axis
splits is one tensor expanded over the rank dim.

``to_numpy`` is the inverse: stacked leaves back to the global numpy tree,
so that tests can compare parameters and optimizer moments after steps.

``random_params`` draws such a tree from a seed with numpy, in the
reference's init distributions (``repro.models.layers``, ``moe``, ``rwkv``,
``rglru``, ``encdec``), for
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

# norm scales, the MoE router and the rwkv and rg-lru vectors stay float32
# whatever the weights' dtype, as the reference initialises them
_F32_LEAVES = ("ln1", "ln2", "final_ln", "router", "ln_x", "enc_ln",
               "mu", "decay_base", "bonus", "ln_x_scale", "ln_x_bias", "cm_mu_k", "cm_mu_r",
               "ln", "conv_b", "lru_a_bias", "lru_x_bias", "lru_lam")


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
    scale: float   # std of the normal draw, or the uniform's width; 0: zeros
    dist: str = "normal"   # "normal" N(0, 1) * scale, "uniform" U[0, 1) * scale + shift,
    shift: float = 0.0     # "ones"


def _attn_table(n_l: int, cfg: ModelConfig) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {"wq": _Leaf((n_l, d, h * hd), 1 / np.sqrt(d)),
            "wk": _Leaf((n_l, d, kvh * hd), 1 / np.sqrt(d)),
            "wv": _Leaf((n_l, d, kvh * hd), 1 / np.sqrt(d)),
            "wo": _Leaf((n_l, h * hd, d), 1 / np.sqrt(h * hd))}


def _rwkv_table(cfg: ModelConfig) -> dict:
    """An RWKV6 block's leaves stacked on L (``rwkv.rwkv_block_init``)."""
    d, f, n_l, r = cfg.d_model, cfg.d_ff, cfg.num_layers, cfg.rwkv
    ts, dl = r.tokenshift_lora, r.decay_lora

    def mat(*shape):
        return _Leaf((n_l, *shape), 1 / np.sqrt(shape[-2]))

    half = _Leaf((n_l, d), 0.5, "uniform")
    return {"ln1": _Leaf((n_l, d), 0.0), "ln2": _Leaf((n_l, d), 0.0),
            "mu": _Leaf((n_l, 5, d), 0.5, "uniform"),
            "ts_w1": mat(d, 5 * ts), "ts_w2": mat(5, ts, d),
            "wr": mat(d, d), "wk": mat(d, d), "wv": mat(d, d), "wg": mat(d, d), "wo": mat(d, d),
            "decay_base": _Leaf((n_l, d), 2.0, "uniform", -4.0),
            "decay_w1": mat(d, dl), "decay_w2": mat(dl, d),
            "bonus": _Leaf((n_l, cfg.num_heads, cfg.head_dim), 0.5),
            "ln_x_scale": _Leaf((n_l, d), 1.0, "ones"), "ln_x_bias": _Leaf((n_l, d), 0.0),
            "cm_mu_k": half, "cm_mu_r": half,
            "cm_wk": mat(d, f), "cm_wv": mat(f, d), "cm_wr": mat(d, d)}


def _hybrid_table(cfg: ModelConfig) -> dict:
    """The hybrid's groups and trailing rec layers (``transformer._hybrid_init``):
    SwiGLU MLPs whatever ``cfg.act`` is; ``tail_rec`` stacks max(trailing, 1)
    layers."""
    d, f, g = cfg.d_model, cfg.d_ff, cfg.rglru
    w, kw = g.lru_width, g.conv_width
    n_g, n_t = cfg.num_layers // len(g.pattern), cfg.num_layers % len(g.pattern)

    def rec_layer(n: int) -> dict:
        vec = _Leaf((n, w), 0.0)
        return {"rec": {"ln": _Leaf((n, d), 0.0),
                        "w_gate_in": _Leaf((n, d, w), 1 / np.sqrt(d)),
                        "w_rec_in": _Leaf((n, d, w), 1 / np.sqrt(d)),
                        "conv_w": _Leaf((n, kw, w), 1 / np.sqrt(w)), "conv_b": vec,
                        "lru_a_gate": _Leaf((n, w, w), 1 / np.sqrt(w)), "lru_a_bias": vec,
                        "lru_x_gate": _Leaf((n, w, w), 1 / np.sqrt(w)), "lru_x_bias": vec,
                        "lru_lam": _Leaf((n, w), 2.0, "uniform", 2.0),
                        "w_out": _Leaf((n, w, d), 1 / np.sqrt(w))},
                "ln2": _Leaf((n, d), 0.0), "mlp": _swiglu_table(n, d, f)}

    return {"grp_rec_a": rec_layer(n_g), "grp_rec_b": rec_layer(n_g),
            "grp_attn": {"ln1": _Leaf((n_g, d), 0.0), "attn": _attn_table(n_g, cfg),
                         "ln2": _Leaf((n_g, d), 0.0), "mlp": _swiglu_table(n_g, d, f)},
            "tail_rec": rec_layer(max(n_t, 1))}


def _encdec_table(cfg: ModelConfig) -> dict:
    """The encoder-decoder's tree (``encdec.encdec_init``): gelu MLPs, the
    decoder's cross-attention and ``ln_x``, the untied ``lm_head``."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.encdec
    n, m = e.enc_layers, e.dec_layers
    return {"embed": _Leaf((cfg.vocab_size, d), 0.02),
            "enc_blocks": {"ln1": _Leaf((n, d), 0.0), "attn": _attn_table(n, cfg),
                           "ln2": _Leaf((n, d), 0.0), "mlp": _gelu_table(n, d, f)},
            "enc_ln": _Leaf((d,), 0.0),
            "dec_blocks": {"ln1": _Leaf((m, d), 0.0), "self_attn": _attn_table(m, cfg),
                           "ln_x": _Leaf((m, d), 0.0), "cross_attn": _attn_table(m, cfg),
                           "ln2": _Leaf((m, d), 0.0), "mlp": _gelu_table(m, d, f)},
            "final_ln": _Leaf((d,), 0.0),
            "lm_head": _Leaf((d, cfg.vocab_size), 1 / np.sqrt(d))}


def _param_table(cfg: ModelConfig) -> dict:
    """The parameter tree's leaves as ``_Leaf`` (global shape and init
    distribution), in the reference's init distributions (``layers``,
    ``moe``, ``rwkv``, ``rglru``, ``encdec``; the VLM's ``patch_proj``
    N(0, 1) / sqrt(patch_dim)) and in the order in which ``random_params``
    draws them."""
    if cfg.family == "encdec":
        return _encdec_table(cfg)
    d = cfg.d_model
    table = {"embed": _Leaf((cfg.vocab_size, d), 0.02), "final_ln": _Leaf((d,), 0.0)}
    if cfg.family == "rwkv":
        table["blocks"] = _rwkv_table(cfg)
    elif cfg.family == "hybrid":
        table.update(_hybrid_table(cfg))
    else:
        table["blocks"] = _dense_table(cfg)
    if not cfg.tie_embeddings:
        table["lm_head"] = _Leaf((d, cfg.vocab_size), 1 / np.sqrt(d))
    if cfg.family == "vlm":
        pd = cfg.vision.patch_dim
        table["patch_proj"] = _Leaf((pd, d), 1 / np.sqrt(pd))
    return table


def _dense_table(cfg: ModelConfig) -> dict:
    d, n_l = cfg.d_model, cfg.num_layers
    blocks = {"ln1": _Leaf((n_l, d), 0.0), "attn": _attn_table(n_l, cfg),
              "ln2": _Leaf((n_l, d), 0.0)}
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
        blocks["mlp"] = _gelu_table(n_l, d, cfg.d_ff)
    return blocks


def _gelu_table(n_l: int, d: int, f: int) -> dict:
    return {"w_in": _Leaf((n_l, d, f), 1 / np.sqrt(d)),
            "w_out": _Leaf((n_l, f, d), 1 / np.sqrt(f))}


def _swiglu_table(n_l: int, d: int, f: int) -> dict:
    return {"w_gate": _Leaf((n_l, d, f), 1 / np.sqrt(d)),
            "w_up": _Leaf((n_l, d, f), 1 / np.sqrt(d)),
            "w_down": _Leaf((n_l, f, d), 1 / np.sqrt(f))}


def random_params(cfg: ModelConfig, seed: int) -> dict:
    """A parameter tree drawn with numpy from ``seed``, float32, in the
    reference's init distributions (norm scales zero, as initialised there)."""
    rng = np.random.default_rng(seed)

    def draw(leaf: _Leaf) -> np.ndarray:
        if leaf.dist == "ones":
            return np.ones(leaf.shape, np.float32)
        if not leaf.scale:
            return np.zeros(leaf.shape, np.float32)
        if leaf.dist == "uniform":
            return (rng.random(leaf.shape, dtype=np.float32) * np.float32(leaf.scale)
                    + np.float32(leaf.shift))
        return rng.standard_normal(leaf.shape, dtype=np.float32) * np.float32(leaf.scale)

    return tree_map(draw, _param_table(cfg))


def _draw(t: torch.Tensor, leaf: _Leaf, gen: torch.Generator) -> None:
    """Fill ``t`` in place from ``leaf``'s init distribution."""
    if leaf.dist == "ones":
        t.fill_(1.0)
    elif not leaf.scale:
        t.zero_()
    elif leaf.dist == "uniform":
        t.uniform_(leaf.shift, leaf.shift + leaf.scale, generator=gen)
    else:
        t.normal_(0.0, float(leaf.scale), generator=gen)


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
    would take 67.6 GB of float32. On the meta device (the dry-run,
    ``launch/dryrun.py``) the leaves are laid out and nothing is drawn."""
    dev = device_of(device)
    dp = dp_axes(mesh_cfg)
    if mesh is not None and mesh.dp_rank_axes != dp:
        raise ValueError(f"{mesh} must stack exactly the dp axes {dp}")
    n = 1 if mesh is None else mesh.n_ranks
    gen = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    def leaf(path, spec_leaf: _Leaf) -> Stacked:
        spec = () if mesh is None else _leaf_spec(path, spec_leaf, mesh, dp)
        dt = torch.float32 if path[-1] in _F32_LEAVES else dtype
        axes = shard_axes(spec, mesh)
        shape = list(spec_leaf.shape)
        if axes:
            shape = [math.prod(mesh.shape[a] for a in axes), *_local_shape(shape, spec, mesh)]
        t = torch.empty(shape, dtype=dt, device=dev)
        if gen is not None:
            _draw(t, spec_leaf, gen)
        if mesh is None:
            return Stacked(t.expand(n, *shape), spec)
        return Stacked(expand_ranks(t, spec, mesh, n), spec, mesh)

    return tree_map_with_path(leaf, _param_table(cfg))
