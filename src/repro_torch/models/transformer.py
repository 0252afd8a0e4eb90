"""Dense and MoE decoder stack (counterpart of the dense and moe paths of
``repro.models.transformer``).

Every dp rank is real: activations carry a leading rank dim R, rank r holds
batch rows [r * B/R, (r + 1) * B/R) of the global batch, and each layer's
weights are gathered per layer into every rank's own copy, (R, *global), so
rank r computes with its copy only. Attention and the KV caches fold the
rank dim back into the global batch, rank-major, which is the reference's
batch-over-dp layout.

A global batch that does not split over the R ranks is replicated, as the
reference's GSPMD replicates it (``ShardCtx.shard_batch`` False): every rank
holds the whole batch (B rows) and computes it with its own copy of the
weights. The outputs and the KV cache are then rank 0's, B rows once; in
decode the R ranks share that cache.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import SideStream
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe
from repro_torch.sharding.ctx import (from_ranks, get_ctx, maybe_gather_params, shard,
                                     to_ranks, use_ctx)
from repro_torch.sharding.fsdp import gather_leaf
from repro_torch.sharding.specs import Stacked, tree_map

Params = Any  # nested dict of Stacked leaves


def plain_gather(leaf: Stacked) -> torch.Tensor:
    """Every rank's copy of a weight used outside the layer loop, through the
    plain gather (GSPMD's gather in the reference, in every mode)."""
    c = get_ctx()
    return gather_leaf(leaf.local, leaf.spec, c.mesh, c.dp_axes, "xla", 1)


def n_ranks(params: Params) -> int:
    return params["embed"].local.shape[0]


def layer_slice(blocks: Params, i: int) -> Params:
    """Layer i of the L-stacked block tree, still stacked over ranks."""
    return tree_map(lambda s: Stacked(s.local[:, i], s.spec[1:]), blocks)


# ------------------------------------------------------------------ dense block


def dense_block_apply(p, x: torch.Tensor, cfg: ModelConfig, *, positions, want_kv: bool):
    """Train/prefill path. x (R, B, S, D); p one layer's gathered weights.
    Returns (x, aux metrics ({} but for MoE), (k, v) each (R*B, KV, S, hd) |
    None). Reference: ``transformer.py:53``."""
    r, b = x.shape[:2]
    h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
    q, k, v = layers.qkv_split(p["attn"], h, cfg)
    q = apply_positions(q, positions, cfg)
    k = apply_positions(k, positions, cfg)
    k, v = k.flatten(0, 1), v.flatten(0, 1)
    o = attn.blockwise_attention(
        q.flatten(0, 1), k, v,
        causal=True,
        window=cfg.attn_window,
        q_block=cfg.attn_q_block,
        kv_block=cfg.attn_kv_block,
        softcap=cfg.attn_logit_softcap,
    )
    x = x + shard(layers.out_proj(p["attn"], o.unflatten(0, (r, b))), "dp", "sp", None)
    h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
    aux = {}
    if cfg.family == "moe":
        ff, aux = moe.moe_apply(p["moe"], h2, cfg)
    else:
        ff = layers.mlp_apply(p["mlp"], h2, _mlp_act(cfg))
    x = x + shard(ff, "dp", "sp", None)
    kv = (k.transpose(1, 2), v.transpose(1, 2)) if want_kv else None  # (B,KV,S,hd)
    return x, aux, kv


def _mlp_act(cfg: ModelConfig) -> str:
    return "swiglu" if cfg.act == "swiglu" else cfg.act


def apply_positions(x: torch.Tensor, positions, cfg: ModelConfig) -> torch.Tensor:
    if not cfg.rope_theta:
        return x
    return layers.apply_rope(x, positions, cfg.rope_theta)


def _decode_attention(q: torch.Tensor, kc, vc, pos, cfg: ModelConfig) -> torch.Tensor:
    """q (R, B, H, hd), pos (R, B) against the caches of the global batch
    (``from_ranks`` rows). Returns (R, B, H, hd). With a replicated batch
    every rank holds the same queries over one shared cache: rank 0's are
    attended once and the result expanded over the ranks."""
    kw = dict(window=cfg.attn_window, softcap=cfg.attn_logit_softcap)
    if get_ctx().shard_batch:
        o = attn.plain_decode_attention(q.flatten(0, 1), kc, vc, pos.flatten(), **kw)
        return o.unflatten(0, q.shape[:2])
    o = attn.plain_decode_attention(q[0], kc, vc, pos[0], **kw)
    return o.expand(q.shape[0], *o.shape)


def dense_block_decode(p, x: torch.Tensor, cfg: ModelConfig, kc, vc, pos):
    """Decode path. x (R, B, D); kc/vc (global batch, KV, S, hd), updated in
    place; pos (R, B). Returns x. MoE routes without drops (reference
    ``transformer.py:132``)."""
    h = layers.rms_norm(x[:, :, None], p["ln1"], cfg.norm_eps)   # (R,B,1,D)
    q, k, v = layers.qkv_split(p["attn"], h, cfg)
    q = apply_positions(q, pos[..., None], cfg)
    k = apply_positions(k, pos[..., None], cfg)
    attn.cache_scatter_update(kc, from_ranks(k[:, :, 0]), from_ranks(pos))
    attn.cache_scatter_update(vc, from_ranks(v[:, :, 0]), from_ranks(pos))
    o = _decode_attention(q[:, :, 0], kc, vc, pos, cfg)
    x = x + layers.out_proj(p["attn"], o[:, :, None])[:, :, 0]
    h2 = layers.rms_norm(x[:, :, None], p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        ff, _ = moe.moe_apply(p["moe"], h2, cfg, no_drop=True)
    else:
        ff = layers.mlp_apply(p["mlp"], h2, _mlp_act(cfg))
    return x + ff[:, :, 0]


# ----------------------------------------------------------------- LM skeleton


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (R, B, S) -> (R, B, S, D), each rank from its copy."""
    emb = plain_gather(params["embed"])                      # (R, V, D)
    ranks = torch.arange(emb.shape[0], device=emb.device)
    x = emb[ranks.view(-1, *([1] * (tokens.dim() - 1))), tokens]
    return shard(x, "dp", "sp", None)


def head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    """Every rank's copy of the output head (R, D, V): the tied embedding's
    transpose (a view) or the untied head."""
    if cfg.tie_embeddings:
        return plain_gather(params["embed"]).transpose(1, 2)
    return plain_gather(params["lm_head"])


def final_hidden(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return layers.rms_norm(x, plain_gather(params["final_ln"]), cfg.norm_eps)


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (R, ..., D) -> (R, ..., V)."""
    return layers.rank_matmul(final_hidden(params, cfg, x), head_matrix(params, cfg))


# --------------------------------------------------------------- dense forward


REMAT = ("none", "full", "dots")
# the products that remat="dots" keeps: the rank matmul (every projection
# of a gathered weight; ``layers`` registers the op) and the attention
# einsums, which reach bmm / mm
_PRODUCTS = (torch.ops.repro_torch.rank_matmul.default, torch.ops.aten.bmm.default,
             torch.ops.aten.mm.default)


def check_remat(remat: str) -> None:
    if remat not in REMAT:
        raise ValueError(f"unknown remat policy {remat!r}; one of {REMAT}")


def _save_products(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return CheckpointPolicy.MUST_SAVE if op in _PRODUCTS else CheckpointPolicy.PREFER_RECOMPUTE


def _remat(body, remat: str):
    """``body`` under the remat policy: "none" as it is; "full" checkpointed
    (its backward runs it again, as ``jax.checkpoint`` does); "dots"
    checkpointed keeping every product's output, so that the backward runs
    again everything else (``checkpoint_dots``: it saves every dot_general).

    "dots" is PyTorch's selective checkpoint: the policy sees dispatcher
    ops, which is why the rank matmul, a ctypes launch, is the op
    ``repro_torch::rank_matmul``. It is kept over a hand-rolled stash of
    the products (the body's forward keeping each output, its recompute
    returning them) because it needs no change to any autograd node and
    saves exactly what ``checkpoint_dots`` saves; its cost is on the host:
    every op of the body, forward and recompute, passes its Python
    dispatch mode."""
    check_remat(remat)
    if remat == "none":
        return body
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                             _save_products)
    return lambda *args: checkpoint(body, *args, **kw)


def _aux0(cfg: ModelConfig) -> dict:
    return ({"moe_aux": 0.0, "moe_zloss": 0.0, "moe_drop_frac": 0.0}
            if cfg.family == "moe" else {})


def _add_aux(acc: dict, aux: dict) -> dict:
    return {k: acc.get(k, 0.0) + v for k, v in aux.items()} if aux else acc


def _mean_aux(cfg: ModelConfig, aux: dict) -> dict:
    """The layers' summed aux metrics over the layer count (MoE)."""
    return {k: v / cfg.num_layers for k, v in aux.items()} if cfg.family == "moe" else aux


def _scan_blocks(params, cfg, x, positions, *, want_kv, remat: str = "none"):
    """Layer loop: gather layer i's weights, then apply the block; the
    blocks' aux metrics are summed, then divided by the layer count
    (reference ``transformer.py:190``). With
    remat="full" or "dots" the gather and the block are one checkpointed
    body, so the backward gathers the layer again, as the reference's
    jax.checkpoint of its scan body does. With the context's
    ``prefetch_params`` the training path takes ``_scan_blocks_prefetch``,
    as the reference decides it (transformer.py:190)."""
    ctx = get_ctx()   # the backward's recompute runs under the same context
    if ctx.prefetch_params and not want_kv and cfg.num_layers > 1:
        return _scan_blocks_prefetch(params, cfg, x, positions, remat=remat)

    def body(x, layer):
        with use_ctx(ctx):
            bp = maybe_gather_params(layer)
            return dense_block_apply(bp, x, cfg, positions=positions, want_kv=want_kv)

    fn = _remat(body, remat)
    kvs, aux = [], _aux0(cfg)
    for i in range(cfg.num_layers):
        x, layer_aux, kv = fn(x, layer_slice(params["blocks"], i))
        aux = _add_aux(aux, layer_aux)
        kvs.append(kv)
    return x, _mean_aux(cfg, aux), kvs


def _scan_blocks_prefetch(params, cfg, x, positions, *, remat: str = "none"):
    """The reference's explicit compute/gather overlap (the paper's
    interleaved collectives, transformer.py:221): layer 0 is gathered
    before the loop; each body step issues the gather of layer i + 1, then
    runs block i on layer i's gathered weights; the last block runs after
    the loop, outside any checkpoint. Under remat the body (gather i + 1 and
    block i) is what is checkpointed, so its backward gathers layer i + 1
    again. Train path only (no kv cache).

    On the card every gather runs on the device's side stream
    (``device.SideStream``); the current stream waits for layer i's gathers
    (an event) only when block i starts, so the gather of layer i + 1 can
    run beside block i. On the CPU the same calls run in order."""
    ctx = get_ctx()
    blocks = params["blocks"]
    side = SideStream(x.device)

    def gather(layer):
        with use_ctx(ctx):
            return maybe_gather_params(layer)

    def body(x, gathered, ready, layer_next):
        g_next, ready_next = side.issue(gather, layer_next)   # prefetch layer i + 1
        side.join(ready)
        with use_ctx(ctx):
            x, aux, _ = dense_block_apply(gathered, x, cfg, positions=positions,
                                          want_kv=False)
        return x, aux, g_next, ready_next

    fn = _remat(body, remat)
    gathered, ready = side.issue(gather, layer_slice(blocks, 0))
    aux = _aux0(cfg)
    for i in range(1, cfg.num_layers):
        x, layer_aux, gathered, ready = fn(x, gathered, ready, layer_slice(blocks, i))
        aux = _add_aux(aux, layer_aux)
    side.join(ready)
    x, layer_aux, _ = dense_block_apply(gathered, x, cfg, positions=positions, want_kv=False)
    return x, _mean_aux(cfg, _add_aux(aux, layer_aux)), None


def dense_forward(params, cfg: ModelConfig, batch, *, want_cache=False, remat="none"):
    """batch: tokens (B, S). Returns (hidden (R, B/R, S, D) or, replicated,
    (R, B, S, D); aux metrics ({} but for MoE); cache | None); the cache is
    {"k", "v"} of (L, B, KV, S, hd)."""
    tokens = to_ranks(batch["tokens"], n_ranks(params))
    x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(x.shape[2], device=x.device)[None, :]
    x, aux, kvs = _scan_blocks(params, cfg, x, positions, want_kv=want_cache, remat=remat)
    cache = None
    if want_cache:
        cache = {name: torch.stack([from_ranks(kv[j].unflatten(0, x.shape[:2])) for kv in kvs])
                 for j, name in enumerate(("k", "v"))}
    return x, aux, cache


def dense_decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token (B,), pos (B,). Returns (logits (B, V), cache updated in place)."""
    r = n_ranks(params)
    x = embed_tokens(params, cfg, to_ranks(token[:, None], r))[:, :, 0]   # (R,B,D)
    pos_r = to_ranks(pos, r)
    for i in range(cfg.num_layers):
        bp = maybe_gather_params(layer_slice(params["blocks"], i))
        x = dense_block_decode(bp, x, cfg, cache["k"][i], cache["v"][i], pos_r)
    logits = lm_logits(params, cfg, x[:, :, None])[:, :, 0]
    return from_ranks(logits), cache


def dense_init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError(f"kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported")
    shp = (cfg.num_layers, batch, cfg.num_kv_heads, seq_len, cfg.head_dim)
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}
