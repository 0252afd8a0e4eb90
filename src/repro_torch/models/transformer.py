"""Decoder stacks of the dense, MoE, VLM, RWKV and hybrid (RecurrentGemma)
families (counterpart of ``repro.models.transformer``).

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

On a physical ``model`` axis (tp > 1) the block is tensor- and
sequence-parallel as the reference's GSPMD places it: the residual stream
holds each tp rank's chunk of the sequence where it divides; before
attention and before the MLP the normed stream is gathered over ``model``
(#1), the projections run column- and row-parallel on the tp-split weights,
and the row-parallel partial sums are reduce-scattered back to the
sequence chunks (#1b), or all-reduced where the sequence does not split
(decode). The embedding and the head are split over the vocabulary. Decode
with the cache's sequence split over ``model`` goes through
flash-decoding; the cache stays the global tensor, each rank reading and
writing its view (``cache_view``). The MoE's experts split over ``model``
(``moe.py``); the rwkv and hybrid blocks split their heads and the LRU
width (``rwkv.py``, ``rglru.py``), their recurrent states each rank's
chunk of the global cache (``rank_chunks``, ``join_ranks``).
"""
from __future__ import annotations

import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.device import SideStream
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, rglru, rwkv
from repro_torch.sharding import tp as TP
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
    mesh = get_ctx().mesh
    return mesh.n_ranks if mesh is not None else params["embed"].local.shape[0]


def layer_slice(blocks: Params, i: int) -> Params:
    """Layer i of the L-stacked block tree, still stacked over ranks."""
    return tree_map(lambda s: s._replace(local=s.local[:, i], spec=s.spec[1:]), blocks)


def keeps_tp(cfg: ModelConfig, path: tuple) -> bool:
    """Whether the model code uses the leaf at ``path`` as its ``model``
    split: every leaf but an attention weight (or an rwkv time-mix matrix)
    whose split does not fall on whole heads (``layers.head_plan``), which
    it gathers over ``model``."""
    plan = layers.head_plan(cfg)
    if path[-1] in ("wq", "wo", "wr", "wg"):
        return plan.q_split
    if path[-1] in ("wk", "wv"):
        return plan.kv_split
    return True


def join_ranks(t: torch.Tensor, dim: int, whole: int) -> torch.Tensor:
    """A per-rank value (R, B, ...) whose dim ``dim`` each tp rank holds as
    its chunk, or whole where its size is ``whole``, -> the global (B_g,
    ...): the tp ranks' chunks joined in rank order (tp rank 0's where
    whole), the dp ranks' rows rank-major (rank 0's where the batch is
    replicated)."""
    if TP.size() == 1 or t.shape[dim] == whole:
        return from_ranks(t)
    g = TP.groups(t)                                   # (dp, tp, B, ..., X/tp, ...)
    if not get_ctx().shard_batch:
        g = g[:1]
    g = g.movedim(1, dim).flatten(dim, dim + 1)
    return g.flatten(0, 1)


def rank_chunks(c: torch.Tensor, r: int, dim: int, split: bool) -> torch.Tensor:
    """The inverse of ``join_ranks``: a global (B_g, ...) -> every rank's
    (R, B, ...), its dp rank's rows and, where ``split``, its tp rank's
    chunk of dim ``dim`` (of the per-rank tensor); a copy where split."""
    if not split or TP.size() == 1:
        return to_ranks(c, r)
    t = TP.size()
    g = r // t if get_ctx().shard_batch else 1
    v = c.unflatten(0, (g, c.shape[0] // g)).unflatten(dim, (t, -1)).movedim(dim, 1)
    return v.expand(r // t, *v.shape[1:]).reshape(r, *v.shape[2:])


# ------------------------------------------------------------------ dense block


def dense_block_apply(p, x: torch.Tensor, cfg: ModelConfig, *, positions, want_kv: bool):
    """Train/prefill path. x (R, B, S, D), on a physical ``model`` axis (R,
    B, S / tp, D) where the sequence splits; p one layer's gathered
    weights. Returns (x, aux metrics ({} but for MoE), (k, v) | None): at
    tp = 1 each (R*B, KV, S, hd), at tp > 1 each (R, B, KV', S, hd), every
    rank its kv heads (``layers.qkv_split``). Reference:
    ``transformer.py:53``."""
    if TP.size() > 1:
        return _dense_block_tp(p, x, cfg, positions=positions, want_kv=want_kv)
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


def attention_tp(p, h: torch.Tensor, cfg: ModelConfig, positions, *, causal: bool = True,
                 window=None, softcap=None, kv_h: torch.Tensor | None = None):
    """Attention over ``model`` (``layers.head_plan``): h (R, B, S, D), every
    position on every tp rank (k and v from ``kv_h`` where given:
    cross-attention) -> (y (R, B, S, D), k, v (R, B, S', KV', hd)): y the
    output projection's partial sums where heads split, else whole; k and v
    each rank's kv heads, or every kv head. At tp = 1 the plain block's
    attention."""
    r, b = h.shape[:2]
    q, k, v = layers.qkv_split(p, h, cfg, kv_h)
    if positions is not None:
        q = apply_positions(q, positions, cfg)
        k = apply_positions(k, positions, cfg)
    o = attn.blockwise_attention(
        q.flatten(0, 1), layers.local_kv(k, cfg).flatten(0, 1),
        layers.local_kv(v, cfg).flatten(0, 1),
        causal=causal, window=window, q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block,
        softcap=softcap)
    return layers.out_proj(p, o.unflatten(0, (r, b)), cfg), k, v


def whole_input(h: torch.Tensor, sp: bool) -> torch.Tensor:
    """A normed stream (R, B, S', D) with every position: gathered over
    ``model`` where it holds its sequence chunk (``sp``)."""
    return TP.gather(h, 2) if sp else h


def _dense_block_tp(p, x: torch.Tensor, cfg: ModelConfig, *, positions, want_kv: bool):
    """``dense_block_apply`` tensor- and sequence-parallel over ``model``;
    MoE's experts split over it (``moe.moe_apply``)."""
    sp = x.shape[2] != positions.shape[-1]   # the stream holds its sequence chunk
    h = whole_input(layers.rms_norm(x, p["ln1"], cfg.norm_eps), sp)
    y, k, v = attention_tp(p["attn"], h, cfg, positions, window=cfg.attn_window,
                           softcap=cfg.attn_logit_softcap)
    x = x + layers.to_residual(y, layers.head_plan(cfg).q_split, sp)
    h2 = whole_input(layers.rms_norm(x, p["ln2"], cfg.norm_eps), sp)
    aux = {}
    if cfg.family == "moe":
        ff, aux = moe.moe_apply(p["moe"], h2, cfg, sp=sp)
        x = x + ff
    else:
        ff = layers.mlp_apply(p["mlp"], h2, _mlp_act(cfg))
        x = x + layers.to_residual(ff, layers.mlp_partial(p["mlp"], cfg), sp)
    kv = (k.transpose(2, 3), v.transpose(2, 3)) if want_kv else None  # (R,B,KV',S,hd)
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


def seq_shards(cache_len: int) -> int:
    """How many sequence shards a decode cache of ``cache_len`` positions
    has: tp where it divides and tp > 1 (flash-decoding), else 1 (the
    reference's ``cache_pspecs`` and its condition in
    ``dense_block_decode``)."""
    t = TP.size()
    return t if t > 1 and cache_len % t == 0 else 1


def cache_view(c: torch.Tensor, r: int) -> torch.Tensor:
    """One layer's cache (B, KV, S, hd|1) -> its per-rank view (G, P, B / G,
    KV, S / P, hd|1): dp rank g's rows (G = 1 where the batch is
    replicated) and sequence shard p's positions (``seq_shards``), a view
    of the global tensor."""
    t = TP.size()
    g = r // t if get_ctx().shard_batch else 1
    p = seq_shards(c.shape[2])
    v = c.view(g, c.shape[0] // g, c.shape[1], p, c.shape[2] // p, c.shape[3])
    return v.permute(0, 3, 1, 2, 4, 5)


def _write_cache(cache: dict, k1: torch.Tensor, v1: torch.Tensor, pos: torch.Tensor):
    """Write the new rows k1/v1 (R, B, KV, hd), every kv head on every tp
    rank, at pos (R, B) into one layer's cache, quantised where it is int8,
    each row only on the shard that owns its position. Returns the cache
    to attend, (k, v) (B, KV, S, hd) (dequantised)."""
    r = k1.shape[0]
    new = {"k": k1, "v": v1}
    if "ks" in cache:
        (new["k"], new["ks"]), (new["v"], new["vs"]) = attn.quantize_kv(k1), attn.quantize_kv(v1)
    for name, rows in new.items():
        view = cache_view(cache[name], r)
        g, p = view.shape[:2]
        local = TP.groups(pos)[:g, :p] - (torch.arange(p, device=pos.device)[:, None]
                                          * view.shape[4])
        attn.cache_scatter_update(view, TP.groups(rows)[:g, :p], local)
    if "ks" in cache:
        return (attn.dequantize_kv(cache["k"], cache["ks"], k1.dtype),
                attn.dequantize_kv(cache["v"], cache["vs"], v1.dtype))
    return cache["k"], cache["v"]


def _decode_attention_tp(q: torch.Tensor, kc, vc, pos, cfg: ModelConfig) -> torch.Tensor:
    """q (R, B, H, hd), every head on every tp rank, against the caches (B,
    KV, S, hd): flash-decoding over the sequence shards where the cache's
    sequence splits over ``model``, the plain decode (tp rank 0's, expanded
    over ``model``) where it does not."""
    kw = dict(window=cfg.attn_window, softcap=cfg.attn_logit_softcap)
    r = q.shape[0]
    if seq_shards(kc.shape[2]) == 1:
        o = _decode_attention(TP.groups(q)[:, 0], kc, vc, TP.groups(pos)[:, 0], cfg)
        return o.unsqueeze(1).expand(o.shape[0], TP.size(), *o.shape[1:]).reshape(q.shape)
    qg, pg = TP.groups(q), TP.groups(pos)
    kv = [cache_view(c, r).expand(qg.shape[0], -1, -1, -1, -1, -1) for c in (kc, vc)]
    return attn.flash_decode_attention(qg, *kv, pg, **kw).reshape(q.shape)


def _decode_heads(p, h: torch.Tensor, cfg: ModelConfig, pos):
    """One decode step's q, k and v: h (R, B, 1, D) the normed stream, every
    tp rank the whole, at pos (R, B) -> q1 (R, B, H, hd), k1 and v1 (R, B,
    KV, hd), every head on every tp rank (each rank's heads gathered over
    ``model`` where they split)."""
    q, k, v = layers.qkv_split(p, h, cfg)
    q = apply_positions(q, pos[..., None], cfg)
    k = apply_positions(k, pos[..., None], cfg)
    q1, k1, v1 = q[:, :, 0], k[:, :, 0], v[:, :, 0]
    plan = layers.head_plan(cfg)
    if plan.q_split:
        q1 = TP.gather(q1, 2)
    if plan.kv_split:
        k1, v1 = TP.gather(k1, 2), TP.gather(v1, 2)
    return q1, k1, v1


def heads_out(p, o: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """A decode step's attention output o (R, B, H, hd), every head on every
    tp rank -> each rank's heads through ``wo`` (where heads split) and the
    output on the residual, (R, B, D): all-reduced where heads split."""
    plan = layers.head_plan(cfg)
    if plan.q_split:
        o = TP.chunk(o, 2)   # each tp rank's heads into wo's rows
    y = layers.out_proj(p, o[:, :, None], cfg)[:, :, 0]
    return layers.to_residual(y, plan.q_split, False)


def decode_attention_tp(p, h: torch.Tensor, cfg: ModelConfig, cache: dict, pos) -> torch.Tensor:
    """One decode step's attention over ``model``: h (R, B, 1, D) the normed
    stream, every tp rank the whole; ``cache`` one layer's {"k", "v"} (and
    int8 scales), written at pos (R, B) (``_write_cache``) and attended with
    every head (flash-decoding where the cache's sequence splits). Returns
    the output on the residual, (R, B, D) (``heads_out``)."""
    q1, k1, v1 = _decode_heads(p, h, cfg, pos)
    kc, vc = _write_cache(cache, k1, v1, pos)
    return heads_out(p, _decode_attention_tp(q1, kc, vc, pos, cfg), cfg)


def dense_block_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, pos):
    """Decode path. x (R, B, D); ``cache`` one layer's {"k", "v"} (global
    batch, KV, S, hd), with {"ks", "vs"} (.., S, 1) f32 scales where it is
    int8, updated in place; pos (R, B). Returns x. MoE routes without drops
    (reference ``transformer.py:97``)."""
    h = layers.rms_norm(x[:, :, None], p["ln1"], cfg.norm_eps)   # (R,B,1,D)
    if TP.size() == 1:
        q, k, v = layers.qkv_split(p["attn"], h, cfg)
        q = apply_positions(q, pos[..., None], cfg)
        k = apply_positions(k, pos[..., None], cfg)
        q1, k1, v1 = q[:, :, 0], k[:, :, 0], v[:, :, 0]
        if "ks" in cache:
            kc, vc = _write_cache(cache, k1, v1, pos)
        else:
            kc, vc = cache["k"], cache["v"]
            attn.cache_scatter_update(kc, from_ranks(k1), from_ranks(pos))
            attn.cache_scatter_update(vc, from_ranks(v1), from_ranks(pos))
        o = _decode_attention(q1, kc, vc, pos, cfg)
        x = x + layers.out_proj(p["attn"], o[:, :, None])[:, :, 0]
    else:
        x = x + decode_attention_tp(p["attn"], h, cfg, cache, pos)
    h2 = layers.rms_norm(x[:, :, None], p["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        ff, _ = moe.moe_apply(p["moe"], h2, cfg, no_drop=True)
        return x + ff[:, :, 0]
    ff = layers.mlp_apply(p["mlp"], h2, _mlp_act(cfg))[:, :, 0]
    return x + layers.to_residual(ff, layers.mlp_partial(p["mlp"], cfg), False)


# ----------------------------------------------------------------- LM skeleton


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                 whole: bool = False) -> torch.Tensor:
    """tokens (R, B, S) -> (R, B, S, D), each rank from its copy; on a
    physical ``model`` axis (R, B, S / tp, D) where the context runs the
    sequence in parallel, unless ``whole`` (every position on every tp
    rank). The table split over the vocabulary: each tp rank looks up the
    ids in its range (zeros elsewhere), summed over ``model`` by the
    reduce-scatter to the sequence chunks, or all-reduced. The hybrid
    family scales the rows by sqrt(d_model), as gemma does."""
    emb = plain_gather(params["embed"])                      # (W, V, D)
    ranks = torch.arange(tokens.shape[0], device=emb.device) % emb.shape[0]
    ranks = ranks.view(-1, *([1] * (tokens.dim() - 1)))
    # gemma's embedding scale, in the activations' dtype (reference :175)
    scale = (torch.tensor(math.sqrt(cfg.d_model), dtype=emb.dtype)
             if cfg.family == "hybrid" else None)
    if TP.size() == 1:
        x = emb[ranks, tokens]
        return x if scale is None else x * scale
    vl = emb.shape[1]
    sp = TP.seq_split(tokens.shape[2]) and not whole
    if vl == cfg.vocab_size:
        x = emb[ranks, tokens]
        return layers.to_residual(x if scale is None else x * scale, False, sp)
    lo = TP.rank_index(tokens.shape[0], tokens.device).view(ranks.shape) * vl
    local = tokens - lo
    inside = (local >= 0) & (local < vl)
    x = torch.where(inside[..., None], emb[ranks, local.clamp(0, vl - 1)], 0.0)
    return layers.to_residual(x if scale is None else x * scale, True, sp)


def head_matrix(params, cfg: ModelConfig) -> torch.Tensor:
    """Every rank's copy of the output head (R, D, V): the tied embedding's
    transpose (a view) or the untied head; on a physical ``model`` axis
    (R, D, V / tp) where the rules split the vocabulary."""
    if cfg.tie_embeddings:
        return plain_gather(params["embed"]).transpose(1, 2)
    return plain_gather(params["lm_head"])


def final_hidden(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    return layers.rms_norm(x, plain_gather(params["final_ln"]), cfg.norm_eps)


def lm_logits(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x (R, ..., D) -> (R, ..., V), or each tp rank's (R, ..., V / tp)
    where the head splits the vocabulary over ``model``."""
    return layers.rank_matmul(final_hidden(params, cfg, x), head_matrix(params, cfg))


def whole_logits(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``lm_logits``' output with the vocabulary gathered over ``model``
    where it is split: the serving output."""
    if logits.shape[-1] == cfg.vocab_size:
        return logits
    return TP.gather(logits, logits.dim() - 1)


def stream_len(cfg: ModelConfig, batch: dict) -> int:
    """The positions of the residual stream a batch makes: the tokens, and
    for the ``vlm`` family the patches ahead of them."""
    s = batch["tokens"].shape[1]
    return s + batch["patches"].shape[1] if cfg.family == "vlm" else s


def whole_sequence(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """The residual stream (R, B, S', D) with every position: gathered over
    ``model`` where it holds its sequence chunk."""
    return TP.gather(x, 2) if x.shape[2] != seq_len else x


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


def embed_patches(params, cfg: ModelConfig, batch, tokens: torch.Tensor) -> torch.Tensor:
    """The ``vlm`` stream: ``batch["patches"]`` (B, Np, patch_dim) projected
    through ``patch_proj`` (replicated: one copy, W = 1, on the matmul
    kernel), joined ahead of the token embeddings (R, B, Np + S, D)
    (reference ``transformer.py:262``). On a physical ``model`` axis the
    token embedding is made whole first, and the joined stream placed on
    ``model`` by its own length."""
    x = embed_tokens(params, cfg, tokens, whole=True)
    patches = to_ranks(batch["patches"], tokens.shape[0]).to(x.dtype)
    proj = layers.rank_matmul(patches, params["patch_proj"].local[:1])
    x = torch.cat([proj, x], dim=2)
    return layers.to_residual(x, False, TP.seq_split(x.shape[2]))


def dense_forward(params, cfg: ModelConfig, batch, *, want_cache=False, remat="none"):
    """batch: tokens (B, S) [+ patches (B, Np, patch_dim) for ``vlm``, ahead
    of the tokens]. Returns (hidden (R, B/dp, S', D) or, replicated, (R, B,
    S', D), S' = the stream's positions (``stream_len``), / tp where the
    sequence runs in parallel; aux metrics ({} but for MoE); cache | None);
    the cache is {"k", "v"} of (L, B, KV, S', hd), int8 with {"ks", "vs"}
    (L, B, KV, S', 1) f32 scales where ``kv_cache_dtype`` is "int8"."""
    tokens = to_ranks(batch["tokens"], n_ranks(params))
    if cfg.family == "vlm":
        x = embed_patches(params, cfg, batch, tokens)
    else:
        x = embed_tokens(params, cfg, tokens)
    positions = torch.arange(stream_len(cfg, batch), device=x.device)[None, :]
    x, aux, kvs = _scan_blocks(params, cfg, x, positions, want_kv=want_cache, remat=remat)
    cache = None
    if want_cache:
        cache = {name: torch.stack([_global_kv(kv[j], cfg, x.shape[:2]) for kv in kvs])
                 for j, name in enumerate(("k", "v"))}
        if cfg.kv_cache_dtype == "int8":
            (cache["k"], cache["ks"]), (cache["v"], cache["vs"]) = (
                attn.quantize_kv(cache["k"]), attn.quantize_kv(cache["v"]))
    return x, aux, cache


def _global_kv(kv: torch.Tensor, cfg: ModelConfig, rb: tuple[int, int]) -> torch.Tensor:
    """A layer's k or v from ``dense_block_apply`` -> (B, KV, S, hd) of the
    global batch: at tp > 1 each tp rank's kv heads joined (where they
    split over ``model``; else tp rank 0's, every head), the head-split
    layout of prefill made the cache's global one, which decode reads by
    sequence shards (``cache_view``)."""
    if TP.size() == 1:
        return from_ranks(kv.unflatten(0, rb))
    return join_ranks(kv, 2, cfg.num_kv_heads)


def dense_decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token (B,), pos (B,). Returns (logits (B, V), cache updated in place)."""
    r = n_ranks(params)
    x = embed_tokens(params, cfg, to_ranks(token[:, None], r))[:, :, 0]   # (R,B,D)
    pos_r = to_ranks(pos, r)
    for i in range(cfg.num_layers):
        bp = maybe_gather_params(layer_slice(params["blocks"], i))
        x = dense_block_decode(bp, x, cfg, {n: c[i] for n, c in cache.items()}, pos_r)
    logits = lm_logits(params, cfg, x[:, :, None])[:, :, 0]
    return from_ranks(whole_logits(logits, cfg)), cache


def dense_init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    shp = (cfg.num_layers, batch, cfg.num_kv_heads, seq_len, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        sshp = shp[:-1] + (1,)
        return {"k": torch.zeros(shp, dtype=torch.int8, device=device),
                "v": torch.zeros(shp, dtype=torch.int8, device=device),
                "ks": torch.zeros(sshp, dtype=torch.float32, device=device),
                "vs": torch.zeros(sshp, dtype=torch.float32, device=device)}
    if cfg.kv_cache_dtype != "bf16":
        raise NotImplementedError(f"kv_cache_dtype {cfg.kv_cache_dtype!r} is not ported")
    return {"k": torch.zeros(shp, dtype=dtype, device=device),
            "v": torch.zeros(shp, dtype=dtype, device=device)}


# ------------------------------------------------- rwkv and hybrid families


def _remat_full(body, remat: str):
    """The reference checkpoints an rwkv or hybrid layer only for
    remat="full"; every other policy ("dots" too) runs the plain body
    (reference ``transformer.py:338``, ``:446``, ``:456``)."""
    check_remat(remat)
    return _remat(body, "full") if remat == "full" else body


def _state_dims(cfg: ModelConfig) -> dict[str, int]:
    """The recurrent states that ``cache_pspecs`` splits over ``model`` and
    the model code holds split, each by its dim in a per-rank (R, B, ...)
    state: rwkv's ``wkv`` by heads where they split, the hybrid's ``h`` and
    ``conv`` by channels where the LRU width splits."""
    if cfg.family == "rwkv":
        return {"wkv": 2} if rwkv.heads_split(cfg) else {}
    return {"h": 2, "conv": 3} if rglru.width_split(cfg) else {}


def _stack_states(states: list[dict], cfg: ModelConfig) -> dict:
    """Per-layer states {name: (R, B, ...)} -> {name: (L, B, ...)} of the
    global batch, the tp ranks' chunks joined where they split."""
    dims = _state_dims(cfg)
    return {name: torch.stack([join_ranks(st[name], dims[name], -1) if name in dims
                               else from_ranks(st[name]) for st in states])
            for name in states[0]}


def _rank_states(cache: dict, i: int, cfg: ModelConfig, r: int) -> dict:
    """Layer i's states of a global cache {name: (L, B, ...)} -> every
    rank's {name: (R, B, ...)}: its rows, and its chunk where they split."""
    dims = _state_dims(cfg)
    return {name: rank_chunks(c[i], r, dims.get(name, 0), name in dims)
            for name, c in cache.items()}


def _write_states(cache: dict, i: int, new: dict, cfg: ModelConfig) -> None:
    """Every rank's new states written into layer i of the global cache."""
    dims = _state_dims(cfg)
    for name, c in cache.items():
        c[i].copy_(join_ranks(new[name], dims[name], -1) if name in dims
                   else from_ranks(new[name]))


def rwkv_forward(params, cfg: ModelConfig, batch, *, want_cache=False, remat="none"):
    """RWKV6 stack: each layer gathered, then the block with the chunked WKV
    (reference ``transformer.py:330``). Returns (hidden (R, B/dp, S, D), on
    a physical ``model`` axis (R, B/dp, S / tp, D) where the sequence
    splits; {}; cache | None); the cache {wkv (L, B, H, K, V) f32, tm_x (L,
    B, D), cm_x (L, B, D)} holds no sequence. No prefetch: the reference's
    ``prefetch_params`` reaches only the dense stack."""
    tokens = to_ranks(batch["tokens"], n_ranks(params))
    x = embed_tokens(params, cfg, tokens)
    sp = x.shape[2] != tokens.shape[2]
    ctx = get_ctx()

    def body(x, layer):
        with use_ctx(ctx):
            bp = maybe_gather_params(layer)
            return rwkv.rwkv_block_apply(bp, x, cfg, state=None, chunked=True, sp=sp)

    fn = _remat_full(body, remat)
    states = []
    for i in range(cfg.num_layers):
        x, st = fn(x, layer_slice(params["blocks"], i))
        if want_cache:
            states.append(st)
    return x, {}, (_stack_states(states, cfg) if want_cache else None)


def rwkv_decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token (B,), pos (B,). Returns (logits (B, V), cache updated in place):
    the recurrent WKV step a layer, each layer by the context's gather."""
    r = n_ranks(params)
    x = embed_tokens(params, cfg, to_ranks(token[:, None], r))          # (R,B,1,D)
    for i in range(cfg.num_layers):
        bp = maybe_gather_params(layer_slice(params["blocks"], i))
        x, new = rwkv.rwkv_block_apply(bp, x, cfg, state=_rank_states(cache, i, cfg, r),
                                       chunked=False)
        _write_states(cache, i, new, cfg)
    logits = lm_logits(params, cfg, x)[:, :, 0]
    return from_ranks(whole_logits(logits, cfg)), cache


def rwkv_init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    h, hd, d = cfg.num_heads, cfg.head_dim, cfg.d_model
    return {"wkv": torch.zeros((cfg.num_layers, batch, h, hd, hd), dtype=torch.float32,
                               device=device),
            "tm_x": torch.zeros((cfg.num_layers, batch, d), dtype=dtype, device=device),
            "cm_x": torch.zeros((cfg.num_layers, batch, d), dtype=dtype, device=device)}


HYBRID_GROUP = ("grp_rec_a", "grp_rec_b", "grp_attn")


def hybrid_layout(cfg: ModelConfig) -> tuple[int, int]:
    """(groups of the repeating pattern, trailing rec layers). The tree's
    ``tail_rec`` stacks max(trailing, 1) layers: at a depth that is a
    multiple of the pattern one layer that no pass applies (reference
    ``transformer.py:406``)."""
    plen = len(cfg.rglru.pattern)
    return cfg.num_layers // plen, cfg.num_layers % plen


def _hybrid_rec_apply(p, x: torch.Tensor, cfg: ModelConfig, state, sp: bool = False):
    """A rec layer: the recurrent block, then the SwiGLU MLP (SwiGLU whatever
    ``cfg.act`` says, as the reference builds it); on a physical ``model``
    axis both tensor-parallel, the stream's sequence split where ``sp``."""
    x, st = rglru.rec_block_apply(p["rec"], x, cfg, state=state, sp=sp)
    h = whole_input(layers.rms_norm(x, p["ln2"], cfg.norm_eps), sp)
    ff = layers.mlp_apply(p["mlp"], h, "swiglu")
    return x + layers.to_residual(ff, layers.mlp_partial(p["mlp"], cfg), sp), st


def _hybrid_attn_apply(p, x: torch.Tensor, cfg: ModelConfig, positions, want_kv: bool,
                       sp: bool = False):
    """A local-attention layer (window ``cfg.rglru.window``) and its SwiGLU
    MLP. Returns (x, (k, v) | None), each (R, B, KV', S, hd), every rank its
    kv heads (``attention_tp``)."""
    h = whole_input(layers.rms_norm(x, p["ln1"], cfg.norm_eps), sp)
    y, k, v = attention_tp(p["attn"], h, cfg, positions, window=cfg.rglru.window)
    x = x + layers.to_residual(y, layers.head_plan(cfg).q_split, sp)
    kv = (k.transpose(2, 3), v.transpose(2, 3)) if want_kv else None
    h2 = whole_input(layers.rms_norm(x, p["ln2"], cfg.norm_eps), sp)
    ff = layers.mlp_apply(p["mlp"], h2, "swiglu")
    return x + layers.to_residual(ff, layers.mlp_partial(p["mlp"], cfg), sp), kv


def _group(params, g: int) -> dict:
    return {name: layer_slice(params[name], g) for name in HYBRID_GROUP}


def hybrid_forward(params, cfg: ModelConfig, batch, *, want_cache=False, remat="none"):
    """RecurrentGemma stack (reference ``transformer.py:422``): each group
    (rec, rec, attn) gathered whole, then its three layers; then each
    trailing rec layer gathered and applied. Returns (hidden, {}, cache |
    None); the cache {rec_a, rec_b: {h (G, B, W) f32, conv (G, B, K-1, W)},
    attn_k, attn_v (G, B, KV, min(S, window), hd) (the prompt's last
    positions in order), tail: the trailing layers' states or None}. On a
    physical ``model`` axis the LRU width, the heads and the MLP split over
    it, and the stream's sequence where it divides. No prefetch (dense
    stack only)."""
    tokens = to_ranks(batch["tokens"], n_ranks(params))
    x = embed_tokens(params, cfg, tokens)
    sp = x.shape[2] != tokens.shape[2]
    positions = torch.arange(tokens.shape[2], device=x.device)[None, :]
    ng, nt = hybrid_layout(cfg)
    ctx = get_ctx()

    def body(x, group):
        with use_ctx(ctx):
            gp = maybe_gather_params(group)
            x, st_a = _hybrid_rec_apply(gp["grp_rec_a"], x, cfg, None, sp)
            x, st_b = _hybrid_rec_apply(gp["grp_rec_b"], x, cfg, None, sp)
            x, kv = _hybrid_attn_apply(gp["grp_attn"], x, cfg, positions, want_cache, sp)
            return x, st_a, st_b, kv

    def tail(x, layer):
        with use_ctx(ctx):
            return _hybrid_rec_apply(maybe_gather_params(layer), x, cfg, None, sp)

    fn, tfn = _remat_full(body, remat), _remat_full(tail, remat)
    groups, tails = [], []
    for g in range(ng):
        x, st_a, st_b, kv = fn(x, _group(params, g))
        if want_cache:
            groups.append((st_a, st_b, kv))
    for t in range(nt):
        x, st = tfn(x, layer_slice(params["tail_rec"], t))
        if want_cache:
            tails.append(st)
    cache = None
    if want_cache:
        kvs = [torch.stack([join_ranks(grp[2][j], 2, cfg.num_kv_heads) for grp in groups])
               for j in range(2)]
        cache = {"rec_a": _stack_states([grp[0] for grp in groups], cfg),
                 "rec_b": _stack_states([grp[1] for grp in groups], cfg),
                 "attn_k": window_clip(kvs[0], cfg), "attn_v": window_clip(kvs[1], cfg),
                 "tail": _stack_states(tails, cfg) if nt else None}
    return x, {}, cache


def window_clip(kv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The last ``cfg.rglru.window`` positions of a prefill's (G, B, KV, S,
    hd) keys or values (reference ``_window_clip``)."""
    w, s = cfg.rglru.window, kv.shape[3]
    return kv[:, :, :, s - w:] if s > w else kv


def _ring_attention(q: torch.Tensor, kc, vc, pos, cfg: ModelConfig) -> torch.Tensor:
    """q (R, B, H, hd), pos (R, B) against the ring caches (global batch, KV,
    W, hd): slot s holds the largest position p' <= pos with p' % W == s.
    Returns (R, B, H, hd); a replicated batch's rank 0 attended once. On a
    physical ``model`` axis every tp rank holds every head: tp rank 0's
    queries are attended and the result expanded over ``model``."""
    w = kc.shape[2]

    def one(q, pos):
        idx = torch.arange(w, device=pos.device)
        abs_pos = pos[:, None] - ((pos[:, None] - idx[None, :]) % w)
        return attn.ring_decode_attention(q, kc, vc, abs_pos, pos, cfg.rglru.window)

    t = TP.size()
    qg, pg = (TP.groups(q)[:, 0], TP.groups(pos)[:, 0]) if t > 1 else (q, pos)
    if get_ctx().shard_batch:
        o = one(qg.flatten(0, 1), pg.flatten()).unflatten(0, qg.shape[:2])
    else:
        o = one(qg[0], pg[0])
        o = o.expand(qg.shape[0], *o.shape)
    if t > 1:
        o = o.unsqueeze(1).expand(o.shape[0], t, *o.shape[1:]).reshape(q.shape)
    return o


def hybrid_decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token (B,), pos (B,). Returns (logits (B, V), cache updated in place):
    each group gathered whole by the context's gather, each rec layer one
    RG-LRU step, each attention layer a write at slot pos % W of its ring
    and ``ring_decode_attention`` (reference ``transformer.py:475``). On a
    physical ``model`` axis the rec states are each rank's channels and
    the attention runs with every head (``_ring_attention``)."""
    r = n_ranks(params)
    x = embed_tokens(params, cfg, to_ranks(token[:, None], r))          # (R,B,1,D)
    pos_r = to_ranks(pos, r)
    ng, nt = hybrid_layout(cfg)

    def rec_step(x, p, states: dict, i: int):
        x, new = _hybrid_rec_apply(p, x, cfg, _rank_states(states, i, cfg, r))
        _write_states(states, i, new, cfg)
        return x

    def attn_step(x, p, kc, vc):
        h = layers.rms_norm(x, p["ln1"], cfg.norm_eps)
        q1, k1, v1 = _decode_heads(p["attn"], h, cfg, pos_r)
        slot = pos % kc.shape[2]
        attn.cache_scatter_update(kc, from_ranks(k1), slot)
        attn.cache_scatter_update(vc, from_ranks(v1), slot)
        x = x + heads_out(p["attn"], _ring_attention(q1, kc, vc, pos_r, cfg), cfg)[:, :, None]
        h2 = layers.rms_norm(x, p["ln2"], cfg.norm_eps)
        ff = layers.mlp_apply(p["mlp"], h2, "swiglu")
        return x + layers.to_residual(ff, layers.mlp_partial(p["mlp"], cfg), False)

    for g in range(ng):
        gp = maybe_gather_params(_group(params, g))
        x = rec_step(x, gp["grp_rec_a"], cache["rec_a"], g)
        x = rec_step(x, gp["grp_rec_b"], cache["rec_b"], g)
        x = attn_step(x, gp["grp_attn"], cache["attn_k"][g], cache["attn_v"][g])
    for t in range(nt):
        x = rec_step(x, maybe_gather_params(layer_slice(params["tail_rec"], t)),
                     cache["tail"], t)
    logits = lm_logits(params, cfg, x)[:, :, 0]
    return from_ranks(whole_logits(logits, cfg)), cache


def hybrid_init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    """The decode cache: ring buffers of min(window, seq_len) slots."""
    ng, nt = hybrid_layout(cfg)
    w = min(cfg.rglru.window, seq_len)
    lru, kcw = cfg.rglru.lru_width, cfg.rglru.conv_width - 1

    def rec_state(n):
        return {"h": torch.zeros((n, batch, lru), dtype=torch.float32, device=device),
                "conv": torch.zeros((n, batch, kcw, lru), dtype=dtype, device=device)}

    kv = (ng, batch, cfg.num_kv_heads, w, cfg.head_dim)
    return {"rec_a": rec_state(ng), "rec_b": rec_state(ng),
            "attn_k": torch.zeros(kv, dtype=dtype, device=device),
            "attn_v": torch.zeros(kv, dtype=dtype, device=device),
            "tail": rec_state(max(nt, 1))}


def decode_cache(cfg: ModelConfig, pre: dict, prompt_len: int, cache_len: int) -> dict:
    """The prefill's cache made the decode cache of ``cache_len`` positions;
    ``prompt_len`` is the prefill's stream length (``stream_len``: the
    patches too for ``vlm``). Dense, MoE and VLM: every (L, B, KV, S, .)
    entry padded along the sequence. Encdec: the self-attention's k and v
    padded, the cross-attention's xk and xv as they are (decode reads every
    S_enc row). RWKV: the states as they are. Hybrid: the rec states as
    they are (zero trailing states where the depth has none), and each
    attention layer's last min(S, window) prompt positions written into
    the ring of min(window, cache_len) slots, position p at slot p % slots."""
    def pad(v):
        return torch.nn.functional.pad(v, (0, 0, 0, cache_len - prompt_len))

    if cfg.family in ("dense", "moe", "vlm"):
        return {k: pad(v) for k, v in pre.items()}
    if cfg.family == "encdec":
        return {k: pad(v) if k in ("k", "v") else v for k, v in pre.items()}
    if cfg.family == "rwkv":
        return pre
    k = pre["attn_k"]
    b = k.shape[1]
    ring = hybrid_init_cache(cfg, b, cache_len, k.dtype, k.device)
    m, slots = k.shape[3], ring["attn_k"].shape[3]
    where = torch.arange(prompt_len - m, prompt_len, device=k.device) % slots
    for name in ("attn_k", "attn_v"):
        ring[name][:, :, :, where] = pre[name]
    out = dict(pre, attn_k=ring["attn_k"], attn_v=ring["attn_v"])
    if out["tail"] is None:
        out["tail"] = ring["tail"]
    return out
