"""Model API of the port (dense, moe, vlm, rwkv, hybrid and encdec
families), counterpart of ``repro.models.model_builder``:

    api = build_model(cfg, remat="full", device="cuda")
    loss, metrics = api.loss_fn(params, batch)             # train shapes
    logits, cache = api.prefill_fn(params, batch)          # last-position logits
    logits, cache = api.decode_fn(params, cache, tok, pos) # one decode step
    hidden = api.forward_fn(params, batch)                 # final hidden (B,S,D)

``params`` is the tree of ``Stacked`` leaves that ``repro_torch.bridge``
makes. The functions run under the ``ShardCtx`` that the train and serve
steps install.

The loss head is chunked cross-entropy: a loop over sequence chunks whose
body is checkpointed, so the (B, S, V) logits never exist in f32 at once,
as in the reference.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import device_of
from repro_torch.models import encdec, layers, rglru, rwkv, transformer
from repro_torch.sharding import tp as TP

XENT_CHUNK = 512
FAMILIES = ("dense", "moe", "vlm", "rwkv", "hybrid", "encdec")


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameter count from the config alone, the reference's
    arithmetic (``repro.models.model_builder.count_params_analytic``). With
    ``active_only`` an MoE layer counts its ``top_k`` routed experts in
    place of all of them, its shared experts and its full router (the
    reference's ``moe.moe_param_count``); any other count is the same. As
    the reference's, no count holds the final norm nor a dense block's
    norms; the rwkv count holds each block's norms; the hybrid's counts no
    norm outside the rec block, five vectors of lru_width a rec block (the
    block has four) and no unused ``tail_rec`` layer; ``vlm`` adds
    ``patch_proj``; ``encdec`` is ``encdec.encdec_param_count``."""
    if cfg.family == "encdec":
        return encdec.encdec_param_count(cfg)
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = d * h * hd * 2 + d * kvh * hd * 2
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "rwkv":
        return cfg.num_layers * rwkv.rwkv_block_param_count(cfg) + embed
    if cfg.family == "hybrid":
        ng, nt = transformer.hybrid_layout(cfg)
        mlp = 3 * d * cfg.d_ff
        rec = rglru.rec_block_param_count(cfg) + mlp
        return ng * (2 * rec + attn + mlp) + nt * rec + embed
    if cfg.family in ("dense", "vlm"):
        per = attn + d * cfg.d_ff * (3 if cfg.act == "swiglu" else 2)
        if cfg.family == "vlm":
            return cfg.num_layers * per + embed + cfg.vision.patch_dim * d
    else:
        m = cfg.moe
        n_routed = m.top_k if active_only else m.n_routed_experts
        per = (attn + n_routed * 3 * d * m.d_ff_expert
               + 3 * d * m.d_ff_expert * m.n_shared_experts + d * m.n_routed_experts)
    return cfg.num_layers * per + embed


def _xent_chunk(h: torch.Tensor, t: torch.Tensor, head: torch.Tensor, vocab: int):
    """h (R, b, c, D), t (R, b, c), head (R, D, V) -> (sum of NLL, count).
    On a physical ``model`` axis head is each tp rank's (R, D, V / tp) where
    the vocabulary splits: the log-sum-exp is combined over ``model`` from
    each rank's, and the target's logit taken from the rank whose range
    holds it; where it does not split, tp rank 0's. Summed over the dp
    ranks only (each tp group holds its rows once)."""
    logits = layers.rank_matmul(h, head).float()
    mask = (t >= 0).float()
    tt = t.clamp(min=0)
    if TP.size() == 1:
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, tt[..., None], dim=-1)[..., 0]
        return torch.sum((lse - gold) * mask), torch.sum(mask)
    vl = logits.shape[-1]
    lse = TP.groups(torch.logsumexp(logits, dim=-1))
    if vl == vocab:
        gold = torch.take_along_dim(logits, tt[..., None], dim=-1)[..., 0]
        lse, gold = lse[:, 0], TP.groups(gold)[:, 0]
    else:
        local = tt - (TP.rank_index(t.shape[0], t.device) * vl).view(-1, 1, 1)
        inside = (local >= 0) & (local < vl)
        gold = torch.take_along_dim(logits, local.clamp(0, vl - 1)[..., None], dim=-1)[..., 0]
        lse = torch.logsumexp(lse, dim=1)
        gold = TP.groups(torch.where(inside, gold, 0.0)).sum(1)
    mask = TP.groups(mask)[:, 0]
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def chunked_xent(hidden: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                 chunk: int = XENT_CHUNK, vocab: int | None = None) -> torch.Tensor:
    """Token-mean cross-entropy over the global batch without materialising
    full-sequence f32 logits. hidden (R, B/dp, S, D); head (R, D, V), every
    rank's copy (on a physical ``model`` axis its vocabulary split, of the
    ``vocab`` ids); targets (R, B/dp, S), -1 = masked out. Every dp rank's
    NLL is summed and divided by the count of unmasked tokens over every dp
    rank. With a replicated batch (R, B, S) that is the mean over the dp
    copies: each copy's gradient is 1/dp of the batch's, and the gathers'
    transposes sum them into the shards."""
    vocab = vocab or head.shape[-1]
    s = hidden.shape[2]
    tot = hidden.new_zeros((), dtype=torch.float32)
    cnt = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, s, min(chunk, s)):
        hi = min(lo + chunk, s)
        nll, n = checkpoint(_xent_chunk, hidden[:, :, lo:hi], targets[:, :, lo:hi], head, vocab,
                            use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + nll, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


@dataclass
class ModelApi:
    cfg: ModelConfig
    loss_fn: Callable              # (params, batch) -> (loss, metrics)
    forward_fn: Callable           # (params, batch) -> hidden (B,S,D)
    prefill_fn: Callable           # (params, batch) -> (last_logits, cache)
    decode_fn: Callable            # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable           # (batch, seq) -> cache dict (zeros)


def build_model(cfg: ModelConfig, remat: str = "none", *,
                device: str | torch.device = "cuda") -> ModelApi:
    """remat: "none", "full" (checkpoint each layer's gather and block) or
    "dots" (the same, keeping every product's output; the rwkv, hybrid and
    encdec stacks run it as "none", as the reference does); any other
    raises ValueError. The forward, decode and cache functions are the
    family's (reference ``model_builder.py:108``, ``:131``); the encdec's
    head is its untied ``lm_head``, as every untied head."""
    transformer.check_remat(remat)
    dev = device_of(device)
    dt = layers.dtype_of(cfg.param_dtype)
    dense = (transformer.dense_forward, transformer.dense_decode_step,
             transformer.dense_init_cache)
    fwd, dec, cache_init = {
        "dense": dense, "moe": dense, "vlm": dense,
        "rwkv": (transformer.rwkv_forward, transformer.rwkv_decode_step,
                 transformer.rwkv_init_cache),
        "hybrid": (transformer.hybrid_forward, transformer.hybrid_decode_step,
                   transformer.hybrid_init_cache),
        "encdec": (encdec.encdec_forward, encdec.encdec_decode_step,
                   encdec.encdec_init_cache),
    }[cfg.family]

    def forward_fn(params, batch):
        x, _, _ = fwd(params, cfg, batch, remat=remat)
        x = transformer.whole_sequence(x, transformer.stream_len(cfg, batch))
        return transformer.from_ranks(transformer.final_hidden(params, cfg, x))

    def loss_fn(params, batch):
        """Token-mean cross-entropy; MoE adds its router losses and reports
        the three ``moe_*`` metrics (reference ``model_builder.py:166``)."""
        x, aux, _ = fwd(params, cfg, batch, remat=remat)
        x = transformer.final_hidden(params, cfg, x)
        x = transformer.whole_sequence(x, transformer.stream_len(cfg, batch))
        targets = transformer.to_ranks(batch["targets"], transformer.n_ranks(params))
        loss = chunked_xent(x, transformer.head_matrix(params, cfg), targets,
                            vocab=cfg.vocab_size)
        metrics = {"xent": loss}
        if cfg.family == "moe":
            loss = loss + aux["moe_aux"] + aux["moe_zloss"]
            metrics.update(aux)
        return loss, metrics

    def prefill_fn(params, batch):
        x, _, cache = fwd(params, cfg, batch, want_cache=True, remat=remat)
        x = transformer.whole_sequence(x, transformer.stream_len(cfg, batch))
        logits = transformer.lm_logits(params, cfg, x[:, :, -1:])[:, :, 0]
        return transformer.from_ranks(transformer.whole_logits(logits, cfg)), cache

    def decode_fn(params, cache, token, pos):
        return dec(params, cfg, cache, token, pos)

    def init_cache(batch, seq):
        return cache_init(cfg, batch, seq, dt, dev)

    return ModelApi(cfg, loss_fn, forward_fn, prefill_fn, decode_fn, init_cache)


def batch_dims(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, tuple]:
    """Shapes (no data) of every input of a (cfg, shape) cell: tokens,
    targets, or a decode step's token and position; ``encdec`` adds the
    frames (B, S, frame_dim), ``vlm`` the patches (B, n_patches,
    patch_dim), its tokens then S - n_patches (reference
    ``model_builder.py:197``)."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"token": (b,), "pos": (b,)}
    out = {}
    if cfg.family == "encdec":
        out = {"frames": (b, s, cfg.encdec.frame_dim), "tokens": (b, s)}
    elif cfg.family == "vlm":
        np_ = cfg.vision.n_patches
        out = {"patches": (b, np_, cfg.vision.patch_dim), "tokens": (b, s - np_)}
    else:
        out = {"tokens": (b, s)}
    if shape.kind == "train":
        out["targets"] = (b, s)
    return out


def make_dummy_batch(cfg: ModelConfig, shape: ShapeConfig, gen: torch.Generator, *,
                     device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Random inputs of every name of ``batch_dims``: token ids uniform in
    [0, vocab) (int64), decode positions 0, frames and patches N(0, 1) x
    0.02 in the compute dtype; ``vlm``'s targets -1 over the patches (no
    loss there). Drawn in name order from the ``torch.Generator`` ``gen``
    on its own device, then moved to ``device``. The numbers are not those
    of the reference's ``make_dummy_batch``, which draws from
    ``jax.random`` keys; only their shapes, ranges and dtype classes
    agree."""
    dev = device_of(device)
    out = {}
    for name, shp in batch_dims(cfg, shape).items():
        if name == "pos":
            out[name] = torch.zeros(shp, dtype=torch.long, device=dev)
        elif name in ("frames", "patches"):
            x = torch.randn(shp, generator=gen, device=gen.device) * 0.02
            out[name] = x.to(device=dev, dtype=layers.dtype_of(cfg.compute_dtype))
        else:
            out[name] = torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                      device=gen.device).to(dev)
    if cfg.family == "vlm" and "targets" in out:
        out["targets"][:, :cfg.vision.n_patches] = -1
    return out
