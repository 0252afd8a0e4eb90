"""Model API of the port (dense and moe families), counterpart of
``repro.models.model_builder``:

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
from repro_torch.models import layers, transformer

XENT_CHUNK = 512
FAMILIES = ("dense", "moe")


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """The parameter count from the config alone, the reference's
    arithmetic (``repro.models.model_builder.count_params_analytic``) for
    the families the port has; the others raise, queued in ROADMAP.md §1,
    item 12. With ``active_only`` an MoE layer counts its ``top_k`` routed
    experts in place of all of them, its shared experts and its full router
    (the reference's ``moe.moe_param_count``); a dense count is the same."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported (ROADMAP.md §1, "
                                  f"item 12); only {FAMILIES}")
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    attn = d * h * hd * 2 + d * kvh * hd * 2
    embed = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    if cfg.family == "dense":
        per = attn + d * cfg.d_ff * (3 if cfg.act == "swiglu" else 2)
    else:
        m = cfg.moe
        n_routed = m.top_k if active_only else m.n_routed_experts
        per = (attn + n_routed * 3 * d * m.d_ff_expert
               + 3 * d * m.d_ff_expert * m.n_shared_experts + d * m.n_routed_experts)
    return cfg.num_layers * per + embed


def _xent_chunk(h: torch.Tensor, t: torch.Tensor, head: torch.Tensor):
    """h (R, b, c, D), t (R, b, c), head (R, D, V) -> (sum of NLL, count)."""
    logits = layers.rank_matmul(h, head).float()
    mask = (t >= 0).float()
    tt = t.clamp(min=0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, tt[..., None], dim=-1)[..., 0]
    return torch.sum((lse - gold) * mask), torch.sum(mask)


def chunked_xent(hidden: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                 chunk: int = XENT_CHUNK) -> torch.Tensor:
    """Token-mean cross-entropy over the global batch without materialising
    full-sequence f32 logits. hidden (R, B/R, S, D); head (R, D, V), every
    rank's copy; targets (R, B/R, S), -1 = masked out. Every rank's NLL is
    summed and divided by the count of unmasked tokens over every rank. With
    a replicated batch (R, B, S) that is the mean over the R copies: each
    copy's gradient is 1/R of the batch's, and the gathers' transposes sum
    the R of them into the shards."""
    s = hidden.shape[2]
    tot = hidden.new_zeros((), dtype=torch.float32)
    cnt = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, s, min(chunk, s)):
        hi = min(lo + chunk, s)
        nll, n = checkpoint(_xent_chunk, hidden[:, :, lo:hi], targets[:, :, lo:hi], head,
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
    "dots" (the same, keeping every product's output); any other raises
    ValueError."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported; only {FAMILIES}")
    transformer.check_remat(remat)
    dev = device_of(device)
    dt = layers.dtype_of(cfg.param_dtype)

    def forward_fn(params, batch):
        x, _, _ = transformer.dense_forward(params, cfg, batch, remat=remat)
        return transformer.from_ranks(transformer.final_hidden(params, cfg, x))

    def loss_fn(params, batch):
        """Token-mean cross-entropy; MoE adds its router losses and reports
        the three ``moe_*`` metrics (reference ``model_builder.py:166``)."""
        x, aux, _ = transformer.dense_forward(params, cfg, batch, remat=remat)
        x = transformer.final_hidden(params, cfg, x)
        targets = transformer.to_ranks(batch["targets"], transformer.n_ranks(params))
        loss = chunked_xent(x, transformer.head_matrix(params, cfg), targets)
        metrics = {"xent": loss}
        if cfg.family == "moe":
            loss = loss + aux["moe_aux"] + aux["moe_zloss"]
            metrics.update(aux)
        return loss, metrics

    def prefill_fn(params, batch):
        x, _, cache = transformer.dense_forward(params, cfg, batch, want_cache=True,
                                                remat=remat)
        logits = transformer.lm_logits(params, cfg, x[:, :, -1:])[:, :, 0]
        return transformer.from_ranks(logits), cache

    def decode_fn(params, cache, token, pos):
        return transformer.dense_decode_step(params, cfg, cache, token, pos)

    def init_cache(batch, seq):
        return transformer.dense_init_cache(cfg, batch, seq, dt, dev)

    return ModelApi(cfg, loss_fn, forward_fn, prefill_fn, decode_fn, init_cache)


def batch_dims(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, tuple]:
    """Shapes (no data) of every input of a (dense or moe cfg, shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": (b, s), "targets": (b, s)}
    if shape.kind == "prefill":
        return {"tokens": (b, s)}
    return {"token": (b,), "pos": (b,)}


def make_dummy_batch(cfg: ModelConfig, shape: ShapeConfig, gen: torch.Generator, *,
                     device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """Random inputs of every name of ``batch_dims``: token ids uniform in
    [0, vocab) (int64), decode positions 0. Drawn in name order from the
    ``torch.Generator`` ``gen`` on its own device, then moved to ``device``.
    The ids are not those of the reference's ``make_dummy_batch``, which
    draws from ``jax.random`` keys; only their shapes, range and dtype
    class (integer ids) agree."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(f"family {cfg.family!r} is not ported; only {FAMILIES}")
    dev = device_of(device)
    out = {}
    for name, shp in batch_dims(cfg, shape).items():
        if name == "pos":
            out[name] = torch.zeros(shp, dtype=torch.long, device=dev)
        else:
            out[name] = torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                      device=gen.device).to(dev)
    return out
