"""Model API of the port (dense family), counterpart of
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
    summed and divided by the global count of unmasked tokens."""
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
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported; only dense")
    transformer.check_remat(remat)
    dev = device_of(device)
    dt = layers.dtype_of(cfg.param_dtype)

    def forward_fn(params, batch):
        x, _ = transformer.dense_forward(params, cfg, batch, remat=remat)
        return transformer.final_hidden(params, cfg, x).flatten(0, 1)

    def loss_fn(params, batch):
        x, _ = transformer.dense_forward(params, cfg, batch, remat=remat)
        x = transformer.final_hidden(params, cfg, x)
        targets = transformer.to_ranks(batch["targets"], transformer.n_ranks(params))
        loss = chunked_xent(x, transformer.head_matrix(params, cfg), targets)
        return loss, {"xent": loss}

    def prefill_fn(params, batch):
        x, cache = transformer.dense_forward(params, cfg, batch, want_cache=True,
                                             remat=remat)
        logits = transformer.lm_logits(params, cfg, x[:, :, -1:])[:, :, 0]
        return logits.flatten(0, 1), cache

    def decode_fn(params, cache, token, pos):
        return transformer.dense_decode_step(params, cfg, cache, token, pos)

    def init_cache(batch, seq):
        return transformer.dense_init_cache(cfg, batch, seq, dt, dev)

    return ModelApi(cfg, loss_fn, forward_fn, prefill_fn, decode_fn, init_cache)


def batch_dims(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, tuple]:
    """Shapes (no data) of every input of a (dense cfg, shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": (b, s), "targets": (b, s)}
    if shape.kind == "prefill":
        return {"tokens": (b, s)}
    return {"token": (b,), "pos": (b,)}
