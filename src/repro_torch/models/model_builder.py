"""Model API of the port (dense family), counterpart of
``repro.models.model_builder``:

    api = build_model(cfg, device="cuda")
    logits, cache = api.prefill_fn(params, batch)          # last-position logits
    logits, cache = api.decode_fn(params, cache, tok, pos) # one decode step
    hidden = api.forward_fn(params, batch)                 # final hidden (B,S,D)

``params`` is the tree of ``Stacked`` leaves that ``repro_torch.bridge``
makes. The functions run under the ``ShardCtx`` that the serve steps install.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import layers, transformer


@dataclass
class ModelApi:
    cfg: ModelConfig
    forward_fn: Callable           # (params, batch) -> hidden (B,S,D)
    prefill_fn: Callable           # (params, batch) -> (last_logits, cache)
    decode_fn: Callable            # (params, cache, token, pos) -> (logits, cache)
    init_cache: Callable           # (batch, seq) -> cache dict (zeros)


def build_model(cfg: ModelConfig, *, device: str | torch.device = "cuda") -> ModelApi:
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported; only dense")
    dev = layers.device_of(device)
    dt = layers.dtype_of(cfg.param_dtype)

    def forward_fn(params, batch):
        x, _ = transformer.dense_forward(params, cfg, batch)
        final_ln = transformer.plain_gather(params["final_ln"])
        return layers.rms_norm(x, final_ln, cfg.norm_eps).flatten(0, 1)

    def prefill_fn(params, batch):
        x, cache = transformer.dense_forward(params, cfg, batch, want_cache=True)
        logits = transformer.lm_logits(params, cfg, x[:, :, -1:])[:, :, 0]
        return logits.flatten(0, 1), cache

    def decode_fn(params, cache, token, pos):
        return transformer.dense_decode_step(params, cfg, cache, token, pos)

    def init_cache(batch, seq):
        return transformer.dense_init_cache(cfg, batch, seq, dt, dev)

    return ModelApi(cfg, forward_fn, prefill_fn, decode_fn, init_cache)


def batch_dims(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, tuple]:
    """Shapes (no data) of every input of a (dense cfg, shape) cell."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"tokens": (b, s), "targets": (b, s)}
    if shape.kind == "prefill":
        return {"tokens": (b, s)}
    return {"token": (b,), "pos": (b,)}
