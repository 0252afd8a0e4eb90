"""Serving runtime: prefill and decode steps over stacked FSDP parameters
(counterpart of ``repro.runtime.serve_loop``).

Prefill gathers every layer's dp-sharded weights with the run's
``fsdp_mode``: the paper's allgathers on the ring-allgather kernel in the
mcast modes. Decode gathers with the plain gather in every mode, as the reference
installs no explicit gather for decode.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import build_model
from repro_torch.runtime.train_loop import make_ctx
from repro_torch.sharding.ctx import use_ctx


class ServeState(NamedTuple):
    cache: Any
    pos: torch.Tensor     # (B,) next write position per sequence


def make_prefill_step(run: RunConfig, mesh: StackedMesh | None, *,
                      device: str | torch.device = "cuda"):
    """prefill: (params, batch) -> (last-position logits (B, V), cache)."""
    api = build_model(run.model, device=device)
    ctx = make_ctx(run, mesh)

    def prefill(params, batch):
        with use_ctx(ctx):
            return api.prefill_fn(params, batch)

    return api, ctx, prefill


def make_decode_step(run: RunConfig, mesh: StackedMesh | None, *,
                     device: str | torch.device = "cuda"):
    """decode: (params, state, token) -> (next-token logits (B, V), state);
    the cache in ``state`` is updated in place."""
    api = build_model(run.model, device=device)
    ctx = make_ctx(run, mesh, for_decode=True)

    def decode(params, state: ServeState, token):
        with use_ctx(ctx):
            logits, cache = api.decode_fn(params, state.cache, token, state.pos)
        return logits, ServeState(cache, state.pos + 1)

    return api, ctx, decode


def greedy_generate(prefill, decode, params, prompt_tokens: torch.Tensor,
                    max_new: int, cache_len: int) -> torch.Tensor:
    """Greedy generation from steps made by ``make_prefill_step`` and
    ``make_decode_step``. Returns (B, S + max_new) tokens: the prompt, then
    the new tokens.

    The reference's greedy_generate feeds the prompt through decode one token at a
    time; here the prompt goes through the prefill step, the path that
    crosses the paper's gather, and decode continues from its cache. The
    tokens are the same: new token 0 is the argmax of the last prompt
    position's logits either way."""
    b, s = prompt_tokens.shape
    if cache_len < s + max_new - 1:
        raise ValueError(f"cache_len {cache_len} < {s + max_new - 1} positions")
    logits, pre = prefill(params, {"tokens": prompt_tokens})
    cache = {k: F.pad(v, (0, 0, 0, cache_len - s)) for k, v in pre.items()}
    state = ServeState(cache, torch.full((b,), s, dtype=torch.long,
                                         device=prompt_tokens.device))
    tok = logits.argmax(-1)
    out = [prompt_tokens, tok[:, None]]
    for _ in range(max_new - 1):
        logits, state = decode(params, state, tok)
        tok = logits.argmax(-1)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)
