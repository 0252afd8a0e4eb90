"""Serving runtime: prefill and decode steps over stacked FSDP parameters
(counterpart of ``repro.runtime.serve_loop``).

Prefill gathers every layer's dp-sharded weights with the run's
``fsdp_mode``: the paper's allgathers on the ring-allgather kernel in the
mcast modes. Decode gathers with the plain gather in every mode, as the reference
installs no explicit gather for decode. With
``CollectiveConfig.serve_params_replicated`` both steps take the weights
replicated over dp and still split over ``model`` (the reference's
``serve_shardings``, which both of its serving steps use): made once from
the parameters a step is given (``fsdp.replicate_over_dp``), or taken as
``serving_params`` made it, after which no step gathers over dp.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import build_model, transformer
from repro_torch.runtime.train_loop import make_ctx
from repro_torch.sharding.ctx import use_ctx
from repro_torch.sharding.fsdp import replicate_over_dp
from repro_torch.sharding.specs import dp_axes, is_sharded, tree_leaves


class ServeState(NamedTuple):
    cache: Any
    pos: torch.Tensor     # (B,) next write position per sequence


def serving_params(params, run: RunConfig, mesh: StackedMesh):
    """The dp-replicated layout of ``serve_params_replicated`` for a tree of
    ``Stacked`` leaves (``fsdp.replicate_over_dp``): every leaf replicated
    over dp, still split over ``model`` where the model code keeps its
    split. The serving steps take it as it is; a caller that makes it once
    may drop the sharded tree."""
    ctx = make_ctx(run, mesh)

    def keep_tp(path, leaf) -> bool:
        with use_ctx(ctx):
            return transformer.keeps_tp(run.model, path)

    return replicate_over_dp(params, mesh, dp_axes(run.mesh), keep_tp)


def _serving(run: RunConfig, mesh: StackedMesh | None, ctx):
    """(the step's context, params -> the tree the step runs on): ``ctx``
    and ``params`` themselves, or with ``serve_params_replicated`` a context
    that gathers nothing and the dp-replicated layout: ``params`` where no
    leaf is split over dp (``serving_params``' output), else made from it at
    the first call with these parameters and kept."""
    if mesh is None or not run.collective.serve_params_replicated:
        return ctx, lambda params: params
    ctx = dataclasses.replace(ctx, gather_params=None)
    dp = dp_axes(run.mesh)
    made: list = [None, None]

    def serving(params):
        if not any(is_sharded(leaf.spec, dp) for leaf in tree_leaves(params)):
            return params
        if made[0] is not params:
            made[:] = [params, serving_params(params, run, mesh)]
        return made[1]

    return ctx, serving


def make_prefill_step(run: RunConfig, mesh: StackedMesh | None, *,
                      device: str | torch.device = "cuda"):
    """prefill: (params, batch) -> (last-position logits (B, V), cache); the
    function's ``model`` attribute is ``run.model``."""
    api = build_model(run.model, device=device)
    ctx, serving = _serving(run, mesh, make_ctx(run, mesh))

    def prefill(params, batch):
        with use_ctx(ctx):
            return api.prefill_fn(serving(params), batch)

    prefill.model = run.model   # names the cache's handoff to decode (greedy_generate)
    return api, ctx, prefill


def make_decode_step(run: RunConfig, mesh: StackedMesh | None, *,
                     device: str | torch.device = "cuda"):
    """decode: (params, state, token) -> (next-token logits (B, V), state);
    the cache in ``state`` is updated in place."""
    api = build_model(run.model, device=device)
    ctx, serving = _serving(run, mesh, make_ctx(run, mesh, for_decode=True))

    def decode(params, state: ServeState, token):
        with use_ctx(ctx):
            logits, cache = api.decode_fn(serving(params), state.cache, token, state.pos)
        return logits, ServeState(cache, state.pos + 1)

    return api, ctx, decode


def greedy_generate(prefill, decode, params, prompt_tokens: torch.Tensor,
                    max_new: int, cache_len: int, inputs: dict | None = None) -> torch.Tensor:
    """Greedy generation from steps made by ``make_prefill_step`` (whose
    ``model`` attribute names the cache's handoff) and ``make_decode_step``.
    ``inputs`` holds the prefill's other inputs: the ``vlm`` family's
    ``patches``, the ``encdec`` family's ``frames``. Returns (B, S +
    max_new) tokens: the prompt, then the new tokens.

    The reference's greedy_generate feeds the prompt through decode one token at a
    time; here the prompt goes through the prefill step, the path that
    crosses the paper's gather, and decode continues from its cache
    (``transformer.decode_cache``: the dense cache padded, the rwkv states
    as they are, the hybrid's window written into its decode rings, the
    encdec's self-attention cache padded and its cross K/V as they are),
    at the prefill's stream length (the patches and the tokens for
    ``vlm``). For the dense, rwkv and hybrid families the tokens are the
    same: new token 0 is the argmax of the last prompt position's logits
    either way. For MoE they are the reference's prefill step's and decode
    step's: the prefill routes with its capacity, which may drop tokens,
    where decode drops none. The reference's own generation has no patches
    and runs the encdec against zero cross K/V, so for those two families
    the tokens are its prefill step's and decode steps'."""
    batch = dict(inputs or {}, tokens=prompt_tokens)
    b = prompt_tokens.shape[0]
    s = transformer.stream_len(prefill.model, batch)
    if cache_len < s + max_new - 1:
        raise ValueError(f"cache_len {cache_len} < {s + max_new - 1} positions")
    logits, pre = prefill(params, batch)
    cache = transformer.decode_cache(prefill.model, pre, s, cache_len)
    state = ServeState(cache, torch.full((b,), s, dtype=torch.long,
                                         device=prompt_tokens.device))
    tok = logits.argmax(-1)
    out = [prompt_tokens, tok[:, None]]
    for _ in range(max_new - 1):
        logits, state = decode(params, state, tok)
        tok = logits.argmax(-1)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)
