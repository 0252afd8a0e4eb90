"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.encdec``).

The audio frontend (mel spectrogram and conv downsampling) is a stub, as in
the reference: the batch holds precomputed frame embeddings (B, S_enc,
frame_dim = d_model). Positions are sinusoidal (no RoPE). The decoder keeps
a self-attention KV cache and, per layer, the cross-attention's K/V,
computed once at prefill from the encoder's output and frozen in decode.

Activations carry the leading rank dim R, as in ``models.transformer``.
Every encoder and decoder layer is gathered on its own through the
context's gather (``maybe_gather_params``), the encoder's layers first;
decode gathers with the plain gather, as the dense decode does. Only
remat="full" checkpoints a layer ("dots" runs the plain body) and the
stacks ignore ``prefetch``, as the reference's do (``encdec.py:97,157``).

On a physical ``model`` axis (tp > 1) both stacks are tensor- and
sequence-parallel as the dense block is (``transformer.attention_tp``):
the self- and cross-attention's heads split over ``model`` where they
divide (else attention runs whole on every tp rank), the gelu MLP's
hidden units where d_ff divides, and each stream holds its sequence chunk
where its length divides. The positions are added to the whole stream
before it is split. The encoder's output is gathered over the sequence
once, for every decoder layer's cross K/V. Decode reads the cross K/V
cache by its sequence shards (flash-decoding, ``cache_pspecs``' layout)
where S_enc divides.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.transformer import (_decode_attention, _decode_attention_tp,
                                            _remat_full, attention_tp, decode_attention_tp,
                                            embed_tokens, heads_out, join_ranks, layer_slice,
                                            lm_logits, n_ranks, plain_gather, whole_input,
                                            whole_logits)
from repro_torch.sharding import tp as TP
from repro_torch.sharding.ctx import from_ranks, get_ctx, maybe_gather_params, to_ranks, use_ctx

Params = dict


def encdec_param_count(cfg: ModelConfig) -> int:
    """enc x (attn + mlp) + dec x (2 attn + mlp) + the embedding and the
    untied head, with the gelu MLP (the norms are not counted)."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    a = d * h * hd * 2 + d * kvh * hd * 2
    m = 2 * d * cfg.d_ff
    e = cfg.encdec
    return e.enc_layers * (a + m) + e.dec_layers * (2 * a + m) + 2 * cfg.vocab_size * d


def sinusoidal_positions(seq_len: int, d_model: int) -> np.ndarray:
    """The reference's table (``layers.sinusoidal_positions``), in numpy f32."""
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    dim = np.arange(0, d_model, 2, dtype=np.float32)[None, :]
    ang = pos / np.power(10000.0, dim / d_model)
    out = np.zeros((seq_len, d_model), dtype=np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


@functools.lru_cache(maxsize=8)
def position_table(seq_len: int, d_model: int, device: torch.device) -> torch.Tensor:
    """The (seq_len, d_model) f32 sinusoidal table on ``device``, made once
    for each length (a row does not depend on the length)."""
    return torch.from_numpy(sinusoidal_positions(seq_len, d_model)).to(device)


def _posenc(x: torch.Tensor) -> torch.Tensor:
    """x (R, B, S, D) + the positions 0..S-1, in x's dtype."""
    pe = position_table(x.shape[2], x.shape[3], x.device)
    return x + pe.to(x.dtype)


def _mlp(bp, x: torch.Tensor, cfg: ModelConfig, sp: bool) -> torch.Tensor:
    """x + the gelu MLP over ``ln2``, tensor-parallel over ``model``."""
    h2 = whole_input(layers.rms_norm(x, bp["ln2"], cfg.norm_eps), sp)
    ff = layers.mlp_apply(bp["mlp"], h2, "gelu")
    return x + layers.to_residual(ff, layers.mlp_partial(bp["mlp"], cfg), sp)


def _enc_block(bp, x: torch.Tensor, cfg: ModelConfig, sp: bool = False) -> torch.Tensor:
    """An encoder block over x (R, B, S_enc, D), each rank's sequence chunk
    (R, B, S_enc / tp, D) where ``sp``: non-causal attention, then the gelu
    MLP."""
    h = whole_input(layers.rms_norm(x, bp["ln1"], cfg.norm_eps), sp)
    y, _, _ = attention_tp(bp["attn"], h, cfg, None, causal=False)
    x = x + layers.to_residual(y, layers.head_plan(cfg).q_split, sp)
    return _mlp(bp, x, cfg, sp)


def encode(params, cfg: ModelConfig, frames: torch.Tensor, remat: str = "none") -> torch.Tensor:
    """frames (R, B, S_enc, D), the stubbed frontend's output, -> the encoder
    states (R, B, S_enc, D), every position on every tp rank: each layer
    gathered, then non-causal attention and the gelu MLP; ``enc_ln``
    last."""
    x = _posenc(frames.to(layers.dtype_of(cfg.compute_dtype)))
    sp = TP.seq_split(x.shape[2])
    x = layers.to_residual(x, False, sp)
    ctx = get_ctx()

    def body(x, layer):
        with use_ctx(ctx):
            return _enc_block(maybe_gather_params(layer), x, cfg, sp)

    fn = _remat_full(body, remat)
    for i in range(cfg.encdec.enc_layers):
        x = fn(x, layer_slice(params["enc_blocks"], i))
    x = layers.rms_norm(x, plain_gather(params["enc_ln"]), cfg.norm_eps)
    return whole_input(x, sp)


def _dec_block(bp, x: torch.Tensor, cfg: ModelConfig, enc: torch.Tensor, *, want_kv: bool,
               sp: bool = False):
    """A decoder block over the token states x (R, B, S, D) (each rank's
    sequence chunk where ``sp``): causal self-attention, then ``ln_x`` and
    cross-attention over the encoder states enc (R, B, S_enc, D), then the
    gelu MLP. Returns (x, (k, v, xk, xv) each (R*B, KV', S or S_enc, hd) |
    None), KV' each rank's kv heads or every one."""
    partial = layers.head_plan(cfg).q_split
    h = whole_input(layers.rms_norm(x, bp["ln1"], cfg.norm_eps), sp)
    y, k, v = attention_tp(bp["self_attn"], h, cfg, None)
    x = x + layers.to_residual(y, partial, sp)
    hx = whole_input(layers.rms_norm(x, bp["ln_x"], cfg.norm_eps), sp)
    y, kx, vx = attention_tp(bp["cross_attn"], hx, cfg, None, causal=False,
                            kv_h=enc)
    x = _mlp(bp, x + layers.to_residual(y, partial, sp), cfg, sp)
    kvs = tuple(t.transpose(2, 3).flatten(0, 1) for t in (k, v, kx, vx)) if want_kv else None
    return x, kvs


def encdec_forward(params, cfg: ModelConfig, batch, *, want_cache=False, remat="none"):
    """batch: frames (B, S_enc, D), tokens (B, S). Returns (hidden (R, B/dp,
    S, D), on a physical ``model`` axis (R, B/dp, S / tp, D) where S
    divides; {}; cache | None); the cache {k, v, xk, xv} of (L_dec, B, KV,
    S or S_enc, hd)."""
    r = n_ranks(params)
    enc = encode(params, cfg, to_ranks(batch["frames"], r), remat)
    x = _posenc(embed_tokens(params, cfg, to_ranks(batch["tokens"], r), whole=True))
    sp = TP.seq_split(x.shape[2])
    x = layers.to_residual(x, False, sp)
    ctx = get_ctx()

    def body(x, layer):
        with use_ctx(ctx):
            return _dec_block(maybe_gather_params(layer), x, cfg, enc, want_kv=want_cache,
                              sp=sp)

    fn = _remat_full(body, remat)
    kvs = []
    for i in range(cfg.encdec.dec_layers):
        x, kv = fn(x, layer_slice(params["dec_blocks"], i))
        kvs.append(kv)
    cache = None
    if want_cache:
        rb = x.shape[:2]
        cache = {name: torch.stack([join_ranks(kv[j].unflatten(0, rb), 2, cfg.num_kv_heads)
                                    for kv in kvs])
                 for j, name in enumerate(("k", "v", "xk", "xv"))}
    return x, {}, cache


def encdec_decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token (B,), pos (B,). Returns (logits (B, V), cache updated in place):
    the self-attention cache written at pos; the cross K/V frozen, every
    S_enc row read (position S_enc - 1 for every row); on a physical
    ``model`` axis both by the dense decode's attention over ``model``."""
    r = n_ranks(params)
    x = embed_tokens(params, cfg, to_ranks(token[:, None], r))[:, :, 0]    # (R,B,D)
    pos_r = to_ranks(pos, r)
    pe = position_table(cache["k"].shape[3] + 1, cfg.d_model, x.device)
    x = x + pe[pos_r].to(x.dtype)
    se = cache["xk"].shape[3]
    last = torch.full_like(pos_r, se - 1)
    tp = TP.size() > 1
    for i in range(cfg.encdec.dec_layers):
        bp = maybe_gather_params(layer_slice(params["dec_blocks"], i))
        h = layers.rms_norm(x[:, :, None], bp["ln1"], cfg.norm_eps)
        kc, vc = cache["k"][i], cache["v"][i]
        if tp:
            x = x + decode_attention_tp(bp["self_attn"], h, cfg, {"k": kc, "v": vc}, pos_r)
        else:
            q, k, v = layers.qkv_split(bp["self_attn"], h, cfg)
            attn.cache_scatter_update(kc, from_ranks(k[:, :, 0]), from_ranks(pos_r))
            attn.cache_scatter_update(vc, from_ranks(v[:, :, 0]), from_ranks(pos_r))
            o = _decode_attention(q[:, :, 0], kc, vc, pos_r, cfg)
            x = x + layers.out_proj(bp["self_attn"], o[:, :, None])[:, :, 0]
        hx = layers.rms_norm(x[:, :, None], bp["ln_x"], cfg.norm_eps)
        qx = layers.q_heads(bp["cross_attn"], hx, cfg)[:, :, 0]
        if layers.head_plan(cfg).q_split:
            qx = TP.gather(qx, 2)
        cross = _decode_attention_tp if tp else _decode_attention
        x = x + heads_out(bp["cross_attn"], cross(qx, cache["xk"][i], cache["xv"][i], last, cfg),
                          cfg)
        h2 = layers.rms_norm(x[:, :, None], bp["ln2"], cfg.norm_eps)
        ff = layers.mlp_apply(bp["mlp"], h2, "gelu")[:, :, 0]
        x = x + layers.to_residual(ff, layers.mlp_partial(bp["mlp"], cfg), False)
    logits = lm_logits(params, cfg, x[:, :, None])[:, :, 0]
    return from_ranks(whole_logits(logits, cfg)), cache


def encdec_init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    shp = (cfg.encdec.dec_layers, batch, cfg.num_kv_heads, seq_len, cfg.head_dim)
    return {name: torch.zeros(shp, dtype=dtype, device=device)
            for name in ("k", "v", "xk", "xv")}
