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
Tensor parallelism over a physical ``model`` axis raises
(``transformer.check_tp``).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.transformer import (_decode_attention, _remat_full, check_tp,
                                            embed_tokens, layer_slice, lm_logits, n_ranks,
                                            plain_gather)
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


def _attend(q, k, v, rb, cfg: ModelConfig, causal: bool) -> torch.Tensor:
    """q (R, B, Sq, H, hd), k/v (R*B, Skv, KV, hd) -> (R, B, Sq, H, hd)."""
    o = attn.blockwise_attention(q.flatten(0, 1), k, v, causal=causal,
                                 q_block=cfg.attn_q_block, kv_block=cfg.attn_kv_block)
    return o.unflatten(0, rb)


def _enc_block(bp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    rb = x.shape[:2]
    h = layers.rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = layers.qkv_split(bp["attn"], h, cfg)
    o = _attend(q, k.flatten(0, 1), v.flatten(0, 1), rb, cfg, causal=False)
    x = x + layers.out_proj(bp["attn"], o)
    h2 = layers.rms_norm(x, bp["ln2"], cfg.norm_eps)
    return x + layers.mlp_apply(bp["mlp"], h2, "gelu")


def encode(params, cfg: ModelConfig, frames: torch.Tensor, remat: str = "none") -> torch.Tensor:
    """frames (R, B, S_enc, D), the stubbed frontend's output, -> the encoder
    states (R, B, S_enc, D): each layer gathered, then non-causal
    attention and the gelu MLP; ``enc_ln`` last."""
    x = _posenc(frames.to(layers.dtype_of(cfg.compute_dtype)))
    ctx = get_ctx()

    def body(x, layer):
        with use_ctx(ctx):
            return _enc_block(maybe_gather_params(layer), x, cfg)

    fn = _remat_full(body, remat)
    for i in range(cfg.encdec.enc_layers):
        x = fn(x, layer_slice(params["enc_blocks"], i))
    return layers.rms_norm(x, plain_gather(params["enc_ln"]), cfg.norm_eps)


def _cross_qkv(p, x: torch.Tensor, enc: torch.Tensor, cfg: ModelConfig):
    """q from the decoder states x (R, B, S, D), k and v from the encoder
    states enc (R, B, S_enc, D)."""
    hd = cfg.head_dim
    q = layers.rank_matmul(x, p["wq"]).unflatten(-1, (cfg.num_heads, hd))
    k = layers.rank_matmul(enc, p["wk"]).unflatten(-1, (cfg.num_kv_heads, hd))
    v = layers.rank_matmul(enc, p["wv"]).unflatten(-1, (cfg.num_kv_heads, hd))
    return q, k, v


def _dec_block(bp, x: torch.Tensor, cfg: ModelConfig, enc: torch.Tensor, *, want_kv: bool):
    """A decoder block over the token states x (R, B, S, D): causal
    self-attention, then ``ln_x`` and cross-attention over the encoder
    states, then the gelu MLP. Returns (x, (k, v, xk, xv) each (R*B, KV,
    S or S_enc, hd) | None)."""
    rb = x.shape[:2]
    h = layers.rms_norm(x, bp["ln1"], cfg.norm_eps)
    q, k, v = layers.qkv_split(bp["self_attn"], h, cfg)
    k, v = k.flatten(0, 1), v.flatten(0, 1)
    x = x + layers.out_proj(bp["self_attn"], _attend(q, k, v, rb, cfg, causal=True))
    hx = layers.rms_norm(x, bp["ln_x"], cfg.norm_eps)
    qx, kx, vx = _cross_qkv(bp["cross_attn"], hx, enc, cfg)
    kx, vx = kx.flatten(0, 1), vx.flatten(0, 1)
    x = x + layers.out_proj(bp["cross_attn"], _attend(qx, kx, vx, rb, cfg, causal=False))
    h2 = layers.rms_norm(x, bp["ln2"], cfg.norm_eps)
    x = x + layers.mlp_apply(bp["mlp"], h2, "gelu")
    kvs = tuple(t.transpose(1, 2) for t in (k, v, kx, vx)) if want_kv else None
    return x, kvs


def encdec_forward(params, cfg: ModelConfig, batch, *, want_cache=False, remat="none"):
    """batch: frames (B, S_enc, D), tokens (B, S). Returns (hidden (R, B/dp,
    S, D), {}, cache | None); the cache {k, v, xk, xv} of (L_dec, B, KV, S
    or S_enc, hd)."""
    check_tp(cfg)
    r = n_ranks(params)
    enc = encode(params, cfg, to_ranks(batch["frames"], r), remat)
    x = _posenc(embed_tokens(params, cfg, to_ranks(batch["tokens"], r)))
    ctx = get_ctx()

    def body(x, layer):
        with use_ctx(ctx):
            return _dec_block(maybe_gather_params(layer), x, cfg, enc, want_kv=want_cache)

    fn = _remat_full(body, remat)
    kvs = []
    for i in range(cfg.encdec.dec_layers):
        x, kv = fn(x, layer_slice(params["dec_blocks"], i))
        kvs.append(kv)
    cache = None
    if want_cache:
        rb = x.shape[:2]
        cache = {name: torch.stack([from_ranks(kv[j].unflatten(0, rb)) for kv in kvs])
                 for j, name in enumerate(("k", "v", "xk", "xv"))}
    return x, {}, cache


def encdec_decode_step(params, cfg: ModelConfig, cache, token, pos):
    """token (B,), pos (B,). Returns (logits (B, V), cache updated in place):
    the self-attention cache written at pos; the cross K/V frozen, every
    S_enc row read (position S_enc - 1 for every row)."""
    check_tp(cfg)
    r = n_ranks(params)
    x = embed_tokens(params, cfg, to_ranks(token[:, None], r))[:, :, 0]    # (R,B,D)
    pos_r = to_ranks(pos, r)
    pe = position_table(cache["k"].shape[3] + 1, cfg.d_model, x.device)
    x = x + pe[pos_r].to(x.dtype)
    se = cache["xk"].shape[3]
    last = torch.full_like(pos_r, se - 1)
    for i in range(cfg.encdec.dec_layers):
        bp = maybe_gather_params(layer_slice(params["dec_blocks"], i))
        h = layers.rms_norm(x[:, :, None], bp["ln1"], cfg.norm_eps)
        q, k, v = layers.qkv_split(bp["self_attn"], h, cfg)
        kc, vc = cache["k"][i], cache["v"][i]
        attn.cache_scatter_update(kc, from_ranks(k[:, :, 0]), from_ranks(pos_r))
        attn.cache_scatter_update(vc, from_ranks(v[:, :, 0]), from_ranks(pos_r))
        o = _decode_attention(q[:, :, 0], kc, vc, pos_r, cfg)
        x = x + layers.out_proj(bp["self_attn"], o[:, :, None])[:, :, 0]
        hx = layers.rms_norm(x[:, :, None], bp["ln_x"], cfg.norm_eps)
        qx = layers.rank_matmul(hx, bp["cross_attn"]["wq"])[:, :, 0]
        qx = qx.unflatten(-1, (cfg.num_heads, cfg.head_dim))
        ox = _decode_attention(qx, cache["xk"][i], cache["xv"][i], last, cfg)
        x = x + layers.out_proj(bp["cross_attn"], ox[:, :, None])[:, :, 0]
        h2 = layers.rms_norm(x[:, :, None], bp["ln2"], cfg.norm_eps)
        x = x + layers.mlp_apply(bp["mlp"], h2, "gelu")[:, :, 0]
    logits = lm_logits(params, cfg, x[:, :, None])[:, :, 0]
    return from_ranks(logits), cache


def encdec_init_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype, device):
    shp = (cfg.encdec.dec_layers, batch, cfg.num_kv_heads, seq_len, cfg.head_dim)
    return {name: torch.zeros(shp, dtype=dtype, device=device)
            for name in ("k", "v", "xk", "xv")}
