"""Attention: chunked online-softmax for prefill, plain, ring-buffer and
flash-decoding single-token decode, the int8 KV quantisation.

Counterpart of ``repro.models.attention``, which is plain jnp there, so
plain torch here. The layouts are the reference's: q/k/v (B, S, H, hd) and
caches (B, KV, S, hd); the softmax runs in f32. The chunked path never
materialises (S x S) scores: it walks KV blocks carrying the online-softmax
state (m, l, acc). Flash-decoding takes the caches sequence-sharded over
``model``: each shard's partial softmax state, merged over the shards by
max and sum (the reference's ``pmax``/``psum``, here plain reductions over
the stacked shard dim: no Pallas kernel computes them there either).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _block_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
                window: Optional[int]) -> torch.Tensor:
    """q_pos (qb,), k_pos (kb,) -> bool (qb, kb); True = attend."""
    m = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _online_softmax(qq, k, v, q_pos, kv_off, *, causal, window, kv_block, softcap,
                    skv_valid):
    """qq (B, Sq, KV, G, hd) f32 against k/v (B, Skv, KV, hd) starting at
    absolute position kv_off. Returns (B, KV, G, Sq, hd) f32."""
    b, sq, kvh, qpkv, hd = qq.shape
    skv = k.shape[1]
    kv_block = min(kv_block, skv)
    nkb = -(-skv // kv_block)
    pad = nkb * kv_block - skv
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    scale = hd ** -0.5
    dev = qq.device
    m = torch.full((b, kvh, qpkv, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kvh, qpkv, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, kvh, qpkv, sq, hd), dtype=torch.float32, device=dev)
    for j in range(nkb):
        kblk = k[:, j * kv_block:(j + 1) * kv_block].float()
        vblk = v[:, j * kv_block:(j + 1) * kv_block].float()
        k_pos = kv_off + j * kv_block + torch.arange(kv_block, device=dev)
        s = torch.einsum("bqkgh,bckh->bkgqc", qq, kblk) * scale
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        mask = _block_mask(q_pos, k_pos, causal=causal, window=window)
        mask &= (k_pos < skv_valid)[None, :]
        s = s.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgqc,bckh->bkgqh", p, vblk)
        acc = acc * corr[..., None] + pv
        m = m_new
    return acc / torch.clamp(l, min=1e-30)[..., None]


def chunked_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                      kv_block: int = 1024, q_offset: int = 0,
                      softcap: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over KV blocks. q (B, Sq, H, hd), k/v
    (B, Skv, KV, hd). Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    if h % kvh:
        raise ValueError(f"{h} heads do not group over {kvh} kv heads")
    qq = q.reshape(b, sq, kvh, h // kvh, hd).float()
    q_pos = q_offset + torch.arange(sq, device=q.device)
    out = _online_softmax(qq, k, v, q_pos, 0, causal=causal, window=window,
                          kv_block=kv_block, softcap=softcap, skv_valid=k.shape[1])
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(q.dtype)


def blockwise_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                        q_block: int = 512, kv_block: int = 1024,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Outer loop over Q blocks, inner online softmax over KV blocks. For
    windowed attention each Q block takes a fixed-size KV slice."""
    b, s, h, hd = q.shape
    if s <= q_block:
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 kv_block=kv_block, softcap=softcap)
    nqb = -(-s // q_block)
    pad = nqb * q_block - s
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    skv = k.shape[1]
    outs = []
    for i in range(nqb):
        qblk = q[:, i * q_block:(i + 1) * q_block]
        q_off = i * q_block
        if window is not None:
            # fixed-size KV slice per q block: [end - window - q_block, end)
            span = min(-(-(window + q_block) // kv_block) * kv_block, skv)
            start = min(max(q_off + q_block - span, 0), skv - span)
            ks, vs = k[:, start:start + span], v[:, start:start + span]
        else:
            start, ks, vs = 0, k, v
        outs.append(_attend_block(qblk, ks, vs, q_off, start, causal=causal,
                                  window=window, kv_block=kv_block, softcap=softcap,
                                  skv_valid=skv))
    return torch.cat(outs, dim=1)[:, :s]


def _attend_block(qblk, k, v, q_off, kv_off, *, causal, window, kv_block, softcap,
                  skv_valid):
    """One q block against a KV range starting at absolute position kv_off."""
    b, sq, h, hd = qblk.shape
    kvh = k.shape[2]
    qq = qblk.reshape(b, sq, kvh, h // kvh, hd).float()
    q_pos = q_off + torch.arange(sq, device=qblk.device)
    out = _online_softmax(qq, k, v, q_pos, kv_off, causal=causal, window=window,
                          kv_block=kv_block, softcap=softcap, skv_valid=skv_valid)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd).to(qblk.dtype)


# --------------------------------------------------------------------- decode


def plain_decode_attention(q, k_cache, v_cache, pos, *, window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Single-token decode over the full cache. q (B, H, hd); caches
    (B, KV, S, hd); pos (B,) current positions (cache[0..pos] valid)."""
    b, h, hd = q.shape
    _, kvh, s, _ = k_cache.shape
    qq = q.reshape(b, kvh, h // kvh, hd).float()
    scores = torch.einsum("bkgh,bksh->bkgs", qq, k_cache.float()) * hd ** -0.5
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    idx = torch.arange(s, device=q.device)
    mask = idx[None, :] <= pos[:, None]
    if window is not None:
        mask &= idx[None, :] > pos[:, None] - window
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", p, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def flash_decode_attention(q, k_cache, v_cache, pos, *, window: Optional[int] = None,
                           softcap: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel decode (reference ``attention.py:237``) on stacked
    shards: q (G, P, B, H, hd), every shard the same queries; caches (G, P,
    B, KV, S_local, hd), shard p holding positions [p S_local, (p + 1)
    S_local); pos (G, P, B). Each shard's scores and partial softmax state
    over its slice, merged over the P shards (dim 1) by max and sum.
    Returns (G, P, B, H, hd), every shard the merged output."""
    g, p_, b, h, hd = q.shape
    kvh, s_local = k_cache.shape[3], k_cache.shape[4]
    qq = q.reshape(g, p_, b, kvh, h // kvh, hd).float()
    scores = torch.einsum("gpbkqh,gpbksh->gpbkqs", qq, k_cache.float()) * hd ** -0.5
    if softcap:
        scores = torch.tanh(scores / softcap) * softcap
    idx = (torch.arange(p_, device=q.device)[:, None] * s_local
           + torch.arange(s_local, device=q.device))                # (P, S_local)
    mask = idx[None, :, None, :] <= pos[..., None]
    if window is not None:
        mask &= idx[None, :, None, :] > pos[..., None] - window
    scores = scores.masked_fill(~mask[:, :, :, None, None, :], NEG_INF)
    m_glob = torch.amax(torch.amax(scores, dim=-1), dim=1, keepdim=True)
    prob = torch.exp(scores - m_glob[..., None])
    l_glob = torch.sum(torch.sum(prob, dim=-1), dim=1, keepdim=True)
    acc = torch.einsum("gpbkqs,gpbksh->gpbkqh", prob, v_cache.float())
    acc_glob = torch.sum(acc, dim=1, keepdim=True)
    out = acc_glob / torch.clamp(l_glob, min=1e-30)[..., None]
    return out.reshape(g, 1, b, h, hd).expand(g, p_, b, h, hd).to(q.dtype)


def ring_decode_attention(q, k_cache, v_cache, abs_pos, pos, window: int) -> torch.Tensor:
    """Single-token decode over a ring buffer of W slots (reference
    ``attention.py:298``). q (B, H, hd); caches (B, KV, W, hd), position p
    in slot p % W; abs_pos (B, W) the absolute position each slot holds;
    pos (B,). A slot is attended where its position is in (pos - window,
    pos] and not negative; the softmax in f32."""
    b, h, hd = q.shape
    kvh = k_cache.shape[1]
    qq = q.reshape(b, kvh, h // kvh, hd).float()
    scores = torch.einsum("bkgh,bksh->bkgs", qq, k_cache.float()) * hd ** -0.5
    mask = (abs_pos <= pos[:, None]) & (abs_pos > pos[:, None] - window) & (abs_pos >= 0)
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bksh->bkgh", p, v_cache.float())
    return out.reshape(b, h, hd).to(q.dtype)


def cache_scatter_update(cache: torch.Tensor, new: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Write ``new`` (..., KV, hd) at cache[..., :, pos, :] of a (..., KV, S,
    hd) cache, dropping out-of-range positions: on a cache split over the
    sequence, pos relative to each shard's first position, so that only
    the shard that owns it writes. Updates the cache in place (the
    reference's scatter is in place under donation; the cache may be a
    view of a larger one) and returns it. A dropped position writes back
    the value its clamped slot holds, so that the write is one scatter of
    every row, with no data-dependent shape: no host sync on the card, and
    it runs on meta tensors (the dry-run)."""
    s = cache.shape[-2]
    keep = (pos >= 0) & (pos < s)
    at = pos.clamp(0, s - 1)
    lead = torch.meshgrid(*(torch.arange(n, device=pos.device) for n in pos.shape),
                          indexing="ij")
    index = (*lead, slice(None), at)
    cache[index] = torch.where(keep[..., None, None], new.to(cache.dtype), cache[index])
    return cache


# ------------------------------------------------------- int8 KV quantization


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-vector int8 (reference ``attention.py:337``): x (...,
    hd) -> (q int8, scale (..., 1) f32)."""
    x32 = x.float()
    scale = torch.amax(torch.abs(x32), dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
