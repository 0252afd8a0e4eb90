"""Shared model primitives: norms, activations, RoPE, projections.

Counterpart of ``repro.models.layers``. Functions that take weights work per
rank: activations carry a leading rank dim R and every weight is the rank's
own gathered copy, (R, *global shape), so rank r computes only with
``w[r]``. The matrix products are batched over R, on the port's matmul
kernel.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import collective_matmul

Params = Any  # nested dict of tensors


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def rank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (R, ..., k) @ w (R, k, n) -> (R, ..., n), rank by rank, on the matmul
    kernel (``kernels/collective_matmul.py``) forward and backward, as the
    op ``repro_torch::rank_matmul``."""
    r = x.shape[0]
    y = collective_matmul.rank_matmul(x.reshape(r, -1, x.shape[-1]), w.to(x.dtype))
    return y.reshape(*x.shape[:-1], w.shape[-1])


# ---------------------------------------------------------------- norms / act


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (R, ..., D), w (R, D)."""
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    w = w.reshape(w.shape[0], *([1] * (x.dim() - 2)), w.shape[-1])
    return (y * (1.0 + w.float())).to(dt)


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    if name == "silu":
        return F.silu(x)
    if name == "relu_sq":
        return torch.square(F.relu(x))
    raise ValueError(name)


def mlp_apply(p: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    """SwiGLU (w_gate/w_up/w_down) or plain 2-layer MLP (w_in/w_out)."""
    if "w_gate" in p:
        g = rank_matmul(x, p["w_gate"])
        u = rank_matmul(x, p["w_up"])
        return rank_matmul(F.silu(g) * u, p["w_down"])
    h = activation(act, rank_matmul(x, p["w_in"]))
    return rank_matmul(h, p["w_out"])


# ----------------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    if not theta:
        return x
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)   # (hd/2,)
    ang = positions[..., None].float() * freqs                       # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]                               # (..., S, 1, hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention proj


def qkv_split(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """x: (R, B, S, D) -> q (R,B,S,H,hd), k/v (R,B,S,KV,hd)."""
    lead = x.shape[:-1]
    q = rank_matmul(x, p["wq"]).reshape(*lead, cfg.num_heads, cfg.head_dim)
    k = rank_matmul(x, p["wk"]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    v = rank_matmul(x, p["wv"]).reshape(*lead, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def out_proj(p: Params, attn_out: torch.Tensor) -> torch.Tensor:
    """attn_out: (R, B, S, H, hd) -> (R, B, S, D)."""
    return rank_matmul(attn_out.flatten(-2), p["wo"])
