"""Shared model primitives: norms, activations, RoPE, projections.

Counterpart of ``repro.models.layers``. Functions that take weights work per
rank: activations carry a leading rank dim R and every weight is the rank's
own gathered copy, (R, *global shape with its ``model`` split), so rank r
computes only with ``w[r]``; a weight of the serving layout that every dp
rank shares is (tp, ...), rank r reading ``w[r % tp]``. The matrix products
are batched over R, on the port's matmul kernel.

On a physical ``model`` axis the projections are the reference's GSPMD
placement: ``wq``/``wk``/``wv`` and the MLP's input matrices
column-parallel, ``wo`` and the down projection row-parallel (each tp rank
its partial sums, reduced by the caller); attention heads split over
``model`` only where they divide (``head_plan``), an attention weight whose
split does not fall on whole heads gathered over ``model`` first.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import collective_matmul
from repro_torch.sharding import tp as TP

Params = Any  # nested dict of tensors


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def rank_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (R, ..., k) @ w (R, k, n) -> (R, ..., n), rank by rank, on the matmul
    kernel (``kernels/collective_matmul.py``) forward and backward, as the
    op ``repro_torch::rank_matmul``. A w (W, k, n) of fewer copies, W
    dividing R, is read by rank r at w[r % W]: the rows of the ranks that
    share a copy go through one product with it (one launch still)."""
    r, wr = x.shape[0], w.shape[0]
    if wr == r or wr == 1:
        y = collective_matmul.rank_matmul(x.reshape(r, -1, x.shape[-1]),
                                          w.to(x.dtype).expand(r, *w.shape[1:]))
        return y.reshape(*x.shape[:-1], w.shape[-1])
    rows = x.reshape(r // wr, wr, -1, x.shape[-1]).transpose(0, 1)
    y = collective_matmul.rank_matmul(rows.reshape(wr, -1, x.shape[-1]), w.to(x.dtype))
    y = y.reshape(wr, r // wr, -1, w.shape[-1]).transpose(0, 1)
    return y.reshape(*x.shape[:-1], w.shape[-1])


def ranked(w: torch.Tensor, r: int) -> torch.Tensor:
    """A weight of W copies (W, ...), W dividing R, as every rank's (R, ...),
    rank r reading copy r % W (a view where W is R or 1): the serving
    layout's tp-split vectors, used element by element."""
    wr = w.shape[0]
    if wr == r:
        return w
    if wr == 1:
        return w.expand(r, *w.shape[1:])
    return w.unsqueeze(0).expand(r // wr, *w.shape).reshape(r, *w.shape[1:])


def to_residual(y: torch.Tensor, partial: bool, sp: bool) -> torch.Tensor:
    """A block's output (R, B, S, D) -> the residual stream's placement on
    ``model``: partial sums reduce-scattered to each rank's sequence chunk
    (``sp``) or all-reduced; a whole value chunked or kept. At tp = 1, y."""
    if partial:
        return TP.reduce_scatter(y, 2) if sp else TP.all_reduce(y)
    return TP.chunk(y, 2) if sp else y


# ---------------------------------------------------------------- norms / act


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x (R, ..., D), w (R, D) (or one copy, (1, D))."""
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
    """SwiGLU (w_gate/w_up/w_down) or plain 2-layer MLP (w_in/w_out). On a
    physical ``model`` axis the hidden units are split where the rules
    split them: the input matrices column-parallel and the output matrix
    row-parallel, so the result is each tp rank's partial sums
    (``mlp_partial`` says whether), reduced by the caller."""
    if "w_gate" in p:
        g = rank_matmul(x, p["w_gate"])
        u = rank_matmul(x, p["w_up"])
        return rank_matmul(F.silu(g) * u, p["w_down"])
    h = activation(act, rank_matmul(x, p["w_in"]))
    return rank_matmul(h, p["w_out"])


def mlp_partial(p: Params, cfg: ModelConfig) -> bool:
    """Whether ``mlp_apply`` gives partial sums over ``model``: its output
    matrix keeps a split of the hidden units."""
    return partial_sums(p["w_down"] if "w_down" in p else p["w_out"], cfg.d_ff)


def partial_sums(w: torch.Tensor, width: int) -> bool:
    """Whether a product with the output matrix w (R, k, n), whose k rows
    are ``width`` whole, gives partial sums over ``model``: w keeps a split
    of its rows."""
    return w.shape[-2] < width


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


class HeadPlan(NamedTuple):
    """How attention's heads lie over ``model`` (the reference's
    ``_attn_head_spec``: heads split only where num_heads % tp == 0)."""
    q_split: bool        # q heads, wq's columns and wo's rows split over model
    kv_split: bool       # kv heads too (num_kv_heads % tp == 0)
    kv_index: Any        # where q is split and kv is not: (tp, KVl), tp rank m's
                         # kv heads (every kv head once per local group), else None


def head_plan(cfg: ModelConfig) -> HeadPlan:
    """The placement of attention heads for the active context."""
    t = TP.size()
    q_split = t > 1 and cfg.num_heads % t == 0
    kv_split = q_split and cfg.num_kv_heads % t == 0
    index = None
    if q_split and not kv_split:
        hl, grp = cfg.num_heads // t, cfg.num_heads // cfg.num_kv_heads
        heads = [[h // grp for h in range(m * hl, (m + 1) * hl)] for m in range(t)]
        kv = [sorted(set(row)) for row in heads]
        even = all(len(row) == len(kv[0]) and hl % len(row) == 0
                   and of_q == [k for k in row for _ in range(hl // len(row))]
                   for row, of_q in zip(kv, heads))
        index = kv if even else heads   # else one kv head per q head
    return HeadPlan(q_split, kv_split, index)


def whole(w: torch.Tensor, cols: int, dim: int) -> torch.Tensor:
    """w with dim ``dim`` gathered over ``model`` where it is split there."""
    return w if w.shape[dim] == cols else TP.gather(w, dim)


def q_heads(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (R, B, S, D) -> q (R, B, S, H, hd), on a physical ``model`` axis
    each rank's H/tp heads where heads split (``head_plan``), else every
    head (``wq`` gathered over ``model`` where the rules split it)."""
    hd = cfg.head_dim
    wq = p["wq"]
    if not head_plan(cfg).q_split:
        wq = whole(wq, cfg.num_heads * hd, -1)
    return rank_matmul(x, wq).reshape(*x.shape[:-1], -1, hd)


def qkv_split(p: Params, x: torch.Tensor, cfg: ModelConfig, kv_x: torch.Tensor | None = None):
    """x: (R, B, S, D) -> q (R,B,S,H,hd), k/v (R,B,S',KV,hd), k and v from
    ``kv_x`` (R, B, S', D) where given (cross-attention), else from x. On a
    physical ``model`` axis (``head_plan``): q (R,B,S,H/tp,hd) where heads
    split, and k/v (R,B,S',KV/tp,hd) where kv heads split too, else every kv
    head (their weights gathered over ``model`` where the rules split
    them)."""
    hd = cfg.head_dim
    q = q_heads(p, x, cfg)
    kv_x = x if kv_x is None else kv_x
    wk, wv = p["wk"], p["wv"]
    if not head_plan(cfg).kv_split:
        wk, wv = (whole(w, cfg.num_kv_heads * hd, -1) for w in (wk, wv))
    k = rank_matmul(kv_x, wk).reshape(*kv_x.shape[:-1], -1, hd)
    v = rank_matmul(kv_x, wv).reshape(*kv_x.shape[:-1], -1, hd)
    return q, k, v


def local_kv(k: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """k or v (R, B, S, KV, hd), every kv head, -> each rank's kv heads of
    its local q heads where q heads split over ``model`` and kv heads do
    not (``HeadPlan.kv_index``); otherwise k itself."""
    plan = head_plan(cfg)
    if plan.kv_index is None or k.shape[-2] != cfg.num_kv_heads:
        return k
    index = torch.tensor(plan.kv_index, device=k.device)[TP.rank_index(k.shape[0], k.device)]
    index = index.view(k.shape[0], *([1] * (k.dim() - 3)), index.shape[-1], 1)
    return torch.take_along_dim(k, index, dim=-2)


def out_proj(p: Params, attn_out: torch.Tensor, cfg: ModelConfig | None = None) -> torch.Tensor:
    """attn_out: (R, B, S, H, hd) -> (R, B, S, D). On a physical ``model``
    axis attn_out holds each rank's heads where heads split (``wo``
    row-parallel: partial sums, reduced by the caller), all heads otherwise
    (``wo`` gathered over ``model`` where the rules split its rows)."""
    wo = p["wo"]
    if cfg is not None and TP.size() > 1 and not head_plan(cfg).q_split:
        wo = whole(wo, cfg.num_heads * cfg.head_dim, -2)
    return rank_matmul(attn_out.flatten(-2), wo)
