"""RecurrentGemma / Griffin's recurrent block: the RG-LRU with its temporal
conv and gated branches (counterpart of ``repro.models.rglru``; the local
attention lives in ``attention.py``).

RG-LRU (a diagonal linear recurrence):
    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_x x_t)
    a_t = exp(-c * softplus(lam) * r_t)                 (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The reference scans it with ``jax.lax.associative_scan``, plain jnp outside
any Pallas kernel; here it is a log-depth doubling scan in plain torch.
Decode is one step: the state is h (B, lru_width) and the conv's tail.

The block works per rank: activations (R, B, S, .), every weight the
rank's gathered copy (R, *global shape), each projection on the matmul
kernel (``layers.rank_matmul``; the gates' in f32, on its f32 path).

On a physical ``model`` axis (tp > 1) the LRU width W splits over it where
it divides (``width_split``): ``w_gate_in`` and ``w_rec_in`` give each rank
its W / tp channels, on which the conv and the scan run as they are (both
per channel); the two gates (W, W) split their fan-out, so their input,
the whole post-conv W, is gathered over ``model`` first; ``w_out`` sums
partial products over it. The block takes the stream's sequence chunk
where the context runs it sequence-parallel (``sp``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.sharding import tp as TP

RGLRU_C = 8.0


def width_split(cfg: ModelConfig) -> bool:
    """Whether the LRU width splits over a physical ``model`` axis."""
    return TP.size() > 1 and cfg.rglru.lru_width % TP.size() == 0


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor | None = None):
    """h_t = a_t h_{t-1} + b_t along dim -2. a, b (..., S, W); h0 (..., W)
    or None, folded into the first step. Returns (h (..., S, W), h_last).

    Hillis–Steele: ceil(log2 S) rounds, round d combining each position with
    the one 2^d before it, (a, b) <- (a * a', a * b' + b), the reference's
    combine; about four ops a round, whatever S."""
    if h0 is not None:
        b = torch.cat([b[..., :1, :] + a[..., :1, :] * h0[..., None, :], b[..., 1:, :]], dim=-2)
    s = a.shape[-2]
    d = 1
    while d < s:
        b = torch.cat([b[..., :d, :], a[..., d:, :] * b[..., :-d, :] + b[..., d:, :]], dim=-2)
        if 2 * d < s:
            a = torch.cat([a[..., :d, :], a[..., :-d, :] * a[..., d:, :]], dim=-2)
        d *= 2
    return b, b[..., -1, :]


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  tail: torch.Tensor | None = None):
    """Depthwise causal conv along the sequence. x (R, B, S, W), w (R, K, W),
    b (R, W), tail (R, B, K - 1, W) or None. Returns (y (R, B, S, W), new
    tail (R, B, K - 1, W))."""
    kw = w.shape[1]
    r, bb, s, width = x.shape
    pad = (torch.zeros((r, bb, kw - 1, width), dtype=x.dtype, device=x.device)
           if tail is None else tail)
    xp = torch.cat([pad, x], dim=2)                         # (R, B, S + K - 1, W)
    taps = w.to(x.dtype)[:, :, None, None, :]               # (R, K, 1, 1, W)
    y = xp[:, :, 0:s] * taps[:, 0]
    for i in range(1, kw):
        y = y + xp[:, :, i:i + s] * taps[:, i]
    y = y + b.to(x.dtype)[:, None, None, :]
    new_tail = xp[:, :, -(kw - 1):] if kw > 1 else torch.zeros_like(pad)
    return y, new_tail


def rec_block_param_count(cfg: ModelConfig) -> int:
    d, w = cfg.d_model, cfg.rglru.lru_width
    kw = cfg.rglru.conv_width
    return 2 * d * w + kw * w + 2 * w * w + w * d + 5 * w + d


def rglru_apply(p, x: torch.Tensor, h0=None):
    """The RG-LRU. x (R, B, S, W') after the conv, W' each rank's channels
    on a physical ``model`` axis (gathered whole over it for the gates);
    gates in f32. Returns (y, h_last (R, B, W') f32)."""
    n = x.shape[0]
    x32 = x.float()
    gate_in = x32 if x.shape[-1] == p["lru_a_gate"].shape[-2] else TP.gather(x, -1).float()

    def vec(name):
        return layers.ranked(p[name], n)[:, None, None, :]     # (R, 1, 1, W') f32

    r = torch.sigmoid(layers.rank_matmul(gate_in, p["lru_a_gate"]) + vec("lru_a_bias"))
    i = torch.sigmoid(layers.rank_matmul(gate_in, p["lru_x_gate"]) + vec("lru_x_bias"))
    log_a = -RGLRU_C * F.softplus(vec("lru_lam")) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * x32)
    h, h_last = rglru_scan(a, b, h0)
    return h.to(x.dtype), h_last


def rec_block_apply(p, x: torch.Tensor, cfg: ModelConfig, *, state=None, sp: bool = False):
    """Griffin's recurrent block. x (R, B, S, D), on a physical ``model``
    axis (R, B, S / tp, D) where ``sp``; state None or {h (R, B, W') f32,
    conv (R, B, K - 1, W')}, W' each rank's channels (``width_split``).
    Returns (x, new state). Reference ``rglru.py:101``."""
    r = x.shape[0]
    h = layers.rms_norm(x, p["ln"], 1e-6)
    if sp:
        h = TP.gather(h, 2)
    gate = layers.activation("gelu", layers.rank_matmul(h, p["w_gate_in"]))
    rec = layers.rank_matmul(h, p["w_rec_in"])
    tail = None if state is None else state["conv"]
    rec, new_tail = causal_conv1d(rec, layers.ranked(p["conv_w"], r),
                                  layers.ranked(p["conv_b"], r), tail)
    h0 = None if state is None else state["h"]
    rec, h_last = rglru_apply(p, rec, h0)
    out = layers.rank_matmul(gate * rec, p["w_out"])
    return x + layers.to_residual(out, width_split(cfg), sp), {"h": h_last, "conv": new_tail}
