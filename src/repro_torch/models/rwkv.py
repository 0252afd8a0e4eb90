"""RWKV6 "Finch": token shift with LoRA mixing and a data-dependent decay per
channel (counterpart of ``repro.models.rwkv``).

WKV recurrence per head (state S in R^{K x V}):
    o_t = r_t S_{t-1} + (r_t . (u o k_t)) v_t
    S_t = diag(w_t) S_{t-1} + k_t^T v_t            (w_t in (0, 1), per channel)

Prefill and training take the chunked form: a loop over chunks carrying S
(f32), each chunk's pairs in parallel with the exact per-pair decay. Decode
is the recurrent step. Both are plain jnp in the reference, outside any
Pallas kernel, so plain torch here.

The block works per rank, as the dense one does: activations (R, B, S, D),
every weight the rank's gathered copy (R, *global shape), each projection
on the matmul kernel (``layers.rank_matmul``). The WKV runs over the R * B
rows of the global batch, each row with its rank's bonus ``u``.

On a physical ``model`` axis (tp > 1) the heads split over it where they
divide (``heads_split``): ``wr``, ``wk``, ``wv`` and ``wg`` give each rank
its H / tp heads, on which the WKV runs as it is; the token-shift and decay
LoRAs are split over dp only, so they run whole and the rank takes its
chunk of the decay (``sharding/tp.chunk``), as of the bonus and the
group norm's scale and bias; ``wo`` sums partial products over ``model``.
The channel mix splits d_ff (``cm_wk``, ``cm_wv`` partial sums) and, by
the rules, ``cm_wr``'s output d_model: the value is reduce-scattered on
d_model before the receptance multiplies it chunk by chunk, and the
product gathered back. The block takes the stream's sequence chunk where
the context runs it sequence-parallel (``sp``), gathering the normed
stream before each mix.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.sharding import tp as TP


def heads_split(cfg: ModelConfig) -> bool:
    """Whether the time mix's heads split over a physical ``model`` axis
    (else its four input matrices and ``wo`` are gathered over it whole)."""
    return TP.size() > 1 and cfg.num_heads % TP.size() == 0


def _shift(x: torch.Tensor, prev: torch.Tensor | None = None) -> torch.Tensor:
    """Token shift along the sequence: y_t = x_{t-1}; y_0 = prev (or zeros).
    x (R, B, S, D), prev (R, B, D)."""
    pad = torch.zeros_like(x[:, :, :1]) if prev is None else prev[:, :, None]
    return torch.cat([pad, x[:, :, :-1]], dim=2)


def _per_rank(v: torch.Tensor, nd: int) -> torch.Tensor:
    """A per-rank vector (R, D) broadcast against an (R, ..., D) of ``nd`` dims."""
    return v.reshape(v.shape[0], *([1] * (nd - 2)), v.shape[-1])


def rwkv_block_param_count(cfg: ModelConfig) -> int:
    d, f, r = cfg.d_model, cfg.d_ff, cfg.rwkv
    tm = 5 * d * d + d * 5 * r.tokenshift_lora + 5 * r.tokenshift_lora * d
    tm += d * r.decay_lora + r.decay_lora * d + 5 * d + d + cfg.num_heads * cfg.head_dim
    cm = d * f + f * d + d * d + 2 * d
    return tm + cm + 4 * d  # + norms


def _lora_out(lora: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The token-shift LoRA's second product, ``bste,ted->tbsd``: lora (R,
    B, S, 5, e), w (R, 5, e, D) -> (5, R, B, S, D), the five mixes as one
    product batched over the ranks and the mixes."""
    r, b, s, t, e = lora.shape
    a = lora.permute(0, 3, 1, 2, 4).reshape(r * t, b * s, e)
    y = layers.rank_matmul(a, w.reshape(r * t, e, w.shape[-1]))
    return y.reshape(r, t, b, s, -1).transpose(0, 1)


def _time_mix_inputs(p, x: torch.Tensor, x_prev, cfg: ModelConfig) -> torch.Tensor:
    """Finch's 5-way token-shift mixing -> (xr, xk, xv, xw, xg) stacked, (5,
    R, B, S, D)."""
    dt = x.dtype
    sx = _shift(x, x_prev) - x                                   # (R,B,S,D)
    mu = p["mu"].to(dt).transpose(0, 1)[:, :, None, None, :]     # (5,R,1,1,D)
    base = x + sx * mu                                           # (5,R,B,S,D)
    lora = torch.tanh(layers.rank_matmul(x, p["ts_w1"]))         # (R,B,S,5 e)
    lora = lora.reshape(*x.shape[:3], 5, -1)
    off = _lora_out(lora, p["ts_w2"])
    return (base + sx[None] * off).to(dt)


def _decay(p, xw: torch.Tensor) -> torch.Tensor:
    """log(w) per channel, always negative: -exp(clip(base + lora, -8, 4)), f32."""
    lora = layers.rank_matmul(torch.tanh(layers.rank_matmul(xw, p["decay_w1"])),
                              p["decay_w2"])
    base = _per_rank(p["decay_base"], xw.dim())
    return -torch.exp(torch.clamp(base + lora.float(), -8.0, 4.0))


def _bonus(u: torch.Tensor) -> torch.Tensor:
    """u (H, hd), or one per row (N, H, hd), as (N or 1, 1, H, hd), which
    broadcasts over (N, positions, H, hd)."""
    return u[None, None] if u.dim() == 2 else u[:, None]


def wkv_chunked(r, k, v, lw, u, chunk: int):
    """Chunked WKV. r, k, v, lw (B, S, H, hd) f32 (lw the log decay); u
    (H, hd), or one per row (B, H, hd). Returns (o (B, S, H, hd) f32,
    S_final (B, H, K, V) f32). Reference ``rwkv.py:105``."""
    b, s, h, hd = r.shape
    nc = -(-s // chunk)
    pad = nc * chunk - s
    if pad:
        # log w = 0 -> w = 1 on the padding (no decay, k = 0)
        r, k, v, lw = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v, lw))
    ub = _bonus(u.float())
    cmask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=r.device), -1)
    state = torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for i in range(nc):
        rb, kb, vb, lwb = (t[:, i * chunk:(i + 1) * chunk].float() for t in (r, k, v, lw))
        big = torch.cumsum(lwb, dim=1)                    # inclusive
        bx = big - lwb                                    # exclusive
        last = big[:, -1:]                                # (B,1,H,hd)
        rr = rb * torch.exp(bx)                           # decay chunk start..t-1 (<= 1)
        # intra-chunk scores with the EXACT per-pair per-channel decay
        # exp(Lx_t - L_s): its exponent is <= 0 for every causal pair
        dec = torch.exp(torch.clamp(bx[:, :, None] - big[:, None, :], max=0.0))
        scores = (rb[:, :, None] * kb[:, None] * dec).sum(-1).permute(0, 3, 1, 2)
        scores = torch.where(cmask, scores, 0.0)          # (B,H,t,s)
        o = torch.einsum("bhts,bshv->bthv", scores, vb)
        diag = (rb * (ub * kb)).sum(-1)                   # the bonus on the diagonal
        o = o + diag[..., None] * vb
        o = o + torch.einsum("bthk,bhkv->bthv", rr, state)
        kk2 = kb * torch.exp(last - big)                  # decay s+1..chunk end (<= 1)
        state = torch.exp(last[:, 0])[..., None] * state + torch.einsum(
            "bshk,bshv->bhkv", kk2, vb)
        outs.append(o)
    return torch.cat(outs, dim=1)[:, :s], state


def wkv_recurrent(r, k, v, lw, u, S0=None):
    """The per-step recurrence (the decode path and the tests' oracle).
    Shapes as ``wkv_chunked``'s; S0 (B, H, K, V) f32 or None. Reference
    ``rwkv.py:155``."""
    b, s, h, hd = r.shape
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
             if S0 is None else S0)
    ub = _bonus(u.float())[:, 0]
    outs = []
    for t in range(s):
        rt, kt, vt, lwt = (x[:, t].float() for x in (r, k, v, lw))   # (B,H,hd)
        o = torch.einsum("bhk,bhkv->bhv", rt, state)
        o = o + (rt * (ub * kt)).sum(-1)[..., None] * vt
        state = torch.exp(lwt)[..., None] * state + kt[..., None] * vt[..., None, :]
        outs.append(o)
    return torch.stack(outs, dim=1), state


def _group_norm_heads(x: torch.Tensor, scale, bias, eps: float = 1e-5) -> torch.Tensor:
    """x (R, B, S, H, hd): normalised per head; scale and bias (R, D) per channel."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, correction=0)
    y = ((x - mu) * torch.rsqrt(var + eps)).flatten(-2)
    return y * _per_rank(scale, y.dim()) + _per_rank(bias, y.dim())


def time_mix_apply(p, x: torch.Tensor, cfg: ModelConfig, *, x_prev=None, state=None,
                   chunked: bool = True):
    """RWKV6 time mix. x (R, B, S, D), every position on every tp rank;
    state (R, B, H', K, V) f32 or None. Returns (out (R, B, S, D), partial
    sums over ``model`` where the heads split; new state (R, B, H', K, V);
    last x (R, B, D)), H' each rank's heads (``heads_split``) or H."""
    rk, b, s, _ = x.shape
    hd, d = cfg.head_dim, cfg.d_model
    dt = x.dtype
    split = heads_split(cfg)

    def w(name, dim=-1):   # gathered over ``model`` where the heads do not split
        m = p[name]
        return m if split else layers.whole(m, d, dim)

    xr, xk, xv, xw, xg = _time_mix_inputs(p, x, x_prev, cfg)
    r = layers.rank_matmul(xr, w("wr"))
    k = layers.rank_matmul(xk, w("wk"))
    v = layers.rank_matmul(xv, w("wv"))
    g = F.silu(layers.rank_matmul(xg, w("wg")))
    lw = _decay(p, xw)
    bonus, scale, bias = p["bonus"], p["ln_x_scale"], p["ln_x_bias"]
    if split:   # each rank's heads and channels of the whole-width values
        lw, bonus, scale, bias = (TP.chunk(lw, -1), TP.chunk(bonus, 1), TP.chunk(scale, 1),
                                  TP.chunk(bias, 1))
    h = bonus.shape[1]
    u = bonus.float()[:, None].expand(rk, b, h, hd).reshape(rk * b, h, hd)

    def rows(t):
        return t.float().reshape(rk * b, s, h, hd)

    if chunked and s > 1:
        if state is not None:
            # the reference folds no carried-in state into the chunked path
            # (prefill starts from zeros; streaming prefill is recurrent)
            raise NotImplementedError("chunked WKV with nonzero initial state")
        o, new = wkv_chunked(rows(r), rows(k), rows(v), rows(lw), u, cfg.rwkv.chunk_size)
    else:
        s0 = None if state is None else state.reshape(rk * b, h, hd, hd)
        o, new = wkv_recurrent(rows(r), rows(k), rows(v), rows(lw), u, s0)
    o = _group_norm_heads(o.reshape(rk, b, s, h, hd), scale, bias).to(dt)
    out = layers.rank_matmul(o * g.to(dt), w("wo", -2))
    return out.to(dt), new.reshape(rk, b, h, hd, hd), x[:, :, -1]


def channel_mix_apply(p, x: torch.Tensor, cfg: ModelConfig, *, x_prev=None, sp: bool = False):
    """RWKV channel mix (squared ReLU). x every position on every tp rank.
    Returns (out, last x): out on the residual stream, each rank's
    sequence chunk where ``sp``. On a physical ``model`` axis the value's
    partial sums are reduce-scattered on d_model (``cm_wr`` splits its
    output d_model), multiplied by the receptance's chunk, and the product
    gathered on d_model."""
    dt = x.dtype
    sx = _shift(x, x_prev) - x
    xk = x + sx * _per_rank(p["cm_mu_k"].to(dt), x.dim())
    xr = x + sx * _per_rank(p["cm_mu_r"].to(dt), x.dim())
    kk = torch.square(F.relu(layers.rank_matmul(xk, p["cm_wk"])))
    vv = layers.rank_matmul(kk, p["cm_wv"])
    rr = torch.sigmoid(layers.rank_matmul(xr, p["cm_wr"]))
    r_split = rr.shape[-1] < x.shape[-1]
    if layers.partial_sums(p["cm_wv"], cfg.d_ff):
        vv = TP.reduce_scatter(vv, -1) if r_split else TP.all_reduce(vv)
    elif r_split:
        vv = TP.chunk(vv, -1)
    out = rr * vv
    if r_split:
        out = TP.gather(out, -1)
    return layers.to_residual(out, False, sp), x[:, :, -1]


def rwkv_block_apply(p, x: torch.Tensor, cfg: ModelConfig, *, state=None,
                     chunked: bool = True, sp: bool = False):
    """One RWKV6 block. x (R, B, S, D), on a physical ``model`` axis (R, B,
    S / tp, D) where ``sp``; state None or {wkv (R, B, H', K, V), tm_x (R,
    B, D), cm_x (R, B, D)}. Returns (x, new state). Reference
    ``rwkv.py:225``."""
    st_wkv = None if state is None else state["wkv"]
    tm_prev = None if state is None else state["tm_x"]
    cm_prev = None if state is None else state["cm_x"]
    h = layers.rms_norm(x, p["ln1"], 1e-5)
    if sp:
        h = TP.gather(h, 2)
    att, new_wkv, tm_x = time_mix_apply(p, h, cfg, x_prev=tm_prev, state=st_wkv,
                                        chunked=chunked)
    x = x + layers.to_residual(att.to(x.dtype), heads_split(cfg), sp)
    h2 = layers.rms_norm(x, p["ln2"], 1e-5)
    if sp:
        h2 = TP.gather(h2, 2)
    ff, cm_x = channel_mix_apply(p, h2, cfg, x_prev=cm_prev, sp=sp)
    x = x + ff.to(x.dtype)
    return x, {"wkv": new_wkv, "tm_x": tm_x.to(x.dtype), "cm_x": cm_x.to(x.dtype)}
