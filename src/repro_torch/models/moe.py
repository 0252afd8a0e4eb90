"""Fine-grained Mixture-of-Experts (DeepSeekMoE / Moonlight style), the
port of ``repro.models.moe``:

  router -> top_k(gates) -> position-in-expert (cumsum) -> capacity drop
  -> dispatch gather (E, C, D) -> per-expert FFN -> combine.

Routing is global, as under the reference's pjit: the router's logits come
from each rank's rows on that rank's gathered copy, and the softmax, top-k,
positions, capacity and aux metrics are computed once over all T tokens of
the global batch, in ``from_ranks`` order (``sharding.ctx``).

Each expert slot is computed once: the E experts are split evenly over the
R dp ranks (``expert_owners``), and rank r runs its experts with its own
gathered copy ``w[r]`` (EP laid over the dp ranks). The owners' blocks of
the three expert weights are taken into one (E, ...) tensor a layer
(``_OwnBlocks``: one copy of 1/R of the gathered weight), so that each
product is one launch of the matmul kernel batched over the experts.

On a physical ``model`` axis (tp > 1) the rules split the expert dim over
``model`` where it divides (EP, the reference's placement): a rank's
gathered copy holds its tp rank's E/tp experts, and each of those is owned
by one dp rank of that tp rank (``expert_blocks``). The tokens enter the
routing whole, in the global (b, s) order (the block hands in the normed
stream gathered over the sequence); the routed output is then every tp
rank's, and the shared experts' are tensor-parallel partial sums; both go
to the residual's placement (``layers.to_residual``).

Every product of a gathered weight runs on the matmul kernel
(``layers.rank_matmul``): the router (f32), ``w_gate``, ``w_up``,
``w_down`` and the shared experts. The dispatch, the combine and the
routing are plain torch ops, as the reference computes them in ``jnp``
outside any Pallas kernel. The dispatch and the combine are gathers whose
backwards are gathers too (``_Gather``): nothing is summed by atomics, so a
forward and a backward give the same bits on every run.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers
from repro_torch.sharding.ctx import from_ranks, to_ranks


def expert_owners(n_experts: int, n_ranks: int, device) -> torch.Tensor:
    """(E,) the rank that computes each expert: contiguous runs, as even as
    the ranks allow (the first E % R ranks one expert more). Made on the
    device: no host-to-device copy."""
    per, extra = divmod(n_experts, n_ranks)
    e = torch.arange(n_experts, device=device)
    big = extra * (per + 1)   # the experts of the first E % R ranks
    return torch.where(e < big, e // (per + 1), extra + (e - big) // max(per, 1))


def expert_blocks(n_experts: int, w: torch.Tensor, n_ranks: int):
    """(copy, slot), each (E,): where expert e's weights lie in an expert
    leaf w (W, E', ...) of W copies (R gathered ones, or the serving
    layout's tp copies). Experts not split over ``model`` (E' = E): slot e
    of its owner's copy, the E experts split over the W copies
    (``expert_owners``). Split over ``model`` (E' = E / tp): tp rank m =
    e // E' holds it at slot e % E'; of R copies, its owner is the dp rank
    d of that tp rank that ``expert_owners`` gives the slot (rank d * tp +
    m); of tp copies, copy m."""
    wr, el = w.shape[:2]
    e = torch.arange(n_experts, device=w.device)
    if el == n_experts:
        return expert_owners(n_experts, wr, w.device), e
    t = n_experts // el
    m, slot = e // el, e % el
    if wr == t:
        return m, slot
    return expert_owners(el, n_ranks // t, w.device)[slot] * t + m, slot


class _OwnBlocks(torch.autograd.Function):
    """w (W, E', ...) the experts' copies -> (E, ...): expert e's block,
    w[copy[e], slot[e]] (``expert_blocks``). The backward writes the
    cotangent into zeros laid out as w is (the gathered copy's strides;
    contiguous where w is expanded), so that the gather's transpose reads it
    without another copy; nothing of w is kept."""

    @staticmethod
    def forward(ctx, w: torch.Tensor, copy: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
        stride = w.stride() if 0 not in w.stride() else None
        ctx.layout = (w.shape, stride, w.dtype, w.device)
        ctx.save_for_backward(copy, slot)
        return w[copy, slot]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g: torch.Tensor):
        copy, slot = ctx.saved_tensors
        shape, stride, dtype, device = ctx.layout
        if stride is None:
            gw = torch.zeros(shape, dtype=dtype, device=device)
        else:
            gw = torch.empty_strided(shape, stride, dtype=dtype, device=device).zero_()
        gw[copy, slot] = g.to(dtype)
        return gw, None, None


def _pad_row(t: torch.Tensor) -> torch.Tensor:
    """t (n, ...) with a row of zeros appended: index n reads zeros."""
    return torch.cat([t, t.new_zeros((1, *t.shape[1:]))])


def _take(src: torch.Tensor, idx: torch.Tensor, fold: int) -> torch.Tensor:
    """Rows ``idx`` of ``src`` (index len(src): zeros), summed over groups of
    ``fold`` consecutive rows, in order."""
    out = _pad_row(src)[idx]
    return out if fold == 1 else out.unflatten(0, (-1, fold)).sum(1)


class _Gather(torch.autograd.Function):
    """``_take(src, fwd, fold)`` whose backward is ``_take(g, bwd, bwd_fold)``:
    the dispatch (slots from tokens) and the combine (tokens from slots)
    are each other's transposes, given the two index tables."""

    @staticmethod
    def forward(ctx, src, fwd, fold, bwd, bwd_fold):
        ctx.save_for_backward(bwd)
        ctx.bwd_fold = bwd_fold
        return _take(src, fwd, fold)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (bwd,) = ctx.saved_tensors
        return _take(g, bwd, ctx.bwd_fold), None, None, None, None


def _top_k(v: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, ties to the lower index first, as
    ``jax.lax.top_k`` orders them (a stable descending sort)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _mean(t: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """The mean over ``dims`` as ``jnp.mean`` rounds it: the sum times the
    float32 reciprocal of the count (``drop_frac`` is compared bitwise)."""
    return t.sum(dims) * (1.0 / math.prod(t.shape[d] for d in dims))


def moe_apply(p, x: torch.Tensor, cfg: ModelConfig, *, no_drop: bool = False,
              sp: bool = False):
    """x (R, B, S, D), each rank's rows of the global batch (on a physical
    ``model`` axis every position on every tp rank); p one layer's gathered
    MoE weights (R, *global with the ``model`` split) -> (out, aux
    metrics): out (R, B, S, D), at tp > 1 placed on the residual stream,
    each rank's sequence chunk (R, B, S / tp, D) where ``sp``, else every
    position. Reference: ``src/repro/models/moe.py:53``.

    ``no_drop=True`` (decode path): capacity = T so routing never drops —
    single-token decode must be exact, not capacity-truncated."""
    m = cfg.moe
    r, d = x.shape[0], x.shape[-1]
    e, k = m.n_routed_experts, m.top_k
    xt = from_ranks(x).reshape(-1, d)                             # (T, D)
    t = xt.shape[0]
    cap = t if no_drop else int(math.ceil(t * k / e * m.capacity_factor))

    logits = from_ranks(layers.rank_matmul(x.float(), p["router"])).reshape(t, e)
    probs = torch.softmax(logits, dim=-1)
    if m.routing_groups and m.routing_groups > 1:
        # device-limited routing: keep only each token's top
        # ``routing_group_topk`` expert groups (reference moe.py:68)
        g = m.routing_groups
        grp = probs.reshape(t, g, e // g)
        top2 = _top_k(grp, min(2, e // g))[0].sum(-1)            # (T, g)
        gsel = _top_k(top2, m.routing_group_topk)[1]              # (T, G_act)
        gmask = torch.zeros((t, g), dtype=torch.bool, device=x.device).scatter_(1, gsel, True)
        probs = (grp * gmask[..., None]).reshape(t, e)
    gates, expert_idx = _top_k(probs, k)                          # (T, k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)

    # position of each (token, choice) within its expert, in token order:
    # the reference's cumsum of one-hots (moe.py:85-90), as a stable sort by
    # expert, which keeps token order within each expert (a scan down the
    # (T*k, E) one-hots would be parallel over the E columns only)
    flat_e = expert_idx.reshape(t * k)
    sorted_e, order = torch.sort(flat_e, stable=True)
    first = torch.searchsorted(sorted_e, torch.arange(e, device=x.device))
    rank_in_e = torch.arange(t * k, device=x.device) - first[sorted_e]
    pos = torch.empty_like(flat_e).scatter_(0, order, rank_in_e)
    keep = pos < cap

    # slot (E*C) <-> choice (T*k) tables. As in the reference's scatters
    # (moe.py:92-102), every choice writes slot e*C + (pos if kept else 0):
    # a dropped choice writes its expert's slot 0, and the last write in
    # choice order wins, so a dropped choice empties slot 0 of its expert.
    # A choice whose slot it does not hold, and an empty slot, index the
    # padding row, which reads zeros.
    n_slots, n_choices = e * cap, t * k
    choices = torch.arange(n_choices, device=x.device)
    dest = flat_e * cap + torch.where(keep, pos, 0)
    last = torch.full((n_slots,), -1, dtype=torch.long, device=x.device)
    last.scatter_reduce_(0, dest, choices, reduce="amax")
    held = keep & (last[dest] == choices)
    choice_slot = torch.where(held, dest, n_slots)                 # (T*k,)
    slot_choice = torch.where((last >= 0) & keep[last.clamp(min=0)], last, n_choices)
    slot_tok = torch.div(slot_choice, k, rounding_mode="floor")    # t for an empty slot

    xs = _Gather.apply(xt, slot_tok, 1, choice_slot, k).reshape(e, cap, d)
    copy, slot = expert_blocks(e, p["w_gate"], r)
    w_gate, w_up, w_down = (_OwnBlocks.apply(p[n], copy, slot)
                            for n in ("w_gate", "w_up", "w_down"))
    h = F.silu(layers.rank_matmul(xs, w_gate)) * layers.rank_matmul(xs, w_up)
    ys = layers.rank_matmul(h, w_down).reshape(n_slots, d)
    slot_gate = _Gather.apply(gates.reshape(n_choices), slot_choice, 1, choice_slot, 1)
    ys = ys * slot_gate[:, None].to(x.dtype)
    out = _Gather.apply(ys, choice_slot, k, slot_tok, 1)          # (T, D), no atomics
    out = to_ranks(out.reshape(-1, *x.shape[2:]), r)

    out = layers.to_residual(out, False, sp)
    if m.n_shared_experts:
        sh = p["shared"]
        partial = layers.partial_sums(sh["w_down"], m.d_ff_expert * m.n_shared_experts)
        out = out + layers.to_residual(layers.mlp_apply(sh, x, "swiglu"), partial, sp)

    # aux losses (Switch-style load balance + router z-loss)
    frac_tokens = _mean(F.one_hot(expert_idx, e).float(), (0, 1))
    frac_probs = _mean(probs, (0,))
    aux = e * torch.sum(frac_tokens * frac_probs)
    zloss = _mean(torch.square(torch.logsumexp(logits, dim=-1)), (0,))
    dropped = 1.0 - _mean(keep.float(), (0,))
    metrics = {
        "moe_aux": aux * m.router_aux_coef,
        "moe_zloss": zloss * m.router_z_coef,
        "moe_drop_frac": dropped,
    }
    return out, metrics
