"""AdamW with global-norm clipping and a warmup-cosine schedule
(counterpart of ``repro.optim.adamw``).

The trees are the train state's trees of ``Stacked`` leaves
(``sharding.fsdp.trainable``): a dp-sharded leaf is its stacked shards
(R, *local), a replicated leaf its one tensor. The moments live beside the
shards in the same layout, in f32 (ZeRO: no collective beyond the gathers'
backward). So the global norm counts every shard and every replicated
tensor once, as the reference's norm over its global arrays does. The step
updates parameters and moments in place.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.sharding.specs import Stacked, tree_leaves, tree_map


class OptState(NamedTuple):
    m: Any
    v: Any
    step: int


def init(params, dtype: torch.dtype = torch.float32) -> OptState:
    def zeros(s: Stacked) -> Stacked:
        return Stacked(torch.zeros(s.local.shape, dtype=dtype, device=s.local.device), s.spec)

    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params), step=0)


def lr_schedule(step: int, tc: TrainConfig) -> float:
    """Linear warmup, then cosine decay to 0.1x, in f32 like the reference."""
    f = np.float32
    warm = min(f(step) / f(max(tc.warmup_steps, 1)), f(1.0))
    prog = np.clip((f(step) - f(tc.warmup_steps)) / f(max(tc.steps - tc.warmup_steps, 1)),
                   f(0.0), f(1.0))
    cos = f(0.5) * (f(1.0) + np.cos(f(np.pi) * prog))
    return float(f(tc.learning_rate) * warm * (f(0.1) + f(0.9) * cos))


def global_norm(tree) -> torch.Tensor:
    sq = sum(torch.sum(torch.square(s.local.float())) for s in tree_leaves(tree))
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda s: Stacked(s.local * scale.to(s.local.dtype), s.spec), grads), gn


@torch.no_grad()
def apply_updates(params, grads, opt: OptState, tc: TrainConfig):
    """One AdamW step, in place on ``params`` and the moments. Returns
    (params, new opt state, metrics)."""
    grads, gn = clip_by_global_norm(grads, tc.grad_clip)
    step = opt.step + 1
    lr = lr_schedule(step, tc)
    b1, b2 = tc.beta1, tc.beta2
    c1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(step))
    c2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(step))
    for p, g, m, v in zip(*(tree_leaves(t) for t in (params, grads, opt.m, opt.v))):
        p, g, m, v = p.local, g.local, m.local, v.local
        g32 = g.float()
        m.copy_(b1 * m + (1 - b1) * g32)
        v.copy_(b2 * v + (1 - b2) * torch.square(g32))
        delta = (m / c1) / (torch.sqrt(v / c2) + tc.eps) + tc.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, OptState(opt.m, opt.v, step), {"grad_norm": gn, "lr": lr}
