"""Training step factory (counterpart of ``repro.runtime.train_loop``): the
FSDP train step with gradient accumulation, remat and AdamW, the paper's
gathers wired in through ``ShardCtx`` (fsdp_mode = "xla" | "mcast" |
"mcast_ring" | "mcast_bcast").

Each layer's dp-sharded weights are gathered by the mode's allgather; the
gradient flows back through the gather's exact transpose (the transposed
ring step in the mcast modes), so each shard receives the sum over ranks of
its gradient, the reduce-scatter the reference's AD derives.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import bridge
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import StackedMesh
from repro_torch.models import build_model
from repro_torch.models.layers import dtype_of
from repro_torch.optim import adamw
from repro_torch.sharding.ctx import ShardCtx, use_ctx
from repro_torch.sharding.fsdp import at_use, make_param_gather, trainable
from repro_torch.sharding.specs import Stacked, dp_axes, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: Any           # tree of Stacked leaf tensors (``fsdp.trainable``)
    opt: adamw.OptState


def _dp_size(run: RunConfig, mesh: StackedMesh) -> int:
    n = 1
    for a in dp_axes(run.mesh):
        n *= mesh.shape[a]
    return n


def make_ctx(run: RunConfig, mesh: StackedMesh | None, *,
             for_decode: bool = False) -> ShardCtx:
    """Prefill and training gather per layer with ``run.collective.fsdp_mode``;
    decode uses the plain gather, as the reference leaves decode to GSPMD.
    ``run.collective.prefetch`` takes effect where the reference's does: in
    the mcast modes (the reference installs no gather of its own for
    ``xla``, nor for decode), and only on the training path."""
    if mesh is None:
        return ShardCtx(mesh=None)
    if tuple(dp_axes(run.mesh)) != mesh.rank_axes:
        raise ValueError(f"{mesh} must stack exactly the dp axes {dp_axes(run.mesh)}")
    coll = run.collective
    if for_decode:
        coll = dataclasses.replace(coll, fsdp_mode="xla")
    return ShardCtx(
        mesh=mesh,
        dp_axes=dp_axes(run.mesh),
        tp_axis="model",
        shard_batch=run.shape.global_batch % _dp_size(run, mesh) == 0,
        seq_parallel=not for_decode,
        gather_params=make_param_gather(mesh, run.mesh, coll),
        prefetch_params=coll.prefetch and coll.fsdp_mode != "xla",
    )


def make_train_step(run: RunConfig, mesh: StackedMesh | None, *,
                    device: str | torch.device = "cuda"):
    """Returns (api, ctx, train_step). train_step: (state, batch) ->
    (state, metrics); the state is updated in place and returned."""
    cfg, tc = run.model, run.train
    api = build_model(cfg, remat=tc.remat, device=device)
    ctx = make_ctx(run, mesh)
    n_ranks = 1 if mesh is None else mesh.n_ranks

    def value_and_grad(state: TrainState, batch):
        params = at_use(state.params, n_ranks, ctx.dp_axes)
        loss, metrics = api.loss_fn(params, batch)
        leaves = tree_leaves(state.params)
        grads = torch.autograd.grad(loss, [s.local for s in leaves])
        it = iter(grads)
        return loss.detach(), metrics, tree_map(lambda s: Stacked(next(it), s.spec),
                                                state.params)

    def train_step(state: TrainState, batch):
        with use_ctx(ctx):
            if tc.grad_accum > 1:
                a = tc.grad_accum
                micro = {k: v.reshape(a, v.shape[0] // a, *v.shape[1:])
                         for k, v in batch.items()}
                grads = tree_map(lambda s: Stacked(torch.zeros_like(s.local, dtype=torch.float32),
                                                   s.spec), state.params)
                loss = 0.0
                for i in range(a):
                    mb_loss, _, g = value_and_grad(state, {k: v[i] for k, v in micro.items()})
                    for acc, gg in zip(tree_leaves(grads), tree_leaves(g)):
                        acc.local.add_(gg.local.float())
                    loss = loss + mb_loss
                grads = tree_map(lambda s: Stacked(s.local / a, s.spec), grads)
                loss = loss / a
                metrics = {"xent": loss}
            else:
                loss, metrics, grads = value_and_grad(state, batch)
            params, opt, om = adamw.apply_updates(state.params, grads, state.opt, tc)
            metrics = dict(metrics)
            metrics.update(om)
            metrics["loss"] = loss
        return TrainState(params, opt), metrics

    return api, ctx, train_step


def init_state(run: RunConfig, mesh: StackedMesh | None, tree: dict, *,
               device: str | torch.device = "cuda") -> TrainState:
    """The train state over a dense numpy parameter tree (``bridge``):
    parameters in ``param_dtype`` (norm scales f32), zero f32 moments."""
    params = bridge.to_torch(tree, mesh, run.mesh, dtype=dtype_of(run.model.param_dtype),
                             device=device)
    params = trainable(params, dp_axes(run.mesh))
    return TrainState(params, adamw.init(params))
