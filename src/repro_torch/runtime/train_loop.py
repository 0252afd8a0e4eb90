"""Sharding context of a run (the part of ``repro.runtime.train_loop`` that
serving uses; the training step comes with the training slice)."""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import StackedMesh
from repro_torch.sharding.ctx import ShardCtx
from repro_torch.sharding.fsdp import make_param_gather
from repro_torch.sharding.specs import dp_axes


def _dp_size(run: RunConfig, mesh: StackedMesh) -> int:
    n = 1
    for a in dp_axes(run.mesh):
        n *= mesh.shape[a]
    return n


def make_ctx(run: RunConfig, mesh: StackedMesh | None, *,
             for_decode: bool = False) -> ShardCtx:
    """Prefill and training gather per layer with ``run.collective.fsdp_mode``;
    decode uses the plain gather, as the reference leaves decode to GSPMD."""
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
    )
