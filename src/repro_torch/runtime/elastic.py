"""Elastic scaling: move a train state to a mesh of another size
(counterpart of ``repro.runtime.elastic``).

The sharding rules (``sharding/specs.py``) are pure functions of (leaf name,
shape, mesh), so moving to a grown or shrunk mesh, or to another split
between dp and ``model`` (``(data=2, model=4)`` to ``(data=4, model=2)`` or
``(data=8, model=1)``), is: every leaf's global array on the host (what a
checkpoint holds), then split for the new mesh.
The same placement restores a checkpoint written on one mesh into another
(``checkpoint.restore(..., mesh=, mesh_cfg=)``).
"""
from __future__ import annotations

from repro_torch.checkpoint.ckpt import from_host, host_arrays, place
from repro_torch.configs.base import RunConfig
from repro_torch.launch.mesh import StackedMesh
from repro_torch.runtime.train_loop import TrainState


def reshard_state(state: TrainState, run_new: RunConfig, mesh_new: StackedMesh) -> TrainState:
    """``state`` split as ``mesh_new`` prescribes, on the same device and in
    the same dtypes."""
    arrays = {k: from_host(a, dtype) for k, (a, dtype) in host_arrays(state).items()}
    return place(arrays, state, mesh=mesh_new, mesh_cfg=run_new.mesh)


def scale_plan(old_dp: int, new_dp: int, global_batch: int) -> dict:
    """What changes when the dp extent changes: per-replica batch and the
    grad-accumulation factor that keeps the global batch constant."""
    assert global_batch % old_dp == 0
    plan = {
        "old_per_replica": global_batch // old_dp,
        "new_per_replica": global_batch // new_dp if global_batch % new_dp == 0 else None,
        "needs_accum": global_batch % new_dp != 0,
    }
    return plan
