"""The port's stand-in for ``jax.sharding.Mesh`` on one device.

A ``StackedMesh`` names the mesh axes and their sizes, e.g.
``StackedMesh(data=8, model=1)``. Every axis but ``model`` is a dp axis and
physical: its ranks are dim 0 of the stacked tensors, numbered row-major over
those axes in mesh order (the order in which ``PartitionSpec(("pod",
"data"))`` lays out shards). ``model`` is layout only, as it is in the
reference at tp = 1: tensors stay whole along it.
"""
from __future__ import annotations

import math

TP_AXIS = "model"


class StackedMesh:
    def __init__(self, **axes: int):
        if not axes:
            raise ValueError("a mesh needs at least one axis")
        for name, size in axes.items():
            if size < 1:
                raise ValueError(f"axis {name!r} has size {size}")
        self.shape: dict[str, int] = dict(axes)

    @property
    def rank_axes(self) -> tuple[str, ...]:
        """The physical axes, in mesh order: every axis but ``model``."""
        return tuple(a for a in self.shape if a != TP_AXIS)

    @property
    def n_ranks(self) -> int:
        return math.prod(self.shape[a] for a in self.rank_axes)

    def __repr__(self) -> str:
        inner = ", ".join(f"{a}={s}" for a, s in self.shape.items())
        return f"StackedMesh({inner})"


def make_local_mesh(*, multi_pod: bool = False) -> StackedMesh:
    """Eight stacked dp ranks: ``(data=8)``, or ``(pod=2, data=4)`` for a
    multi-pod run; ``model`` is 1."""
    if multi_pod:
        return StackedMesh(pod=2, data=4, model=1)
    return StackedMesh(data=8, model=1)


def make_production_mesh(*, multi_pod: bool = False) -> StackedMesh:
    """The reference's production mesh, ``(data=16, model=16)`` or ``(pod=2,
    data=16, model=16)``, stacked: 16 or 32 ranks on the one device;
    ``model`` stays layout only."""
    if multi_pod:
        return StackedMesh(pod=2, data=16, model=16)
    return StackedMesh(data=16, model=16)
