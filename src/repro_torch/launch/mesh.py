"""The port's stand-in for ``jax.sharding.Mesh`` on one device.

A ``StackedMesh`` names the mesh axes and their sizes, e.g.
``StackedMesh(data=2, model=4)``. Every axis but ``model`` is a dp axis.
The physical axes are the dp axes and ``model`` where its size is above 1:
their ranks are dim 0 of the stacked tensors, one rank per coordinate,
numbered row-major over those axes in mesh order (the order in which
``PartitionSpec(("pod", "data"))`` lays out shards), so rank
``d * tp + m`` of ``(data, model)`` is data rank d's tensor-parallel rank m.
At ``model=1`` the ranks are the dp ranks alone.
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
        """The physical axes, in mesh order: every dp axis, and ``model``
        where its size is above 1."""
        return tuple(a for a in self.shape if a != TP_AXIS or self.shape[a] > 1)

    @property
    def dp_rank_axes(self) -> tuple[str, ...]:
        """The physical dp axes, in mesh order."""
        return tuple(a for a in self.shape if a != TP_AXIS)

    @property
    def tp(self) -> int:
        return self.shape.get(TP_AXIS, 1)

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
    data=16, model=16)``, stacked: 256 or 512 ranks on the one device."""
    if multi_pod:
        return StackedMesh(pod=2, data=16, model=16)
    return StackedMesh(data=16, model=16)
