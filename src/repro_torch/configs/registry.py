"""Architecture registry: ``--arch <id>`` resolution and the training
co-simulation's sweep (copy of the JAX package's registry, holding the
architectures the port serves so far)."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_loaded() -> None:
    # import arch modules for their side-effectful @register decorators
    from repro_torch.configs import (  # noqa: F401
        deepseek_moe_16b,
        granite_3_8b,
        granite_34b,
        smollm_135m,
        yi_9b,
    )


def arch_names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def get_model_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


#: GPT-small -> 34B dense span swept by core/train_sim.py's
#: ``sweep_training_runs`` (the reference's training_run_sweep) and the
#: co-simulation's tests
TRAINING_SWEEP_ARCHS: tuple[str, ...] = ("smollm-135m", "yi-9b",
                                         "granite-34b")


def training_sweep_archs() -> tuple[str, ...]:
    _ensure_loaded()
    assert all(a in _REGISTRY for a in TRAINING_SWEEP_ARCHS)
    return TRAINING_SWEEP_ARCHS
