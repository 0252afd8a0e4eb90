"""Architecture registry: ``--arch <id>`` resolution (copy of the JAX
package's registry, holding the architectures the port serves so far)."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import ModelConfig

_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def _ensure_loaded() -> None:
    # import arch modules for their side-effectful @register decorators
    from repro_torch.configs import deepseek_moe_16b, smollm_135m  # noqa: F401


def arch_names() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def get_model_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()
