from repro_torch.configs.base import (
    CollectiveConfig,
    MeshConfig,
    ModelConfig,
    RunConfig,
    ShapeConfig,
    TrainConfig,
    reduced,
    replace,
)
from repro_torch.configs.registry import arch_names, get_model_config, register

__all__ = [
    "CollectiveConfig",
    "MeshConfig",
    "ModelConfig",
    "RunConfig",
    "ShapeConfig",
    "TrainConfig",
    "arch_names",
    "get_model_config",
    "reduced",
    "register",
    "replace",
]
