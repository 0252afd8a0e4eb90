from repro_torch.configs.base import (
    CollectiveConfig,
    SHAPES,
    MeshConfig,
    ModelConfig,
    RunConfig,
    ShapeConfig,
    TrainConfig,
    reduced,
    replace,
)
from repro_torch.configs.registry import (TRAINING_SWEEP_ARCHS, arch_names, get_model_config,
                                          get_shape, register, training_sweep_archs)

__all__ = [
    "CollectiveConfig",
    "MeshConfig",
    "ModelConfig",
    "RunConfig",
    "SHAPES",
    "ShapeConfig",
    "TrainConfig",
    "TRAINING_SWEEP_ARCHS",
    "arch_names",
    "get_model_config",
    "get_shape",
    "reduced",
    "register",
    "replace",
    "training_sweep_archs",
]
