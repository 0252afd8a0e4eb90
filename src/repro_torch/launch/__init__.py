from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.train_sim import (H100, TPU_V5E, ChipConstants, LayerProfile,
                                          TrainingRunResult, derive_layer_profiles,
                                          make_fabric, simulate_training_run,
                                          sweep_training_runs)

__all__ = [
    "make_production_mesh",
    "H100",
    "TPU_V5E",
    "ChipConstants",
    "LayerProfile",
    "TrainingRunResult",
    "derive_layer_profiles",
    "make_fabric",
    "simulate_training_run",
    "sweep_training_runs",
]
