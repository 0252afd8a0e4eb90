from repro_torch.models.model_builder import (
    ModelApi,
    batch_dims,
    build_model,
    chunked_xent,
    count_params_analytic,
    make_dummy_batch,
)

__all__ = [
    "ModelApi",
    "batch_dims",
    "build_model",
    "chunked_xent",
    "count_params_analytic",
    "make_dummy_batch",
]
