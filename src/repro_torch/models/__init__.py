from repro_torch.models.model_builder import ModelApi, batch_dims, build_model

__all__ = ["ModelApi", "batch_dims", "build_model"]
