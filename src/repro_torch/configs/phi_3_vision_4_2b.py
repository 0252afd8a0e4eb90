"""Phi-3-vision 4.2B [hf:microsoft/Phi-3-vision-128k-instruct; hf].

phi3-mini backbone: 32L d_model=3072 32H (kv=32) d_ff=8192 vocab=32064.
CLIP vision frontend is a STUB: ``input_specs()`` provides precomputed patch
embeddings (batch, n_patches, patch_dim) projected into the stream.
"""
from repro_torch.configs.base import ModelConfig, VisionStubConfig
from repro_torch.configs.registry import register


@register("phi-3-vision-4.2b")
def phi_3_vision() -> ModelConfig:
    return ModelConfig(
        name="phi-3-vision-4.2b",
        family="vlm",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        vision=VisionStubConfig(n_patches=1024, patch_dim=1024),
        act="swiglu",
        sub_quadratic=False,
    )
