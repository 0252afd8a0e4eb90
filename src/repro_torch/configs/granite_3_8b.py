"""Granite-3 8B [hf:ibm-granite/granite-3.0 family; hf] — GQA dense.

40L d_model=4096 32H (kv=8) d_ff=12800 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register("granite-3-8b")
def granite_3_8b() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=12800,
        vocab_size=49155,
        act="swiglu",
        tie_embeddings=True,
        sub_quadratic=False,
    )
