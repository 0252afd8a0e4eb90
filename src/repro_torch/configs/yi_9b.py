"""Yi-9B [arXiv:2403.04652; hf] — llama-arch GQA dense.

48L d_model=4096 32H (kv=4) d_ff=11008 vocab=64000.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register("yi-9b")
def yi_9b() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        act="swiglu",
        sub_quadratic=False,
    )
