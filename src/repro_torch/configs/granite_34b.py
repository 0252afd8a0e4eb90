"""Granite-34B code [arXiv:2405.04324; hf] — llama-arch MQA dense.

88L d_model=6144 48H (kv=1, MQA) d_ff=24576 vocab=49152.
Largest dense arch in the pool — the FSDP-allgather stress case.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register("granite-34b")
def granite_34b() -> ModelConfig:
    return ModelConfig(
        name="granite-34b",
        family="dense",
        num_layers=88,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        act="gelu",  # granite code models use GPT-style MLP
        sub_quadratic=False,
    )
