"""Moonshot/Moonlight 16B-A3B [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (kv=16) d_ff=1408/expert vocab=163840, MoE 64e top-6
(+2 shared, deepseek-v3-style fine-grained experts).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import register


@register("moonshot-v1-16b-a3b")
def moonshot_v1_16b_a3b() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163840,
        moe=MoEConfig(
            n_routed_experts=64,
            n_shared_experts=2,
            top_k=6,
            d_ff_expert=1408,
            capacity_factor=1.25,
        ),
        act="swiglu",
        sub_quadratic=False,
    )
