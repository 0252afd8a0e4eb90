"""DeepSeekMoE-16B [arXiv:2401.06066; hf] — fine-grained MoE.

28L d_model=2048 16H (kv=16) d_ff=1408/expert vocab=102400,
2 shared + 64 routed experts, top-6 routing.

Recorded deviation (DESIGN.md §5): the real model's dense layer-0 FFN is
regularized to a uniform MoE stack to keep scan-over-layers homogeneous.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.configs.registry import register


@register("deepseek-moe-16b")
def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=102400,
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
