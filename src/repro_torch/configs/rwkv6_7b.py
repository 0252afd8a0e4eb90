"""RWKV6 "Finch" 7B — attention-free, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=4096 d_ff=14336 vocab=65536, head_size 64 (=> 64 WKV heads).
Sub-quadratic: O(1) state per token at decode; long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, RWKVConfig
from repro_torch.configs.registry import register


@register("rwkv6-7b")
def rwkv6_7b() -> ModelConfig:
    d_model = 4096
    head_size = 64
    return ModelConfig(
        name="rwkv6-7b",
        family="rwkv",
        num_layers=32,
        d_model=d_model,
        num_heads=d_model // head_size,
        num_kv_heads=d_model // head_size,
        head_dim=head_size,
        d_ff=14336,
        vocab_size=65536,
        rwkv=RWKVConfig(head_size=head_size, chunk_size=32, decay_lora=64, tokenshift_lora=32),
        act="relu_sq",  # RWKV channel-mix uses squared-ReLU
        sub_quadratic=True,
    )
