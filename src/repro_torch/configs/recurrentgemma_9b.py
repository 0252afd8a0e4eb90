"""RecurrentGemma-9B [arXiv:2402.19427 (Griffin); unverified] — RG-LRU + local attn 1:2.

38L d_model=4096 16H (kv=1, MQA) d_ff=12288 vocab=256000; window 2048.
Pattern: (rec, rec, attn) repeating — 38 = 12*3 + 2 trailing recurrent blocks.
Sub-quadratic: recurrent state + fixed-window KV; long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, RGLRUConfig
from repro_torch.configs.registry import register


@register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab_size=256000,
        rglru=RGLRUConfig(lru_width=4096, window=2048, pattern=("rec", "rec", "attn")),
        act="gelu",  # GeGLU
        tie_embeddings=True,  # gemma-style tied embeddings (256k vocab)
        attn_window=2048,
        sub_quadratic=True,
    )
