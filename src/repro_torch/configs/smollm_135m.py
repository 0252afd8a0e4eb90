"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M; hf] — small llama-arch GQA.

30L d_model=576 9H (kv=3) d_ff=1536 vocab=49152.
9 heads are not divisible by model=16: attention TP is head-replicated
(GSPMD pads), FFN/vocab shard cleanly.
"""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register("smollm-135m")
def smollm_135m() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m",
        family="dense",
        num_layers=30,
        d_model=576,
        num_heads=9,
        num_kv_heads=3,
        head_dim=64,
        d_ff=1536,
        vocab_size=49152,
        act="swiglu",
        tie_embeddings=True,
        sub_quadratic=False,
    )
