"""Whisper-base [arXiv:2212.04356; unverified] — encoder-decoder, conv frontend STUB.

6L(enc)+6L(dec) d_model=512 8H (kv=8) d_ff=2048 vocab=51865.
The audio (mel/conv) frontend is a stub: ``input_specs()`` provides precomputed
frame embeddings of shape (batch, seq, d_model).
"""
from repro_torch.configs.base import EncDecConfig, ModelConfig
from repro_torch.configs.registry import register


@register("whisper-base")
def whisper_base() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        num_layers=6,  # per-stack depth; encdec.enc_layers/dec_layers authoritative
        d_model=512,
        num_heads=8,
        num_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab_size=51865,
        encdec=EncDecConfig(enc_layers=6, dec_layers=6, frame_dim=512),
        act="gelu",
        rope_theta=0.0,  # whisper uses learned/sinusoidal positions, not RoPE
        sub_quadratic=False,
        has_decoder=True,
    )
