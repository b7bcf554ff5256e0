"""Whisper-base [arXiv:2212.04356; unverified] — enc-dec; conv frontend STUB.

`input_specs()` provides precomputed frame embeddings [B, frames, d_model]
per the assignment; the encoder is bidirectional, the decoder causal with
cross-attention.
"""

from .base import ModelConfig, register


@register("whisper-base")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base",
        family="encdec",
        n_layers=6,
        d_model=512,
        n_heads=8,
        n_kv_heads=8,
        head_dim=64,
        d_ff=2048,
        vocab=51865,
        mlp="gelu",
        enc_layers=6,
        enc_frames=1500,
    )
