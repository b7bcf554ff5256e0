"""Llama-3.2-11B-Vision [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

Transformer BACKBONE only per the assignment: the vision frontend is a stub
(`input_specs()` provides precomputed patch embeddings); every
`cross_attn_every`-th decoder layer cross-attends to them.
"""

from .base import ModelConfig, register


@register("llama-3.2-vision-11b")
def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        n_layers=40,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=128256,
        mlp="swiglu",
        rope_theta=5e5,
        cross_attn_every=5,   # 8 cross-attn layers in 40
        vision_tokens=1601,
        vision_dim=1280,
    )
