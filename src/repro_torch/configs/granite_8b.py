"""Granite-8B code [arXiv:2405.04324; hf] — llama-arch dense."""

from .base import ModelConfig, register


@register("granite-8b")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=49152,
        mlp="swiglu",
    )
