"""~100M-param llama-style LM for the end-to-end training example
(examples/train_lm.py).  Not part of the 10 assigned archs."""

from .base import ModelConfig, register


@register("lm-100m")
def config() -> ModelConfig:
    return ModelConfig(
        name="lm-100m",
        family="dense",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab=32768,
        mlp="swiglu",
        tie_embeddings=True,
    )
