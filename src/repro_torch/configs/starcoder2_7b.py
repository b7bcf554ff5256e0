"""StarCoder2-7B [arXiv:2402.19173; hf] — dense GQA+RoPE code LM."""

from .base import ModelConfig, register


@register("starcoder2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        family="dense",
        n_layers=32,
        d_model=4608,
        n_heads=36,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab=49152,
        mlp="gelu",          # starcoder2 uses gelu MLPs
        rope_theta=1e5,
    )
