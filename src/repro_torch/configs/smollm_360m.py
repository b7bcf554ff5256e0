"""SmolLM-360M [hf:HuggingFaceTB/SmolLM-135M family; hf] — llama-arch small."""

from .base import ModelConfig, register


@register("smollm-360m")
def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        n_layers=32,
        d_model=960,
        n_heads=15,
        n_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab=49152,
        mlp="swiglu",
        tie_embeddings=True,
    )
