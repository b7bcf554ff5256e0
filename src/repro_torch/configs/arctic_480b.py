"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base; hf].

Dense-MoE hybrid: every layer has a dense residual FFN in PARALLEL with a
128-expert top-2 MoE FFN.
"""

from .base import ModelConfig, register


@register("arctic-480b")
def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        n_layers=35,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab=32000,
        mlp="swiglu",
        moe_experts=128,
        moe_topk=2,
        moe_dense_residual=True,
    )
