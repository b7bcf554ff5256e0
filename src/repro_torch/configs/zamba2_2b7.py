"""Zamba2-2.7B [arXiv:2411.15242; hf] — Mamba2 backbone + shared attn blocks.

Hybrid: 54 Mamba2 layers; one SHARED transformer block (attention + MLP)
applied every `hybrid_attn_every` layers (Zamba2's weight-shared global
block, simplified: we share the full block weights across its applications;
the per-application LoRA deltas of the original are omitted — DESIGN.md §5).
Sub-quadratic: runs the long_500k shapes.
"""

from .base import ModelConfig, register


@register("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        n_layers=54,
        d_model=2560,
        n_heads=32,
        n_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab=32000,
        mlp="gelu",
        ssm_state=64,
        ssm_heads=40,        # 2*d_model / headdim=128
        hybrid_attn_every=6, # 9 shared-block applications over 54 layers
        sub_quadratic=True,
    )
