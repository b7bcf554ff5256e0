"""RWKV6 "Finch" 1.6B [arXiv:2404.05892; unverified] — attention-free,
data-dependent decay.  Executed with the medium-granularity chunked scan
(the paper technique's sequence-model instantiation, DESIGN.md §1/§3).
Sub-quadratic: runs the long_500k shapes.
"""

from .base import ModelConfig, register


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        family="ssm",
        n_layers=24,
        d_model=2048,
        n_heads=0,           # attention-free
        n_kv_heads=0,
        d_ff=7168,
        vocab=65536,
        mlp="gelu",          # channel-mix uses squared-relu; see models/rwkv6
        ssm_state=64,        # per-head key width
        ssm_heads=32,        # d_model / 64
        sub_quadratic=True,
    )
