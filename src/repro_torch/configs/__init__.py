"""Architecture registry: one module per assigned arch (+ the paper's own).

Use `get_config("<arch-id>")` or `--arch <id>` on the launchers.
"""

from .base import ModelConfig, get_config, list_archs, register  # noqa: F401

# the 10 assigned architectures (the dry-run grid); extra registry entries
# (lm-100m, ...) are example/aux configs
ASSIGNED_ARCHS = (
    "starcoder2-7b", "phi3-medium-14b", "smollm-360m", "granite-8b",
    "llama-3.2-vision-11b", "zamba2-2.7b", "rwkv6-1.6b", "whisper-base",
    "granite-moe-1b-a400m", "arctic-480b",
)

_LOADED = False


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        arctic_480b,
        lm_100m,
        granite_8b,
        granite_moe_1b,
        llama32_vision_11b,
        phi3_medium_14b,
        rwkv6_1b6,
        smollm_360m,
        starcoder2_7b,
        whisper_base,
        zamba2_2b7,
    )
