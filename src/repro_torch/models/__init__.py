"""Sequence models of the port (the ``hybrid`` family, Zamba2, so far)."""

from .convert import params_from_jax  # noqa: F401
from .layers import RuntimeFlags  # noqa: F401
from .model import (  # noqa: F401
    HybridLM,
    decode_step,
    init_cache,
    init_params,
    prefill,
)
