"""Sequence models of the port: every family of the JAX package's zoo
(dense, moe, vlm, encdec, ssm, hybrid), one module per family in `model`."""

from . import moe, rwkv6  # noqa: F401
from .convert import params_from_jax  # noqa: F401
from .layers import RuntimeFlags  # noqa: F401
from .model import (  # noqa: F401
    LM,
    MODELS,
    HybridLM,
    decode_step,
    init_cache,
    init_params,
    prefill,
)
