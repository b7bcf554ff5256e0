"""Optimizer substrate of the port: AdamW with f32 moments, global-norm
clipping and learning-rate schedules, as functions on a model's tensors."""

from .adamw import adamw_init, adamw_update, OptState  # noqa: F401
from .schedules import cosine_warmup, linear_warmup  # noqa: F401
from .clip import global_norm, clip_by_global_norm  # noqa: F401
