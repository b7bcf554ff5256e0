"""Learning-rate schedules (pure functions of the step counter).

Ports `repro/optim/schedules.py`.  The step is a Python int and the
arithmetic is float32, as the reference computes it on device, so the
learning rate a step takes carries the same rounding; the result is a
Python float.
"""

from __future__ import annotations

import numpy as np

__all__ = ["linear_warmup", "cosine_warmup"]

_F32 = np.float32


def linear_warmup(step: int, base_lr: float, warmup: int) -> float:
    s = _F32(step)
    return float(_F32(base_lr) * min(_F32(1.0), (s + _F32(1.0)) / _F32(max(1, warmup))))


def cosine_warmup(step: int, base_lr: float, warmup: int, total: int,
                  final_frac: float = 0.1) -> float:
    s = _F32(step)
    warm = min(_F32(1.0), (s + _F32(1.0)) / _F32(max(1, warmup)))
    prog = np.clip((s - _F32(warmup)) / _F32(max(1, total - warmup)), _F32(0.0), _F32(1.0))
    cos = _F32(final_frac) + _F32(1 - final_frac) * _F32(0.5) * (
        _F32(1.0) + np.cos(_F32(np.pi) * prog))
    return float(_F32(base_lr) * warm * cos)
