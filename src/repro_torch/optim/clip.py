"""Global-norm gradient clipping.  Ports `repro/optim/clip.py`.

Works on a sequence of gradient tensors (``None`` entries, parameters that
took no gradient, are skipped) and scales them in place.
"""

from __future__ import annotations

import torch

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32 (0-d tensor)."""
    sums = [g.float().square().sum() for g in grads if g is not None]
    return torch.stack(sums).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale every gradient by ``min(1, max_norm / norm)`` in f32 and cast it
    back to its dtype, in place.  Returns the norm before clipping."""
    grads = [g for g in grads if g is not None]
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads:
        g.copy_((g.float() * scale).to(g.dtype))
    return norm
