"""Global-norm gradient clipping.  Ports `repro/optim/clip.py`.

Works on a sequence of gradient tensors (``None`` entries, parameters that
took no gradient, are skipped) and scales them in place.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.sharding import full_tensor

__all__ = ["global_norm", "clip_by_global_norm"]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32 (0-d tensor; a
    DTensor gradient's sum is reduced over its ranks)."""
    sums = [full_tensor(g.float().square().sum()) for g in grads if g is not None]
    return torch.stack(sums).sum().sqrt()


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """Scale every gradient by ``min(1, max_norm / norm)`` in f32 and cast it
    back to its dtype, in place.  Returns the norm before clipping."""
    grads = [g for g in grads if g is not None]
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in grads:
        s = scale
        if isinstance(g, DTensor):   # the same 0-d scale on every rank
            s = DTensor.from_local(scale, g.device_mesh,
                                   [Replicate()] * g.device_mesh.ndim, run_check=False)
        g.copy_((g.float() * s).to(g.dtype))
    return norm
