"""Decoupled AdamW with f32 moments.  Ports `repro/optim/adamw.py`.

The state holds ``m`` and ``v`` per named parameter, float32 whatever the
parameter's dtype, and the step counter (a Python int).  `adamw_update`
reads each parameter's ``.grad`` (None counts as a zero gradient, as the
reference's gradient of an unused leaf is zero) and updates the parameter
and its moments in place with the reference's formula:

    step += 1;  c1 = 1 - b1**step;  c2 = 1 - b2**step   (float32)
    m = b1*m + (1-b1)*g;  v = b2*v + (1-b2)*g*g
    p = p - lr * ((m/c1) / (sqrt(v/c2) + eps) + wd*p)   (f32, cast to p.dtype)

Weight decay applies to every parameter, norm gains included, as in the
reference.  ``torch.optim.AdamW`` is not used: it keeps its moments in the
parameter's dtype and applies the decay as a separate step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["OptState", "adamw_init", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    """AdamW's hyperparameters, the reference's fields and defaults."""
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1


OptState = dict  # {"m": {name: tensor}, "v": {name: tensor}, "step": int}


def adamw_init(model: torch.nn.Module) -> OptState:
    # zeros_like keeps a DTensor parameter's placements
    zeros = lambda: {name: torch.zeros_like(p, dtype=torch.float32).detach()
                     for name, p in model.named_parameters()}
    return {"m": zeros(), "v": zeros(), "step": 0}


@torch.no_grad()
def adamw_update(model: torch.nn.Module, state: OptState, lr: float, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1) -> OptState:
    """One AdamW step over ``model``'s parameters with their ``.grad``;
    updates the parameters and ``state`` in place and returns ``state``."""
    f32 = np.float32
    step = state["step"] + 1
    c1 = float(f32(1.0) - f32(b1) ** f32(step))
    c2 = float(f32(1.0) - f32(b2) ** f32(step))
    for name, p in model.named_parameters():
        m, v = state["m"][name], state["v"][name]
        g = p.grad.float() if p.grad is not None else torch.zeros_like(m)
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        p32 = p.float()
        upd = (m / c1) / ((v / c2).sqrt() + eps) + weight_decay * p32
        p.copy_((p32 - lr * upd).to(p.dtype))
    state["step"] = step
    return state
