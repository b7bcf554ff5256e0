"""Sequential oracle for the chunked linear recurrence.

The "coarse dataflow" execution of the recurrence: one step at a time,
carrying the ``[K, V]`` state.  Ports `repro/kernels/ssd_scan/ref.py`.
"""

from __future__ import annotations

import torch

__all__ = ["scan_ref"]


def scan_ref(q, k, v, w, s0, *, inclusive: bool = True):
    """q, k, w: ``[BH, L, K]``; v: ``[BH, L, V]``; s0: ``[BH, K, V]``.

    Returns ``(y [BH, L, V] in q's dtype, final state [BH, K, V] f32)``.
    """
    f32, in_dtype = torch.float32, q.dtype
    q, k, v, w = (a.to(f32) for a in (q, k, v, w))
    s = s0.to(f32)
    ys = []
    for t in range(q.shape[1]):
        s_new = s * torch.exp(w[:, t])[..., None] + k[:, t, :, None] * v[:, t, None, :]
        qs = s_new if inclusive else s
        ys.append(torch.einsum("bk,bkv->bv", q[:, t], qs))
        s = s_new
    y = torch.stack(ys, dim=1) if ys else v.new_zeros(v.shape)
    return y.to(in_dtype), s
