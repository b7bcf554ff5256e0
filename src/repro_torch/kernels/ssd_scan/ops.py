"""Public chunked-scan op: shape handling, decay clamping, RWKV u-bonus.

Ports `repro/kernels/ssd_scan/ops.py`.  `linear_recurrence` is the entry
point of the Mamba2 (and, later, RWKV6) blocks.  It takes ``[B, L, H, D]``
tensors, merges batch and heads, and runs the hand-written kernel
(``use_kernels=True``: `chunked_scan_cuda`, which takes its plain twin for
CPU tensors) or the plain chunked path (`chunked_scan_plain`).  Up to 4
steps (decode) take a direct recurrence.

Unlike the reference it takes no ``chunk``: both scan paths walk 64-row
tiles (`kernel.TILE`) and zero-pad only the last one, so a sequence is
padded to a multiple of 64, never of a larger chunk, and the result is the
same function the reference computes under any chunk.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ops import merged_bh_constraint

from .kernel import chunked_scan_cuda, chunked_scan_plain

__all__ = ["linear_recurrence", "MIN_LOG_DECAY"]

# exp(-MIN_LOG_DECAY * 64) must stay inside f32: 64 * 0.25 = 16 -> e^16 ~ 9e6,
# over the kernel's 64-row tile (kernel.TILE).
MIN_LOG_DECAY = -0.25


def _bonus(q, k, v, u_bonus):
    """RWKV diagonal bonus: (q_t . (u ⊙ k_t)) v_t, in f32."""
    f32 = torch.float32
    gate = torch.einsum("blhk,hk,blhk->blh", q.to(f32), u_bonus.to(f32), k.to(f32))
    return gate[..., None] * v.to(f32)


def linear_recurrence(q, k, v, log_decay, s0=None, u_bonus=None, *,
                      inclusive: bool = True, use_kernels: bool = False):
    """q, k, log_decay: ``[B, L, H, K]``; v: ``[B, L, H, V]``; s0:
    ``[B, H, K, V]`` or None (zeros); u_bonus: ``[H, K]`` (RWKV, exclusive).

    Returns ``(y [B, L, H, V] in q's dtype, final state [B, H, K, V] f32)``.
    The log-decay is clamped to ``[MIN_LOG_DECAY, 0]``.
    """
    b, seq, h, kdim = q.shape
    vdim = v.shape[-1]
    in_dtype, f32 = q.dtype, torch.float32
    w = log_decay.clamp(MIN_LOG_DECAY, 0.0)

    if seq <= 4:
        # decode fast path: direct recurrence steps -- padding a 1-token
        # decode to a full tile would waste 64/seq x compute and memory
        s = (q.new_zeros((b, h, kdim, vdim), dtype=f32) if s0 is None
             else s0.to(f32))
        ys = []
        for t in range(seq):
            qt, kt, vt, wt = (a[:, t].to(f32) for a in (q, k, v, w))
            if not inclusive:
                y = torch.einsum("bhk,bhkv->bhv", qt, s)
            s = s * torch.exp(wt)[..., None] + kt[..., None] * vt[..., None, :]
            if inclusive:
                y = torch.einsum("bhk,bhkv->bhv", qt, s)
            ys.append(y)
        y = torch.stack(ys, dim=1)                      # [B, seq, H, V]
        if u_bonus is not None:
            y = y + _bonus(q, k, v, u_bonus)
        return y.to(in_dtype), s

    def merge(x, d):
        x = x.transpose(1, 2).reshape(b * h, seq, d).to(f32).contiguous()
        return merged_bh_constraint(x, b * h)

    qm, km, wm, vm = merge(q, kdim), merge(k, kdim), merge(w, kdim), merge(v, vdim)
    s0m = (qm.new_zeros((b * h, kdim, vdim)) if s0 is None
           else s0.reshape(b * h, kdim, vdim).to(f32).contiguous())
    scan = chunked_scan_cuda if use_kernels else chunked_scan_plain
    y, sf = scan(qm, km, vm, wm, merged_bh_constraint(s0m, b * h), inclusive=inclusive)

    y = y.reshape(b, h, seq, vdim).transpose(1, 2)
    if u_bonus is not None:
        y = y + _bonus(q, k, v, u_bonus)
    return y.to(in_dtype), sf.reshape(b, h, kdim, vdim)
