"""Public chunked-scan op: shape handling, decay clamping, RWKV u-bonus.

Ports `repro/kernels/ssd_scan/ops.py`.  `linear_recurrence` is the entry
point of the Mamba2 (and, later, RWKV6) blocks.  It takes ``[B, L, H, D]``
tensors, merges batch and heads, and runs the hand-written kernel
(``use_kernels=True``: `chunked_scan_cuda`, which takes its plain twin for
CPU tensors) or the plain chunked path (`chunked_scan_plain`).  Up to 4
steps (decode) take a direct recurrence.

On a mesh (``flags.mesh``) the inputs are DTensors.  Where "model"
divides the heads, each rank runs the whole function on its own heads
(`_local_heads`): the fold, the scan, the decode steps and the u-bonus
are local, and no head is gathered.  Otherwise the merged ``[B*H, L, D]``
rows are placed as the reference places them (`merged_bh_constraint`),
and the scan runs on each rank's local rows (`sharding.local_rows`), since
every row is an independent recurrence (`flash_attention.ops.row_spec`:
whole sequences per rank); the decode steps and the u-bonus then run as
DTensor ops on whole heads.

Unlike the reference it takes no ``chunk``: both scan paths walk 64-row
tiles (`kernel.TILE`) and zero-pad only the last one, so a sequence is
padded to a multiple of 64, never of a larger chunk, and the result is the
same function the reference computes under any chunk.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (
    dp_size,
    fold_heads,
    heads_split,
    like,
    local_rows,
    partial_on,
    placements,
    unflatten_rows,
    unfold_heads,
    unshard,
    unshard_grad,
)
from repro_torch.kernels.flash_attention.ops import merged_bh_constraint, row_spec

from .kernel import chunked_scan_cuda, chunked_scan_plain

__all__ = ["linear_recurrence", "MIN_LOG_DECAY"]

# exp(-MIN_LOG_DECAY * 64) must stay inside f32: 64 * 0.25 = 16 -> e^16 ~ 9e6,
# over the kernel's 64-row tile (kernel.TILE).
MIN_LOG_DECAY = -0.25


def _bonus(q, k, v, u_bonus):
    """RWKV diagonal bonus: (q_t . (u ⊙ k_t)) v_t, in f32."""
    f32 = torch.float32
    q, k, v = (unshard(t, 2) for t in (q, k, v))   # heads whole: the product merges them
    gate = torch.einsum("blhk,hk,blhk->blh", q.to(f32), u_bonus.to(f32), k.to(f32))
    return unshard_grad(gate, 2)[..., None] * v.to(f32)


def _zeros(ref, shape):
    """f32 zeros of ``shape`` beside ``ref`` (replicated on its mesh)."""
    return like(ref, torch.zeros(shape, device=ref.device))


def linear_recurrence(q, k, v, log_decay, s0=None, u_bonus=None, *,
                      inclusive: bool = True, use_kernels: bool = False, flags=None):
    """q, k, log_decay: ``[B, L, H, K]``; v: ``[B, L, H, V]``; s0:
    ``[B, H, K, V]`` or None (zeros); u_bonus: ``[H, K]`` (RWKV, exclusive).

    Returns ``(y [B, L, H, V] in q's dtype, final state [B, H, K, V] f32)``.
    The log-decay is clamped to ``[MIN_LOG_DECAY, 0]``.
    """
    b, seq, h, kdim = q.shape
    if flags is not None and flags.mesh is not None and heads_split(flags.mesh, h):
        return _local_heads(q, k, v, log_decay, s0, u_bonus, inclusive, use_kernels,
                            flags)
    vdim = v.shape[-1]
    in_dtype, f32 = q.dtype, torch.float32
    w = log_decay.clamp(MIN_LOG_DECAY, 0.0)

    if seq <= 4:
        # decode fast path: direct recurrence steps -- padding a 1-token
        # decode to a full tile would waste 64/seq x compute and memory;
        # heads whole on every rank, as the products merge them
        q, k, v, w = (unshard(t, 2) for t in (q, k, v, w))
        s0 = None if s0 is None else unshard(s0, 1)
        s = _zeros(q, (b, h, kdim, vdim)) if s0 is None else s0.to(f32)
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

    merge = lambda x: merged_bh_constraint(fold_heads(x).to(f32).contiguous(), flags, b * h)
    qm, km, wm, vm = merge(q), merge(k), merge(w), merge(v)
    s0m = (_zeros(qm, (b * h, kdim, vdim)) if s0 is None
           else s0.reshape(b * h, kdim, vdim).to(f32).contiguous())
    s0m = merged_bh_constraint(s0m, flags, b * h)
    kernel = chunked_scan_cuda if use_kernels else chunked_scan_plain
    scan = lambda *a: kernel(*a, inclusive=inclusive)
    if flags is not None and flags.mesh is not None:
        scan = local_rows(scan, flags.mesh, row_spec(flags, b * h, seq), 5, 2)
    y, sf = scan(qm, km, vm, wm, s0m)

    y = unfold_heads(y, flags, b)
    if u_bonus is not None:
        y = y + _bonus(q, k, v, u_bonus)
    return y.to(in_dtype), unflatten_rows(sf, flags, b)


def _local_heads(q, k, v, log_decay, s0, u_bonus, inclusive, use_kernels, flags):
    """`linear_recurrence` on each rank's own heads (`local_map`): the batch
    over dp (when it divides), the heads over "model", each rank folding
    and scanning its shard as a plain tensor.  Inputs whole on "model" are
    cut there (no data moves); the u-bonus, a parameter replicated over dp,
    takes each dp rank's share of its gradient."""
    from torch.distributed.tensor.experimental import local_map

    mesh = flags.mesh
    bspec = tuple(flags.dp) if q.shape[0] % dp_size(mesh) == 0 else None
    x_plc = placements(mesh, (bspec, None, "model", None))
    s_plc = placements(mesh, (bspec, "model", None, None))
    u_plc = placements(mesh, ("model", None))
    u_grad = partial_on(u_plc, mesh, flags.dp if bspec else ())
    opt = lambda t, plc: None if t is None else plc

    def body(q, k, v, w, s0, u):
        return linear_recurrence(q, k, v, w, s0, u, inclusive=inclusive,
                                 use_kernels=use_kernels)

    ins = (x_plc,) * 4 + (opt(s0, s_plc),)
    return local_map(body, out_placements=(x_plc, s_plc),
                     in_placements=ins + (opt(u_bonus, u_plc),),
                     in_grad_placements=ins + (opt(u_bonus, u_grad),),
                     device_mesh=mesh, redistribute_inputs=True)(
        q, k, v, log_decay, s0, u_bonus)
