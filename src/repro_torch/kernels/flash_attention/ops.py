"""Public attention op: GQA head mapping, the kernel / plain dispatch and
the placements of folded tensors on a device mesh.

Ports `repro/kernels/flash_attention/ops.py`.  With ``use_kernels=True``
attention runs `flash_attention_cuda` (its plain twin for CPU tensors);
otherwise exact softmax (`attention_ref`), or the blocked online softmax
above `BLOCKED_ATTN_THRESHOLD` key rows.

On a mesh (``flags.mesh``) the folded ``[B*H, L, D]`` tensors are DTensors
placed by `attention_fold_specs`, and the kernel (or its plain version)
runs on each rank's local rows (`sharding.local_rows`, over `local_map`).  The kernel masks
causally with key column <= query row and no offset, so a rank must hold
whole query sequences: where the fold specs split the query sequence over
"model" (priority 2), the call redistributes to B*H over dp only
(priority 3) around the kernel and back.
"""

from __future__ import annotations

import numpy as np

from repro_torch.distributed.sharding import (
    fold_heads,
    local_rows,
    mesh_axes,
    placements,
    repeat_rows,
    unfold_heads,
)

from .kernel import flash_attention_cuda
from .ref import attention_blocked, attention_ref

__all__ = ["gqa_attention", "gqa_attention_folded", "constrain_folded",
           "merged_bh_constraint", "attention_fold_specs", "row_spec",
           "BLOCKED_ATTN_THRESHOLD"]

# the plain path switches to blocked online-softmax attention above this kv length
BLOCKED_ATTN_THRESHOLD = 8192


def _axis_sizes(flags):
    axes = mesh_axes(flags.mesh)
    dp = tuple(flags.dp)
    dp_n = int(np.prod([axes[a] for a in dp]))
    model_n = int(axes.get("model", 1))
    return dp, dp_n, model_n


def attention_fold_specs(flags, bh: int, lq: int, is_kv: bool = False):
    """Sharding policy for folded [B*H, L, D] attention tensors.

    Priority:
      1. merged batch*head over ALL axes (always even, no head padding) when
         bh divides dp*model;
      2. otherwise bh over dp + QUERY SEQUENCE over model (sequence-parallel
         attention); kv tensors stay batch-sharded only (their sequence dim
         is the contraction);
      3. otherwise bh over dp only;
      4. otherwise no constraint.
    Returns a spec (a tuple of axis names per dim) or None.
    """
    if flags is None or getattr(flags, "mesh", None) is None:
        return None
    dp, dp_n, model_n = _axis_sizes(flags)
    if bh % (dp_n * model_n) == 0:
        return ((*dp, "model"), None, None)
    if bh % dp_n == 0 and lq % model_n == 0 and not is_kv:
        return (dp, "model", None)
    if bh % dp_n == 0:
        return (dp, None, None)
    return None


def row_spec(flags, bh: int, lq: int):
    """The fold spec with whole rows on each rank: priority 2 (the query
    sequence over "model") becomes priority 3 (B*H over dp only).  What a
    local kernel call needs: the attention kernel's causal mask has no
    query offset, and each row of the scan is one recurrence."""
    spec = attention_fold_specs(flags, bh, lq)
    if spec is not None and spec[1] is not None:
        spec = (spec[0], None, None)
    return spec


def constrain_folded(xf, flags, bh: int, is_kv: bool = False):
    """Place a folded ``[B*H, L, D]`` DTensor per `attention_fold_specs`;
    unchanged without a mesh or a fitting spec."""
    spec = attention_fold_specs(flags, bh, xf.shape[1], is_kv=is_kv)
    if spec is None:
        return xf
    return xf.redistribute(flags.mesh, placements(flags.mesh, spec))


def merged_bh_constraint(xf, flags, bh: int):
    """Constrain a folded [B*H, L, D] tensor per `attention_fold_specs`."""
    return constrain_folded(xf, flags, bh)


def gqa_attention_folded(qf, kf, vf, *, batch: int, causal: bool = True,
                         use_kernels: bool = False, block_k: int = 1024, flags=None):
    """GQA attention in folded space: qf ``[B*Hq, Lq, D]`` (b-major,
    consecutive query heads per kv head), kf, vf ``[B*Hkv, Lk, D]``.

    KV heads are broadcast to query heads by a reshape in the merged dim.
    ``block_k`` is the kv block of the plain blocked path; the kernel
    chooses its own tiles.  On a mesh the call runs on local rows placed by
    `row_spec`.
    """
    bhq, lq, d = qf.shape
    bhkv, lk, _ = kf.shape
    hq, hkv = bhq // batch, bhkv // batch
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    if g > 1:
        kf, vf = repeat_rows(kf, flags, batch, g), repeat_rows(vf, flags, batch, g)

    def attend(q, k, v):
        if use_kernels:
            return flash_attention_cuda(q, k, v, scale=scale, causal=causal)
        if lk > BLOCKED_ATTN_THRESHOLD:
            return attention_blocked(q, k, v, scale=scale, causal=causal,
                                     block_k=block_k)
        return attention_ref(q, k, v, scale=scale, causal=causal)

    if flags is None or flags.mesh is None:
        return attend(qf, kf, vf)
    return local_rows(attend, flags.mesh, row_spec(flags, bhq, lq), 3)(qf, kf, vf)


def gqa_attention(q, k, v, *, causal: bool = True, use_kernels: bool = False,
                  block_k: int = 128, flags=None):
    """Grouped-query attention on ``[B, L, H, D]`` tensors (folds, then
    `gqa_attention_folded`)."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} kv heads")
    qf = constrain_folded(fold_heads(q), flags, b * hq)
    kf = constrain_folded(fold_heads(k), flags, b * hkv, is_kv=True)
    vf = constrain_folded(fold_heads(v), flags, b * hkv, is_kv=True)
    of = gqa_attention_folded(qf, kf, vf, batch=b, causal=causal,
                              use_kernels=use_kernels, block_k=block_k, flags=flags)
    return unfold_heads(constrain_folded(of, flags, b * hq), flags, b)
