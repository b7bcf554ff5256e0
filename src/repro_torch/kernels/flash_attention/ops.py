"""Public attention op: GQA head mapping and the kernel / plain dispatch.

Ports `repro/kernels/flash_attention/ops.py`.  With ``use_kernels=True``
attention runs `flash_attention_cuda` (its plain twin for CPU tensors);
otherwise exact softmax (`attention_ref`), or the blocked online softmax
above `BLOCKED_ATTN_THRESHOLD` key rows.  The port runs on one device, so
the reference's mesh constraints (`constrain_folded`,
`merged_bh_constraint`) are identities here, kept where the reference
places them for the multi-GPU slice.
"""

from __future__ import annotations

from .kernel import flash_attention_cuda
from .ref import attention_blocked, attention_ref

__all__ = ["gqa_attention", "gqa_attention_folded", "constrain_folded",
           "merged_bh_constraint", "BLOCKED_ATTN_THRESHOLD"]

# the plain path switches to blocked online-softmax attention above this kv length
BLOCKED_ATTN_THRESHOLD = 8192


def constrain_folded(xf, bh: int):
    """Placement of a folded ``[B*H, L, D]`` tensor; one device: unchanged."""
    return xf


def merged_bh_constraint(xf, bh: int):
    """Placement of a merged-BH tensor; one device: unchanged."""
    return constrain_folded(xf, bh)


def gqa_attention_folded(qf, kf, vf, *, batch: int, causal: bool = True,
                         use_kernels: bool = False, block_k: int = 1024):
    """GQA attention in folded space: qf ``[B*Hq, Lq, D]`` (b-major,
    consecutive query heads per kv head), kf, vf ``[B*Hkv, Lk, D]``.

    KV heads are broadcast to query heads by a reshape in the merged dim.
    ``block_k`` is the kv block of the plain blocked path; the kernel
    chooses its own tiles.
    """
    bhq, lq, d = qf.shape
    bhkv, lk, _ = kf.shape
    hq, hkv = bhq // batch, bhkv // batch
    g = hq // hkv
    scale = 1.0 / (d ** 0.5)
    if g > 1:
        def rep(t):
            t = t.reshape(batch, hkv, 1, lk, d).expand(batch, hkv, g, lk, d)
            return t.reshape(bhq, lk, d)
        kf, vf = rep(kf), rep(vf)
    if use_kernels:
        return flash_attention_cuda(qf, kf, vf, scale=scale, causal=causal)
    if lk > BLOCKED_ATTN_THRESHOLD:
        return attention_blocked(qf, kf, vf, scale=scale, causal=causal,
                                 block_k=block_k)
    return attention_ref(qf, kf, vf, scale=scale, causal=causal)


def gqa_attention(q, k, v, *, causal: bool = True, use_kernels: bool = False,
                  block_k: int = 128):
    """Grouped-query attention on ``[B, L, H, D]`` tensors (folds, then
    `gqa_attention_folded`)."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads are not a multiple of {hkv} kv heads")
    fold = lambda x, h: x.transpose(1, 2).reshape(b * h, -1, d)
    qf = constrain_folded(fold(q, hq), b * hq)
    kf = constrain_folded(fold(k, hkv), b * hkv)
    vf = constrain_folded(fold(v, hkv), b * hkv)
    of = gqa_attention_folded(qf, kf, vf, batch=b, causal=causal,
                              use_kernels=use_kernels, block_k=block_k)
    return constrain_folded(of, b * hq).reshape(b, hq, lq, d).transpose(1, 2)
