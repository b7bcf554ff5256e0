"""Plain oracles: exact softmax attention and its blocked (online-softmax)
variant for long sequences.  Ports `repro/kernels/flash_attention/ref.py`.

`attention_blocked` is the path without a kernel for long key lengths: a
loop over kv blocks carrying (running max, normaliser, accumulator), so the
``[L, L]`` score matrix is never materialised.  Causal masking is applied
per block (fully masked blocks still run, as in the reference).
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_blocked", "NEG_INF"]

NEG_INF = -1e30


def attention_ref(q, k, v, *, scale: float, causal: bool = True):
    """q: ``[BH, Lq, D]``; k, v: ``[BH, Lk, D]``.  Exact softmax in f32."""
    f32 = torch.float32
    s = torch.einsum("bqd,bkd->bqk", q.to(f32) * scale, k.to(f32))
    if causal:
        lq, lk = s.shape[-2], s.shape[-1]
        rows = torch.arange(lq, device=q.device)[:, None]
        mask = rows >= torch.arange(lk, device=q.device)[None, :]
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.to(f32)).to(q.dtype)


def attention_blocked(q, k, v, *, scale: float, causal: bool = True,
                      block_k: int = 1024):
    """Online softmax over kv blocks of ``block_k`` rows (any device)."""
    f32 = torch.float32
    bh, lq, d = q.shape
    lk = k.shape[1]
    qf = q.to(f32) * scale
    rows = torch.arange(lq, device=q.device)[None, :, None]
    m = q.new_full((bh, lq), NEG_INF, dtype=f32)
    l = q.new_zeros((bh, lq), dtype=f32)
    acc = q.new_zeros((bh, lq, d), dtype=f32)
    for k0 in range(0, lk, block_k):
        kc = k[:, k0:k0 + block_k].to(f32)
        vc = v[:, k0:k0 + block_k].to(f32)
        s = torch.einsum("bqd,bkd->bqk", qf, kc)
        if causal:
            cols = k0 + torch.arange(kc.shape[1], device=q.device)[None, None, :]
            s = torch.where(rows >= cols, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p, vc)
        m = m_cur
    norm = torch.where(l > 0, 1.0 / torch.where(l > 0, l, 1.0), 0.0)
    return (acc * norm[..., None]).to(q.dtype)
