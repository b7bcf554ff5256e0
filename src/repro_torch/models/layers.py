"""Shared neural building blocks: `nn.Module` parameter holders plus plain
functions.  Ports `repro/models/layers.py`.

Conventions kept from the reference, so that weights carry across
(`convert.params_from_jax`) and results compare like for like:

  * a linear weight is ``w [d_in, d_out]`` and the layer computes
    ``x @ w`` in the compute dtype (the reference stores f32 and casts at
    use; the port may store the compute dtype, the same rounding);
  * norm gains are f32 and the norms compute in f32;
  * attention works in folded ``[B*H, L, D]`` space and its decode cache is
    ``[B, S, Hkv, D]``.

``RuntimeFlags.use_kernels`` takes the place of the reference's
``use_pallas``/``interpret`` pair: True runs the hand-written kernels
(their plain twins for CPU tensors).  The reference's mesh arguments and
``shard()`` drop out: a model runs on one device.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.kernels.flash_attention.ops import (
    constrain_folded,
    gqa_attention_folded,
)

__all__ = [
    "RuntimeFlags",
    "rms_norm",
    "gain",
    "Linear",
    "linear",
    "Embedding",
    "rope",
    "rope_folded",
    "Attention",
    "attention",
    "attention_decode",
    "MLP",
    "mlp",
]


@dataclasses.dataclass(frozen=True)
class RuntimeFlags:
    """Execution-path switches threaded through every model."""

    use_kernels: bool = False     # hand-written Hopper kernels
    # kv block of the plain blocked-attention path (long keys); the
    # attention kernel chooses its own tiles
    attn_block_k: int = 4096


def _normal(gen, shape, scale, device, dtype):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


# ---------------------------------------------------------------- norms
def rms_norm(x, gamma, eps: float = 1e-5):
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * gamma.float()).to(x.dtype)


# ---------------------------------------------------------------- linear
class Linear(nn.Module):
    """``w [d_in, d_out]``, drawn N(0, 1) * ``scale`` (default d_in^-0.5)."""

    def __init__(self, d_in: int, d_out: int, *, gen=None, scale=None,
                 device=None, dtype=torch.float32):
        super().__init__()
        scale = scale if scale is not None else d_in ** -0.5
        self.w = nn.Parameter(_normal(gen, (d_in, d_out), scale, device, dtype),
                              requires_grad=False)


def linear(p: Linear, x):
    return x @ p.w.to(x.dtype)


class Embedding(nn.Module):
    """``emb [vocab, d]``, drawn N(0, 1) * 0.02."""

    def __init__(self, vocab: int, d: int, *, gen=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.emb = nn.Parameter(_normal(gen, (vocab, d), 0.02, device, dtype),
                                requires_grad=False)


def gain(d: int, device, value: float = 1.0):
    """An f32 vector parameter filled with ``value`` (norm gains, biases)."""
    return nn.Parameter(torch.full((d,), value, device=device), requires_grad=False)


# ---------------------------------------------------------------- rope
def _rope_angles(positions, half: int, theta: float):
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    return positions[..., None].float() * freqs


def rope(x, positions, theta: float):
    """Rotary embedding. x: ``[B, L, H, D]``; positions: ``[B, L]``."""
    half = x.shape[-1] // 2
    ang = _rope_angles(positions, half, theta)            # [B, L, half]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_folded(x, positions, theta: float):
    """Rotary embedding on folded ``[B*H, L, D]``; positions ``[B*H, L]``."""
    half = x.shape[-1] // 2
    ang = _rope_angles(positions, half, theta)            # [Z, L, half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention
class Attention(nn.Module):
    """``wq, wk, wv, wo``; scales as the reference's ``init_attention``."""

    def __init__(self, cfg, *, gen=None, device=None, dtype=torch.float32):
        super().__init__()
        d, hd, hq, hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.wq = Linear(d, hq * hd, **kw)
        self.wk = Linear(d, hkv * hd, **kw)
        self.wv = Linear(d, hkv * hd, **kw)
        self.wo = Linear(hq * hd, d, scale=(hq * hd) ** -0.5, **kw)


def attention(p: Attention, x, cfg, flags: RuntimeFlags, positions=None,
              kv_x=None, causal: bool = True, use_rope: bool = True):
    """Full-sequence attention (prefill): self-attention over ``x``, or
    cross-attention to ``kv_x`` (an encoder's or the vision frontend's
    output, never causal and never roped).

    x: ``[B, L, d]``; kv_x: ``[B, Lk, d]`` or None.  Returns ``(out [B, L,
    d], {"k", "v": [B, Lk, Hkv, D]})``, the (roped) keys and values for
    the decode cache.
    """
    b, l, _ = x.shape
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    src = x if kv_x is None else kv_x
    lk = src.shape[1]
    fold = lambda t, h, n: t.reshape(b, n, h, hd).transpose(1, 2).reshape(b * h, n, hd)
    qf = constrain_folded(fold(linear(p.wq, x), hq, l), b * hq)
    kf = constrain_folded(fold(linear(p.wk, src), hkv, lk), b * hkv)
    vf = constrain_folded(fold(linear(p.wv, src), hkv, lk), b * hkv)
    if use_rope and kv_x is None:
        if positions is None:
            positions = torch.arange(l, device=x.device)[None, :].expand(b, l)
        posf = lambda h: positions[:, None, :].expand(b, h, l).reshape(b * h, l)
        qf = rope_folded(qf, posf(hq), cfg.rope_theta)
        kf = rope_folded(kf, posf(hkv), cfg.rope_theta)
    of = gqa_attention_folded(qf, kf, vf, batch=b, causal=causal and kv_x is None,
                              use_kernels=flags.use_kernels,
                              block_k=flags.attn_block_k)
    o3 = of.reshape(b, hq, l, hd).transpose(1, 2).reshape(b, l, hq * hd)
    out = linear(p.wo, o3)
    k4 = kf.reshape(b, hkv, lk, hd).transpose(1, 2)
    v4 = vf.reshape(b, hkv, lk, hd).transpose(1, 2)
    return out, {"k": k4, "v": v4}


def attention_decode(p: Attention, x, cache_k, cache_v, pos: int, cfg,
                     update_cache: bool = True):
    """One-token decode against a pre-allocated KV cache.

    x: ``[B, 1, d]``; cache_k, cache_v: ``[B, S, Hkv, D]``.  With
    ``update_cache`` the token's roped key and value are written in place
    at ``pos`` (the reference returns a new cache; writing in place saves a
    copy of the cache per step) and q is roped at ``pos``; without it
    (cross-attention to a fixed cache) nothing is written and q is not
    roped, as in the reference.  Keys past ``pos`` are masked.  Returns
    ``out [B, 1, d]``.
    """
    b = x.shape[0]
    hd = cfg.hd
    q = linear(p.wq, x).reshape(b, 1, cfg.n_heads, hd)
    if update_cache:
        k_new = linear(p.wk, x).reshape(b, 1, cfg.n_kv_heads, hd)
        v_new = linear(p.wv, x).reshape(b, 1, cfg.n_kv_heads, hd)
        positions = torch.full((b, 1), pos, device=x.device)
        cache_k[:, pos:pos + 1] = rope(k_new, positions, cfg.rope_theta)
        cache_v[:, pos:pos + 1] = v_new
        q = rope(q, positions, cfg.rope_theta)
    group = cfg.n_heads // cfg.n_kv_heads
    kq = cache_k.repeat_interleave(group, dim=2) if group > 1 else cache_k
    vq = cache_v.repeat_interleave(group, dim=2) if group > 1 else cache_v
    f32 = torch.float32
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f32) * hd ** -0.5, kq.to(f32))
    valid = torch.arange(cache_k.shape[1], device=x.device) <= pos
    logits = torch.where(valid, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, vq.to(f32)).to(x.dtype)
    return linear(p.wo, o.reshape(b, 1, cfg.n_heads * hd))


# ---------------------------------------------------------------- mlp
class MLP(nn.Module):
    """``w1, w2`` (gelu) or ``w1, w3, w2`` (swiglu), as ``init_mlp``."""

    def __init__(self, cfg, *, gen=None, device=None, dtype=torch.float32):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        kw = dict(gen=gen, device=device, dtype=dtype)
        self.w1 = Linear(d, ff, **kw)
        if cfg.mlp == "swiglu":
            self.w3 = Linear(d, ff, **kw)
        self.w2 = Linear(ff, d, scale=ff ** -0.5, **kw)


def mlp(p: MLP, x, kind: str):
    if kind == "swiglu":
        h = torch.nn.functional.silu(linear(p.w1, x)) * linear(p.w3, x)
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = torch.nn.functional.gelu(linear(p.w1, x), approximate="tanh")
    return linear(p.w2, h)
