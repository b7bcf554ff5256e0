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
(their plain twins for CPU tensors).

On a device mesh (``RuntimeFlags.mesh``, a `DeviceMesh`) parameters and
activations are DTensors (`distributed.sharding.distribute_params`), and
`shard` places an activation where the reference places its sharding
constraints.  Tensors a function makes itself (positions, masks, the rope
angles) are the same on every rank and join as replicated DTensors
(`like`).  Without a mesh everything is a plain tensor and `shard` does
nothing.

Parameters are built with ``requires_grad=False``: serving needs no
gradient, and the functions here then return plain tensors outside
``no_grad``.  Training switches them on (``model.requires_grad_(True)``,
`launch.steps.make_train_step`); the functions are autograd-safe (no
in-place write into a tensor that autograd saved).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.distributed.sharding import (
    dp_size,
    fold_heads,
    heads_split,
    like,
    model_size,
    partial_on,
    place,
    placements,
    reduce_grad,
    spec_fits,
    split_heads,
    unfold_heads,
    unshard,
)
from repro_torch.kernels.flash_attention.ops import constrain_folded, gqa_attention_folded

__all__ = [
    "RuntimeFlags",
    "shard",
    "pad_local",
    "rms_norm",
    "layer_norm",
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
    # activation checkpointing in training: each layer (vlm, hybrid: each
    # group) recomputes its forward in the backward pass, as the
    # reference's jax.checkpoint does; inference (no_grad) ignores it
    remat: bool = True
    # kv block of the plain blocked-attention path (long keys); the
    # attention kernel chooses its own tiles
    attn_block_k: int = 4096
    # distribution: set by the launchers.  Blocks place explicit
    # placements where the reference places sharding constraints.
    mesh: object = None           # torch DeviceMesh | None
    dp: tuple = ("data",)         # data-parallel axis names ('pod', 'data')


def shard(x, flags: RuntimeFlags, *spec):
    """Redistribute the DTensor ``x`` to ``spec`` when a mesh is configured;
    no-op otherwise.  ``spec`` entries: "dp" expands to ``flags.dp``; None
    and "model" pass through.  A split that does not divide its dim is
    dropped (that dim replicated): GSPMD pads such a dim, and DTensor views
    need even shards."""
    if flags is None or flags.mesh is None:
        return x
    expanded = tuple(flags.dp if s == "dp" else s for s in spec)
    expanded = tuple(e if spec_fits(flags.mesh, (n,), (e,)) else None
                     for n, e in zip(x.shape, expanded))
    return x.redistribute(flags.mesh, placements(flags.mesh, expanded))


def pad_local(x, pad):
    """``F.pad(x, pad)`` (zeros); a DTensor is padded shard by shard, the
    padded dims first made whole on every rank."""
    if not isinstance(x, DTensor):
        return torch.nn.functional.pad(x, pad)
    from torch.distributed.tensor.experimental import local_map

    x = unshard(x, *(x.ndim - 1 - i for i in range(len(pad) // 2) if pad[2 * i: 2 * i + 2]
                     != (0, 0)))
    plc = list(x.placements)
    return local_map(lambda t: torch.nn.functional.pad(t, pad), out_placements=plc,
                     in_placements=(plc,), device_mesh=x.device_mesh)(x)


def _normal(gen, shape, scale, device, dtype):
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


# ---------------------------------------------------------------- norms
def rms_norm(x, gamma, eps: float = 1e-5):
    xf = x.float()
    xf = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * gamma.float()).to(x.dtype)


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).pow(2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma + beta).to(x.dtype)


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
    cos = like(x, torch.cos(ang)[:, :, None, :])
    sin = like(x, torch.sin(ang)[:, :, None, :])
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope_folded(x, positions, theta: float):
    """Rotary embedding on folded ``[B*H, L, D]``; positions ``[B*H, L]``."""
    half = x.shape[-1] // 2
    ang = _rope_angles(positions, half, theta)            # [Z, L, half]
    cos, sin = like(x, torch.cos(ang)), like(x, torch.sin(ang))
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

    On a mesh whose "model" axis divides the query heads, each rank folds,
    ropes and attends its own heads (`_attention_local_heads`); otherwise
    the folded tensors are placed by the reference's fold priorities
    (`constrain_folded`), the heads made whole to fold them.
    """
    b, l, _ = x.shape
    hd, hq, hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    # the input gradients of the column-parallel wq, wk, wv are summed over
    # "model" once (for self-attention x is src: one hook)
    x = reduce_grad(x)
    src = x if kv_x is None else reduce_grad(kv_x)
    lk = src.shape[1]
    q3, k3, v3 = linear(p.wq, x), linear(p.wk, src), linear(p.wv, src)
    roped = use_rope and kv_x is None
    causal = causal and kv_x is None
    if flags.mesh is not None and heads_split(flags.mesh, hq):
        o3, k4, v4 = _attention_local_heads(q3, k3, v3, positions, cfg, flags, causal,
                                            roped)
    elif flags.mesh is None:
        o3, k4, v4 = _attend_heads(q3, k3, v3, positions, cfg, flags, causal, roped)
    else:
        qf = constrain_folded(fold_heads(q3, hq), flags, b * hq)
        kf = constrain_folded(fold_heads(k3, hkv), flags, b * hkv, is_kv=True)
        vf = constrain_folded(fold_heads(v3, hkv), flags, b * hkv, is_kv=True)
        if roped:
            qf, kf = _rope_rows(qf, kf, positions, b, l, cfg)
        of = gqa_attention_folded(qf, kf, vf, batch=b, causal=causal,
                                  use_kernels=flags.use_kernels,
                                  block_k=flags.attn_block_k, flags=flags)
        o3 = unfold_heads(constrain_folded(of, flags, b * hq), flags, b).reshape(
            b, l, hq * hd)
        k4, v4 = unfold_heads(kf, flags, b), unfold_heads(vf, flags, b)
    o3 = shard(o3, flags, "dp", None, "model")
    out = shard(linear(p.wo, o3), flags, "dp", None, None)
    return out, {"k": k4, "v": v4}


def _rope_rows(qf, kf, positions, b: int, l: int, cfg):
    """Rotary embedding of folded (b-major) queries and keys."""
    hq, hkv = qf.shape[0] // b, kf.shape[0] // b
    if positions is None:
        positions = torch.arange(l, device=qf.device)[None, :].expand(b, l)
    posf = lambda h: positions[:, None, :].expand(b, h, l).reshape(b * h, l)
    return (rope_folded(qf, posf(hq), cfg.rope_theta),
            rope_folded(kf, posf(hkv), cfg.rope_theta))


def _attend_heads(q3, k3, v3, positions, cfg, flags, causal: bool, roped: bool,
                  q_head0: int = 0):
    """Attention of plain tensors: q3 ``[b, l, hq * D]`` (the query heads
    ``[q_head0, q_head0 + hq)``), k3, v3 ``[b, lk, hkv * D]``: fold, rope,
    attend (the kernel with ``flags.use_kernels``), unfold.  Returns ``(o3
    [b, l, hq * D], k4, v4 [b, lk, hkv, D])``.  Where the query heads are a
    part of all heads (a rank's share), k3 and v3 hold every kv head and
    each query head reads its own (``cfg``'s grouping)."""
    b, l, _ = q3.shape
    hd = cfg.hd
    hq, hkv = q3.shape[-1] // hd, k3.shape[-1] // hd
    qf, kf, vf = fold_heads(q3, hq), fold_heads(k3, hkv), fold_heads(v3, hkv)
    if roped:
        qf, kf = _rope_rows(qf, kf, positions, b, l, cfg)
    k4, v4 = (t.reshape(b, hkv, -1, hd).transpose(1, 2) for t in (kf, vf))
    if hq * cfg.n_kv_heads != hkv * cfg.n_heads:
        # the kv head of each of this rank's query heads, one row each
        g = cfg.n_heads // cfg.n_kv_heads
        idx = torch.div(torch.arange(q_head0, q_head0 + hq, device=kf.device), g,
                        rounding_mode="floor")
        kf, vf = (t.reshape(b, hkv, -1, hd)[:, idx].reshape(b * hq, -1, hd)
                  for t in (kf, vf))
    of = gqa_attention_folded(qf, kf, vf, batch=b, causal=causal,
                              use_kernels=flags.use_kernels, block_k=flags.attn_block_k)
    return of.reshape(b, hq, l, hd).transpose(1, 2).reshape(b, l, hq * hd), k4, v4


def _attention_local_heads(q3, k3, v3, positions, cfg, flags, causal: bool,
                           roped: bool):
    """`_attend_heads` on each rank's own query heads (`local_map`): the
    batch split over dp (when it divides), the heads over "model", folded
    rank by rank, so no view merges a split dim and nothing is gathered.
    Kv heads that "model" does not divide (granite-8b: 8 kv heads, 16
    ranks, each rank's wk columns half a head) are gathered over "model"
    for every rank, which takes those its query heads read; their gradient,
    each rank's share, is reduce-scattered back."""
    from torch.distributed.tensor.experimental import local_map

    mesh = flags.mesh
    b = q3.shape[0]
    bspec = tuple(flags.dp) if b % dp_size(mesh) == 0 else None
    kv_split = heads_split(mesh, cfg.n_kv_heads)
    q_plc = placements(mesh, (bspec, None, "model"))
    kv_plc = q_plc if kv_split else placements(mesh, (bspec, None, None))
    kv4_plc = placements(mesh, (bspec, None, "model" if kv_split else None, None))
    hq_local = cfg.n_heads // model_size(mesh)
    pos_plc = placements(mesh, (bspec, None))
    if positions is not None:
        positions = place(positions, mesh, pos_plc)

    def body(q, k, v, pos):
        head0 = 0 if kv_split else mesh.get_local_rank("model") * hq_local
        return _attend_heads(q, k, v, pos, cfg, flags, causal, roped, head0)

    kv_grad = kv_plc if kv_split else partial_on(kv_plc, mesh, ("model",))
    return local_map(
        body, out_placements=(q_plc, kv4_plc, kv4_plc),
        in_placements=(q_plc, kv_plc, kv_plc, None if positions is None else pos_plc),
        in_grad_placements=(q_plc, kv_grad, kv_grad,
                            None if positions is None else pos_plc),
        device_mesh=mesh, redistribute_inputs=True)(q3, k3, v3, positions)


def attention_decode(p: Attention, x, cache_k, cache_v, pos: int, cfg,
                     update_cache: bool = True):
    """One-token decode against a pre-allocated KV cache.

    x: ``[B, 1, d]``; cache_k, cache_v: ``[B, S, Hkv, D]``.  With
    ``update_cache`` the token's roped key and value are written in place
    at ``pos`` (the reference returns a new cache; writing in place saves a
    copy of the cache per step) and q is roped at ``pos``; without it
    (cross-attention to a fixed cache) nothing is written and q is not
    roped, as in the reference.  Keys past ``pos`` are masked.  Returns
    ``out [B, 1, d]``.  A DTensor cache may split its sequence over ranks
    (`sharding.cache_placements`); the rank that holds ``pos`` writes it.
    """
    b = x.shape[0]
    hd = cfg.hd
    # the query heads whole on every rank: the products below merge them
    # into the batch dim
    q = split_heads(linear(p.wq, x), cfg.n_heads, whole=True)
    if update_cache:
        k_new = split_heads(linear(p.wk, x), cfg.n_kv_heads)
        v_new = split_heads(linear(p.wv, x), cfg.n_kv_heads)
        positions = torch.full((b, 1), pos, device=x.device)
        _write_pos(cache_k, pos, rope(k_new, positions, cfg.rope_theta))
        _write_pos(cache_v, pos, v_new)
        q = rope(q, positions, cfg.rope_theta)
    group = cfg.n_heads // cfg.n_kv_heads
    s_len, hkv = cache_k.shape[1], cfg.n_kv_heads
    # each kv head repeated for its query heads (repeat_interleave on dim 2)
    rep = lambda t: t[:, :, :, None].expand(b, s_len, hkv, group, hd).reshape(
        b, s_len, hkv * group, hd)
    kq, vq = (rep(cache_k), rep(cache_v)) if group > 1 else (cache_k, cache_v)
    f32 = torch.float32
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f32) * hd ** -0.5, kq.to(f32))
    valid = like(logits, torch.arange(s_len, device=x.device) <= pos)
    logits = torch.where(valid, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", w, vq.to(f32)).to(x.dtype)
    return linear(p.wo, o.reshape(b, 1, cfg.n_heads * hd))


def _write_pos(cache, pos: int, value):
    """``cache[:, pos] = value[:, 0]`` in place.  A DTensor cache writes into
    this rank's shard when it holds ``pos`` (the sequence may be split)."""
    if not isinstance(cache, DTensor):
        cache[:, pos:pos + 1] = value
        return
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = cache.device_mesh
    plc = tuple(Replicate() if p.is_shard(1) else p for p in cache.placements)
    val = value.redistribute(mesh, plc).to_local()
    shape, offset = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                          cache.placements)
    row = pos - offset[1]
    if 0 <= row < shape[1]:
        cache.to_local()[:, row:row + 1] = val


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


def mlp(p: MLP, x, kind: str, flags: RuntimeFlags | None = None):
    x = reduce_grad(x)     # the input gradient of the column-parallel w1 (w3)
    if kind == "swiglu":
        h = torch.nn.functional.silu(linear(p.w1, x)) * linear(p.w3, x)
    else:
        # jax.nn.gelu's default is the tanh approximation
        h = torch.nn.functional.gelu(linear(p.w1, x), approximate="tanh")
    h = shard(h, flags, "dp", None, "model")
    return shard(linear(p.w2, h), flags, "dp", None, None)
