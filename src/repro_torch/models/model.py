"""Model assembly: init / prefill / decode_step / init_cache.

Ports the ``hybrid`` family of `repro/models/model.py` (Zamba2): groups of
``hybrid_attn_every`` Mamba2 layers, each group followed by ONE shared
transformer block (attention + MLP, the same weights at every
application).  Names and the cache layout are the reference's, with its
``lax.scan`` stacking made explicit:

  * parameters: ``emb.emb``, ``ln_f``, ``lm_head.w``,
    ``groups[g].mamba[i].{ln, mamba.*}`` (the reference stacks these as
    ``[groups, per_group, ...]``) and ``shared.{ln1, attn, ln2, mlp}``;
  * cache: ``{"pos": int, "state": (conv [G, P, B, K-1, C],
    ssm [G, P, B, nh, ds, hd] f32), "kv": {"k", "v": [G, B, S, Hkv, D]}}``.

`decode_step` updates the cache tensors in place (the reference returns a
new cache) and returns the cache.  The other families raise
`NotImplementedError` until their slice (ROADMAP Queue 1).  Training
(``train_forward``) comes with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels.common import resolve_device

from . import mamba2 as m2
from .layers import (
    MLP,
    Attention,
    Embedding,
    Linear,
    RuntimeFlags,
    attention,
    attention_decode,
    gain,
    linear,
    mlp,
    rms_norm,
)

__all__ = ["HybridLM", "init_params", "prefill", "decode_step", "init_cache",
           "RuntimeFlags"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _require_hybrid(cfg) -> None:
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: the port "
            f"runs the 'hybrid' family (ROADMAP Queue 1, item 4)")


def _groups(cfg) -> tuple[int, int]:
    return cfg.n_layers // cfg.hybrid_attn_every, cfg.hybrid_attn_every


class DenseLayer(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.ln1 = gain(cfg.d_model, kw.get("device"))
        self.attn = Attention(cfg, **kw)
        self.ln2 = gain(cfg.d_model, kw.get("device"))
        self.mlp = MLP(cfg, **kw)


class MambaLayer(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.ln = gain(cfg.d_model, kw.get("device"))
        self.mamba = m2.Mamba2Block(cfg, **kw)


class HybridGroup(nn.Module):
    def __init__(self, cfg, per: int, **kw):
        super().__init__()
        self.mamba = nn.ModuleList(MambaLayer(cfg, **kw) for _ in range(per))


class HybridLM(nn.Module):
    """The hybrid model's parameters, drawn at the reference's scales.

    Weights that the reference casts to the compute dtype at use (linear
    ``w``, ``conv_w``, the embedding) are stored in it; gains and the SSM's
    ``a_log``, ``dt_bias``, ``d_skip`` stay f32.
    """

    def __init__(self, cfg, *, gen=None, device=None):
        super().__init__()
        _require_hybrid(cfg)
        kw = dict(gen=gen, device=device, dtype=compute_dtype(cfg))
        ng, per = _groups(cfg)
        self.emb = Embedding(cfg.vocab, cfg.d_model, **kw)
        self.ln_f = gain(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab, scale=0.02, **kw)
        self.groups = nn.ModuleList(HybridGroup(cfg, per, **kw) for _ in range(ng))
        self.shared = DenseLayer(cfg, **kw)   # ONE shared block


def init_params(gen: torch.Generator, cfg, *, device=None) -> HybridLM:
    """Random parameters drawn from ``gen``, a generator on ``device``
    (None: the CUDA device)."""
    return HybridLM(cfg, gen=gen, device=resolve_device(device))


# =====================================================================
# forward blocks
# =====================================================================
def _dense_block(lp: DenseLayer, x, cfg, flags):
    h, kv = attention(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg, flags)
    x = x + h
    x = x + mlp(lp.mlp, rms_norm(x, lp.ln2, cfg.norm_eps), cfg.mlp)
    return x, kv


def _embed(model: HybridLM, tokens, cfg):
    return model.emb.emb[tokens].to(compute_dtype(cfg))


def _unembed(model: HybridLM, x, cfg):
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ model.emb.emb.T.to(x.dtype)
    else:
        logits = linear(model.lm_head, x)
    return logits.float()


# =====================================================================
# public entry points
# =====================================================================
@torch.no_grad()
def prefill(model: HybridLM, tokens, cfg, flags: RuntimeFlags,
            pad_to: int | None = None):
    """Full-sequence forward collecting decode state.

    tokens: ``[B, S]`` int.  Returns ``(logits [B, 1, vocab] f32 of the
    last position, cache)``; the KV cache is padded to ``pad_to`` so that
    decode can append.
    """
    seq = tokens.shape[1]
    x = _embed(model, tokens, cfg)
    conv, ssm, ks, vs = [], [], [], []
    for grp in model.groups:
        for lp in grp.mamba:
            h, (cst, sst) = m2.mamba2_block(
                lp.mamba, rms_norm(x, lp.ln, cfg.norm_eps), cfg, flags)
            x = x + h
            conv.append(cst)
            ssm.append(sst)
        x, kv = _dense_block(model.shared, x, cfg, flags)
        ks.append(kv["k"])
        vs.append(kv["v"])
    logits = _unembed(model, x[:, -1:], cfg)

    ng, per = _groups(cfg)
    stack = lambda a: torch.stack(a).reshape(ng, per, *a[0].shape)

    def pad_kv(parts):
        kv = torch.stack(parts)                   # [G, B, S, Hkv, D]
        if pad_to is None or pad_to == seq:
            return kv
        out = kv.new_zeros((kv.shape[0], kv.shape[1], pad_to, *kv.shape[3:]))
        out[:, :, :seq] = kv
        return out

    cache = {"state": (stack(conv), stack(ssm)),
             "kv": {"k": pad_kv(ks), "v": pad_kv(vs)},
             "pos": seq}
    return logits, cache


def init_cache(cfg, batch: int, max_seq: int, dtype=None, device=None):
    """Empty decode cache (decode from scratch)."""
    _require_hybrid(cfg)
    dt = dtype or compute_dtype(cfg)
    ng, per = _groups(cfg)
    cst, sst = m2.init_mamba2_state(cfg, batch, dt, device)
    kv = lambda: torch.zeros((ng, batch, max_seq, cfg.n_kv_heads, cfg.hd),
                             dtype=dt, device=device)
    return {"pos": 0,
            "state": (cst.expand(ng, per, *cst.shape).clone(),
                      sst.expand(ng, per, *sst.shape).clone()),
            "kv": {"k": kv(), "v": kv()}}


@torch.no_grad()
def decode_step(model: HybridLM, token, cache, cfg, flags: RuntimeFlags):
    """One-token decode. token: ``[B, 1]`` int.

    Returns ``(logits [B, 1, vocab] f32, cache)``; the cache's tensors are
    updated in place and ``cache["pos"]`` advances by one.
    """
    pos = cache["pos"]
    conv, ssm = cache["state"]
    x = _embed(model, token, cfg)
    shared = model.shared
    for g, grp in enumerate(model.groups):
        for i, lp in enumerate(grp.mamba):
            h, (c1, s1) = m2.mamba2_decode(
                lp.mamba, rms_norm(x, lp.ln, cfg.norm_eps), cfg, flags,
                conv[g, i], ssm[g, i])
            conv[g, i] = c1
            ssm[g, i] = s1
            x = x + h
        x = x + attention_decode(
            shared.attn, rms_norm(x, shared.ln1, cfg.norm_eps),
            cache["kv"]["k"][g], cache["kv"]["v"][g], pos, cfg)
        x = x + mlp(shared.mlp, rms_norm(x, shared.ln2, cfg.norm_eps), cfg.mlp)
    cache["pos"] = pos + 1
    return _unembed(model, x, cfg), cache
