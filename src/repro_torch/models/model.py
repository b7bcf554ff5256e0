"""Model assembly: init / train_forward / prefill / decode_step / init_cache
per family.

Ports `repro/models/model.py`.  Families: ``dense``, ``moe``, ``vlm`` and
``encdec`` (the transformer machinery) and ``ssm`` (RWKV6) and ``hybrid``
(Zamba2) on the medium-granularity chunked scan.  Each family is one
`nn.Module` holding the reference's parameter names, with its
``lax.scan`` stacking made explicit (a layer index in the name):

  * every family: ``emb.emb``, ``ln_f``, ``lm_head.w`` (unless tied);
  * dense, moe, ssm: ``layers[i]`` (``{ln1, attn, ln2, mlp}``; moe has
    ``moe`` in place of ``mlp`` and Arctic's ``dense_mlp`` beside it; ssm
    ``{ln1, time, ln2, chan}``);
  * vlm: ``groups[g].self[i]`` (dense layers), ``groups[g].cross`` (a
    dense layer whose attention reads the vision embedding), ``vis_proj``;
  * encdec: ``enc_layers[i]``, ``enc_ln_f``, and decoder ``layers[i]``
    with ``ln_x`` and ``cross`` (attention to the encoder output);
  * hybrid: ``groups[g].mamba[i].{ln, mamba}`` and ONE ``shared`` block.

The decode cache keeps the reference's leaves, stacked the same way:
``kv`` ``[L, B, S, Hkv, D]`` (vlm ``[G, P, ...]``, hybrid ``[G, ...]``),
vlm ``cross_kv`` ``[G, B, vision_tokens, Hkv, D]`` and ``_vis_embed``,
encdec ``_enc_out``, ssm ``state`` ``(time shift, wkv, channel shift)``,
hybrid ``state`` ``(conv, ssm)``; ``pos`` is an int.  `decode_step`
updates the cache tensors in place (the reference returns a new cache)
and returns the cache.

Modality frontends are the reference's stubs: ``vlm`` takes precomputed
patch embeddings (``extra["vision"] [B, vision_tokens, vision_dim]``),
``encdec`` precomputed frame embeddings (``extra["frames"] [B,
enc_frames, d_model]``).

`train_forward` is the reference's loss (mean next-token NLL plus 0.01 of
the moe load-balancing loss, the mean over layers) under autograd, on the
plain paths as the reference trains (``use_pallas=False``): no kernel has
a backward pass in either package.  With ``flags.remat`` each layer (vlm
and hybrid: each group) runs under `torch.utils.checkpoint`, where the
reference wraps it in ``jax.checkpoint``.  Training keeps float32 master
weights, as the reference stores every parameter in f32 and casts it at
use: `init_params(..., param_dtype=torch.float32)`.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import batch_placements, like, place, unshard
from repro_torch.kernels.common import resolve_device

from . import mamba2 as m2
from . import rwkv6 as rw
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
    pad_local,
    rms_norm,
    shard,
)
from .moe import MoE, moe_ffn

__all__ = ["LM", "DenseLM", "MoELM", "SSMLM", "EncDecLM", "VLMLM", "HybridLM",
           "MODELS", "init_params", "train_forward", "prefill", "decode_step",
           "init_cache", "RuntimeFlags"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _vlm_groups(cfg) -> tuple[int, int]:
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def _hybrid_groups(cfg) -> tuple[int, int]:
    return cfg.n_layers // cfg.hybrid_attn_every, cfg.hybrid_attn_every


# =====================================================================
# parameters
# =====================================================================
class DenseLayer(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.ln1 = gain(cfg.d_model, kw.get("device"))
        self.attn = Attention(cfg, **kw)
        self.ln2 = gain(cfg.d_model, kw.get("device"))
        self.mlp = MLP(cfg, **kw)


class MoELayer(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.ln1 = gain(cfg.d_model, kw.get("device"))
        self.attn = Attention(cfg, **kw)
        self.ln2 = gain(cfg.d_model, kw.get("device"))
        self.moe = MoE(cfg, **kw)
        if cfg.moe_dense_residual:
            self.dense_mlp = MLP(cfg, **kw)


class DecoderLayer(DenseLayer):
    """An encdec decoder layer: a dense layer with cross-attention."""

    def __init__(self, cfg, **kw):
        super().__init__(cfg, **kw)
        self.ln_x = gain(cfg.d_model, kw.get("device"))
        self.cross = Attention(cfg, **kw)


class RWKVLayer(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.ln1 = gain(cfg.d_model, kw.get("device"))
        self.time = rw.RWKVTimeMix(cfg, **kw)
        self.ln2 = gain(cfg.d_model, kw.get("device"))
        self.chan = rw.RWKVChannelMix(cfg, **kw)


class MambaLayer(nn.Module):
    def __init__(self, cfg, **kw):
        super().__init__()
        self.ln = gain(cfg.d_model, kw.get("device"))
        self.mamba = m2.Mamba2Block(cfg, **kw)


class VLMGroup(nn.Module):
    def __init__(self, cfg, per: int, **kw):
        super().__init__()
        self.add_module("self", nn.ModuleList(DenseLayer(cfg, **kw) for _ in range(per)))
        self.cross = DenseLayer(cfg, **kw)


class HybridGroup(nn.Module):
    def __init__(self, cfg, per: int, **kw):
        super().__init__()
        self.mamba = nn.ModuleList(MambaLayer(cfg, **kw) for _ in range(per))


class LM(nn.Module):
    """What every family holds: the embedding, the final norm and the head.

    Weights that the reference casts to the compute dtype at use (linear
    ``w``, expert weights, ``conv_w``, the embedding) are stored in
    ``param_dtype``, by default the compute dtype; gains, mixes, biases and
    the SSMs' decay parameters stay f32.  Both draw the same values from
    ``gen``.
    """

    family = ""

    def __init__(self, cfg, *, gen=None, device=None, param_dtype=None):
        super().__init__()
        if cfg.family != self.family:
            raise ValueError(f"{type(self).__name__} holds the {self.family!r} "
                             f"family, {cfg.name} is {cfg.family!r}")
        kw = dict(gen=gen, device=device, dtype=param_dtype or compute_dtype(cfg))
        self.emb = Embedding(cfg.vocab, cfg.d_model, **kw)
        self.ln_f = gain(cfg.d_model, device)
        if not cfg.tie_embeddings:
            self.lm_head = Linear(cfg.d_model, cfg.vocab, scale=0.02, **kw)
        self.build(cfg, kw)

    def build(self, cfg, kw) -> None:
        raise NotImplementedError


class DenseLM(LM):
    family = "dense"

    def build(self, cfg, kw):
        self.layers = nn.ModuleList(DenseLayer(cfg, **kw) for _ in range(cfg.n_layers))


class MoELM(LM):
    family = "moe"

    def build(self, cfg, kw):
        self.layers = nn.ModuleList(MoELayer(cfg, **kw) for _ in range(cfg.n_layers))


class SSMLM(LM):
    family = "ssm"

    def build(self, cfg, kw):
        self.layers = nn.ModuleList(RWKVLayer(cfg, **kw) for _ in range(cfg.n_layers))


class EncDecLM(LM):
    family = "encdec"

    def build(self, cfg, kw):
        self.enc_layers = nn.ModuleList(DenseLayer(cfg, **kw)
                                        for _ in range(cfg.enc_layers))
        self.enc_ln_f = gain(cfg.d_model, kw["device"])
        self.layers = nn.ModuleList(DecoderLayer(cfg, **kw) for _ in range(cfg.n_layers))


class VLMLM(LM):
    family = "vlm"

    def build(self, cfg, kw):
        ng, per = _vlm_groups(cfg)
        self.groups = nn.ModuleList(VLMGroup(cfg, per, **kw) for _ in range(ng))
        self.vis_proj = Linear(cfg.vision_dim, cfg.d_model, **kw)


class HybridLM(LM):
    family = "hybrid"

    def build(self, cfg, kw):
        ng, per = _hybrid_groups(cfg)
        self.groups = nn.ModuleList(HybridGroup(cfg, per, **kw) for _ in range(ng))
        self.shared = DenseLayer(cfg, **kw)   # ONE shared block


MODELS = {cls.family: cls for cls in (DenseLM, MoELM, SSMLM, EncDecLM, VLMLM, HybridLM)}


def init_params(gen: torch.Generator, cfg, *, device=None, param_dtype=None) -> LM:
    """Random parameters of ``cfg``'s family drawn from ``gen``, a
    generator on ``device`` (None: the CUDA device); weights in
    ``param_dtype`` (None: the compute dtype; training passes f32)."""
    return MODELS[cfg.family](cfg, gen=gen, device=resolve_device(device),
                              param_dtype=param_dtype)


# =====================================================================
# forward blocks
# =====================================================================
def _dense_block(lp: DenseLayer, x, cfg, flags, kv_x=None, causal=True,
                 use_rope=True):
    h, kv = attention(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg, flags,
                      kv_x=kv_x, causal=causal, use_rope=use_rope)
    x = x + h
    x = x + mlp(lp.mlp, rms_norm(x, lp.ln2, cfg.norm_eps), cfg.mlp, flags)
    return x, kv


def _moe_block(lp: MoELayer, x, cfg, flags):
    h, kv = attention(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg, flags)
    x, aux = _moe_ffn(lp, x + h, cfg, flags)
    return x, kv, aux


def _moe_ffn(lp: MoELayer, x, cfg, flags, dropless=False):
    """The MoE half of a moe layer (plus Arctic's parallel dense FFN)."""
    z = rms_norm(x, lp.ln2, cfg.norm_eps)
    mo, aux = moe_ffn(lp.moe, z, cfg, flags, dropless=dropless)
    if cfg.moe_dense_residual:
        mo = mo + mlp(lp.dense_mlp, z, cfg.mlp, flags)
    return x + mo, aux


def _rwkv_block(lp: RWKVLayer, x, cfg, flags, state=(None, None, None)):
    tsh, wkv, csh = state
    h, (tsh, wkv) = rw.rwkv_time_mix(lp.time, rms_norm(x, lp.ln1, cfg.norm_eps), cfg,
                                     flags, shift_state=tsh, wkv_state=wkv)
    x = x + h
    h, csh = rw.rwkv_channel_mix(lp.chan, rms_norm(x, lp.ln2, cfg.norm_eps),
                                 shift_state=csh)
    return x + h, (tsh, wkv, csh)


def _cross_block(lp: DecoderLayer, x, enc, cfg, flags):
    """An encdec decoder layer's cross-attention to the encoder output."""
    h, _ = attention(lp.cross, rms_norm(x, lp.ln_x, cfg.norm_eps), cfg, flags,
                     kv_x=enc, causal=False, use_rope=False)
    return x + h


def _stack(parts, *lead):
    """Stack per-layer tensors under leading axes ``lead`` (the scan's)."""
    out = torch.stack(parts)
    return out.reshape(*lead, *parts[0].shape)


def _kv(kvs, *lead):
    return {"k": _stack([kv["k"] for kv in kvs], *lead),
            "v": _stack([kv["v"] for kv in kvs], *lead)}


def _encdec_block(lp: DecoderLayer, x, enc, cfg, flags):
    h, kv = attention(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps), cfg, flags)
    x = _cross_block(lp, x + h, enc, cfg, flags)
    return x + mlp(lp.mlp, rms_norm(x, lp.ln2, cfg.norm_eps), cfg.mlp, flags), kv


def _vlm_group(grp: VLMGroup, x, vis, cfg, flags):
    kvs = []
    for lp in grp.self:
        x, kv = _dense_block(lp, x, cfg, flags)
        kvs.append(kv)
    x, cross = _dense_block(grp.cross, x, cfg, flags, kv_x=vis, causal=False,
                            use_rope=False)
    return x, kvs, cross


def _hybrid_group(grp: HybridGroup, shared: DenseLayer, x, cfg, flags):
    states = []
    for lp in grp.mamba:
        h, st = m2.mamba2_block(lp.mamba, rms_norm(x, lp.ln, cfg.norm_eps), cfg, flags)
        x = x + h
        states.append(st)
    x, kv = _dense_block(shared, x, cfg, flags)
    return x, states, kv


def _remat(fn, flags, *args):
    """``fn(*args)``, recomputed in the backward pass when ``flags.remat``
    and autograd records.  ``fn`` binds its layer (a `functools.partial`;
    a closure over the loop variable would read the last layer when the
    backward pass recomputes it)."""
    if flags.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _backbone(model: LM, x, cfg, flags, front: dict, collect_cache: bool = True):
    """Run the family backbone over a full sequence.  Returns ``(hidden,
    cache, aux)``: the decode cache (empty unless ``collect_cache``) and the
    moe load-balancing loss, the mean over layers (0 for other families)."""
    fam = cfg.family
    bind = functools.partial
    aux = like(x, torch.zeros((), device=x.device))
    cache = {}
    if fam in ("dense", "moe", "encdec"):
        kvs, auxes = [], []
        for lp in model.layers:
            if fam == "dense":
                x, kv = _remat(bind(_dense_block, lp, cfg=cfg, flags=flags), flags, x)
            elif fam == "moe":
                x, kv, a = _remat(bind(_moe_block, lp, cfg=cfg, flags=flags), flags, x)
                auxes.append(a)
            else:
                x, kv = _remat(bind(_encdec_block, lp, cfg=cfg, flags=flags), flags, x,
                               front["_enc_out"])
            kvs.append(kv)
        if collect_cache:
            cache["kv"] = _kv(kvs, len(kvs))
        if auxes:
            aux = torch.stack(auxes).mean()
        return x, cache, aux
    if fam == "vlm":
        kvs, cross = [], []
        for grp in model.groups:
            x, gkv, ckv = _remat(bind(_vlm_group, grp, cfg=cfg, flags=flags), flags, x,
                                 front["_vis_embed"])
            kvs += gkv
            cross.append(ckv)
        if collect_cache:
            cache = {"kv": _kv(kvs, *_vlm_groups(cfg)), "cross_kv": _kv(cross, len(cross))}
        return x, cache, aux
    if fam == "ssm":
        states = []
        for lp in model.layers:
            x, st = _remat(bind(_rwkv_block, lp, cfg=cfg, flags=flags), flags, x)
            states.append(st)
        if collect_cache:
            cache["state"] = tuple(_stack([s[j] for s in states], len(states))
                                   for j in range(3))
        return x, cache, aux
    if fam == "hybrid":
        ng, per = _hybrid_groups(cfg)
        states, kvs = [], []
        for grp in model.groups:
            x, gst, kv = _remat(bind(_hybrid_group, grp, model.shared, cfg=cfg,
                                     flags=flags), flags, x)
            states += gst
            kvs.append(kv)
        if collect_cache:
            cache = {"state": (_stack([s[0] for s in states], ng, per),
                               _stack([s[1] for s in states], ng, per)),
                     "kv": _kv(kvs, ng)}
        return x, cache, aux
    raise ValueError(fam)


def _embed(model: LM, tokens, cfg, flags):
    # on a mesh the vocab-split table is gathered for the lookup (GSPMD
    # gathers a table that a gather reads, too); its gradient scatters back
    x = F.embedding(tokens, unshard(model.emb.emb, 0))
    if flags.mesh is not None:
        x = place(x, flags.mesh, batch_placements(flags.mesh, x.shape[0], x.ndim))
    return x.to(compute_dtype(cfg))


def _unembed(model: LM, x, cfg, flags=None):
    x = rms_norm(x, model.ln_f, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ model.emb.emb.T.to(x.dtype)
    else:
        logits = linear(model.lm_head, x)
    # vocab-sharded logits, where the reference constrains them
    logits = shard(logits, flags, "dp", None, "model")
    return logits.float()


def _place_inputs(flags, tokens, extra: dict):
    """On a mesh: the token (and label) arrays batch-placed, the frontends'
    inputs too (`sharding.batch_placements`); unchanged otherwise."""
    if flags.mesh is None:
        return tokens, extra
    b = tokens.shape[0]
    plc = lambda t: batch_placements(flags.mesh, b, t.ndim)
    return (place(tokens, flags.mesh, plc(tokens)),
            {k: place(v, flags.mesh, plc(v)) for k, v in extra.items()})


def _run_frontends(model: LM, cfg, flags, extra: dict) -> dict:
    """The stubbed modality embeddings: vlm's projected patches, encdec's
    encoder output (bidirectional, roped)."""
    dt = compute_dtype(cfg)
    if cfg.family == "vlm":
        return {"_vis_embed": linear(model.vis_proj, extra["vision"].to(dt))}
    if cfg.family == "encdec":
        enc = extra["frames"].to(dt)
        for lp in model.enc_layers:
            enc, _ = _dense_block(lp, enc, cfg, flags, causal=False, use_rope=True)
        return {"_enc_out": rms_norm(enc, model.enc_ln_f, cfg.norm_eps)}
    return {}


# =====================================================================
# public entry points
# =====================================================================
def train_forward(model: LM, tokens, labels, cfg, flags: RuntimeFlags,
                  extra: dict | None = None):
    """The training loss.  tokens, labels: ``[B, S]`` int; ``extra`` as
    `prefill`'s.  Returns ``(loss, metrics)``: ``loss = nll + 0.01 * aux``,
    a 0-d f32 tensor that autograd records (for the parameters that require
    a gradient), and the detached ``nll``, ``aux`` and ``ppl = exp(min(nll,
    20))``."""
    tokens, extra = _place_inputs(flags, tokens, dict(extra or {}, labels=labels))
    labels = extra.pop("labels")
    front = _run_frontends(model, cfg, flags, extra)
    x = _embed(model, tokens, cfg, flags)
    x, _, aux = _backbone(model, x, cfg, flags, front, collect_cache=False)
    logits = _unembed(model, x, cfg, flags)
    logits = unshard(logits, -1)     # the vocab whole on every rank for the loss
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None].long())[..., 0]
    nll = (lse - gold).mean()
    loss = nll + 0.01 * aux
    nll = nll.detach()
    return loss, {"nll": nll, "aux": aux.detach(),
                  "ppl": torch.exp(nll.clamp(max=20.0))}


@torch.no_grad()
def prefill(model: LM, tokens, cfg, flags: RuntimeFlags, extra: dict | None = None,
            pad_to: int | None = None):
    """Full-sequence forward collecting decode state.

    tokens: ``[B, S]`` int; ``extra``: ``{"vision": ...}`` (vlm) or
    ``{"frames": ...}`` (encdec) tensors on the model's device.  Returns
    ``(logits [B, 1, vocab] f32 of the last position, cache)``; the
    self-attention KV cache is padded to ``pad_to`` so that decode can
    append (vlm's cross KV keeps its ``vision_tokens``).
    """
    seq = tokens.shape[1]
    tokens, extra = _place_inputs(flags, tokens, extra or {})
    front = _run_frontends(model, cfg, flags, extra)
    x = _embed(model, tokens, cfg, flags)
    x, cache, _ = _backbone(model, x, cfg, flags, front)
    logits = _unembed(model, x[:, -1:], cfg, flags)

    if pad_to is not None and pad_to != seq and "kv" in cache:
        # [..., B, S, H, D]: zeros after the prompt's S positions
        pad = lambda kv: pad_local(kv, (0, 0, 0, 0, 0, pad_to - seq))
        cache["kv"] = {name: pad(kv) for name, kv in cache["kv"].items()}
    cache["pos"] = seq
    cache.update(front)
    return logits, cache


def init_cache(cfg, batch: int, max_seq: int, dtype=None, device=None):
    """Empty decode cache (decode from scratch).  vlm's ``cross_kv`` and
    encdec's ``_enc_out`` are zeros, as in the reference: fill them from a
    prefill's cache to decode against a real image or recording."""
    if cfg.family not in MODELS:
        raise ValueError(cfg.family)
    dt = dtype or compute_dtype(cfg)
    hd, hkv = cfg.hd, cfg.n_kv_heads
    kv = lambda *lead, seq=max_seq: {
        name: torch.zeros((*lead, batch, seq, hkv, hd), dtype=dt, device=device)
        for name in ("k", "v")}
    cache = {"pos": 0}
    fam = cfg.family
    if fam in ("dense", "moe", "encdec"):
        cache["kv"] = kv(cfg.n_layers)
    if fam == "encdec":
        cache["_enc_out"] = torch.zeros((batch, cfg.enc_frames, cfg.d_model), dtype=dt,
                                        device=device)
    if fam == "vlm":
        ng, per = _vlm_groups(cfg)
        cache["kv"] = kv(ng, per)
        cache["cross_kv"] = kv(ng, seq=cfg.vision_tokens)
    if fam == "ssm":
        st = rw.init_rwkv_state(cfg, batch, dt, device)
        cache["state"] = tuple(a.expand(cfg.n_layers, *a.shape).clone() for a in st)
    if fam == "hybrid":
        ng, per = _hybrid_groups(cfg)
        st = m2.init_mamba2_state(cfg, batch, dt, device)
        cache["state"] = tuple(a.expand(ng, per, *a.shape).clone() for a in st)
        cache["kv"] = kv(ng)
    return cache


def _self_attn_decode(lp, x, kv, idx, pos, cfg):
    return x + attention_decode(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps),
                                kv["k"][idx], kv["v"][idx], pos, cfg)


@torch.no_grad()
def decode_step(model: LM, token, cache, cfg, flags: RuntimeFlags):
    """One-token decode. token: ``[B, 1]`` int.

    Returns ``(logits [B, 1, vocab] f32, cache)``; the cache's tensors are
    updated in place and ``cache["pos"]`` advances by one.  moe runs
    dropless; vlm's cross blocks read the fixed ``cross_kv`` (no rope, the
    last vision token as position); encdec's cross-attention reruns full
    attention over ``_enc_out`` with one query row.
    """
    pos = cache["pos"]
    token, _ = _place_inputs(flags, token, {})
    x = _embed(model, token, cfg, flags)
    fam = cfg.family
    if fam in ("dense", "moe", "encdec"):
        for i, lp in enumerate(model.layers):
            x = _self_attn_decode(lp, x, cache["kv"], i, pos, cfg)
            if fam == "moe":
                x, _ = _moe_ffn(lp, x, cfg, flags, dropless=True)
                continue
            if fam == "encdec":
                x = _cross_block(lp, x, cache["_enc_out"], cfg, flags)
            x = x + mlp(lp.mlp, rms_norm(x, lp.ln2, cfg.norm_eps), cfg.mlp, flags)
    elif fam == "vlm":
        ckv = cache["cross_kv"]
        for g, grp in enumerate(model.groups):
            for i, lp in enumerate(grp.self):
                x = _self_attn_decode(lp, x, cache["kv"], (g, i), pos, cfg)
                x = x + mlp(lp.mlp, rms_norm(x, lp.ln2, cfg.norm_eps), cfg.mlp, flags)
            lp = grp.cross
            x = x + attention_decode(lp.attn, rms_norm(x, lp.ln1, cfg.norm_eps),
                                     ckv["k"][g], ckv["v"][g], cfg.vision_tokens - 1,
                                     cfg, update_cache=False)
            x = x + mlp(lp.mlp, rms_norm(x, lp.ln2, cfg.norm_eps), cfg.mlp, flags)
    elif fam == "ssm":
        tsh, wkv, csh = cache["state"]
        for i, lp in enumerate(model.layers):
            x, (tsh[i], wkv[i], csh[i]) = _rwkv_block(lp, x, cfg, flags,
                                                      (tsh[i], wkv[i], csh[i]))
    elif fam == "hybrid":
        conv, ssm = cache["state"]
        shared = model.shared
        for g, grp in enumerate(model.groups):
            for i, lp in enumerate(grp.mamba):
                h, (conv[g, i], ssm[g, i]) = m2.mamba2_decode(
                    lp.mamba, rms_norm(x, lp.ln, cfg.norm_eps), cfg, flags,
                    conv[g, i], ssm[g, i])
                x = x + h
            x = _self_attn_decode(shared, x, cache["kv"], g, pos, cfg)
            x = x + mlp(shared.mlp, rms_norm(x, shared.ln2, cfg.norm_eps), cfg.mlp, flags)
    else:
        raise ValueError(fam)
    cache["pos"] = pos + 1
    return _unembed(model, x, cfg, flags), cache
