"""Mixture-of-Experts FFN: top-k routing with grouped capacity and a
scatter dispatch.  Ports `repro/models/moe.py` at one data-parallel group.

Tokens are routed by a softmax router to their top ``k`` experts (weights
renormalised over the k).  The (token, choice) pairs are flattened
k-minor, and each pair's slot in its expert's buffer is its rank among the
earlier pairs routed to that expert (an exclusive cumsum over the one-hot
assignments).  Pairs whose slot reaches the capacity ``C = T*k/E *
capacity_factor`` (``T*k`` when ``dropless``, as in decode) are dropped:
they scatter into a trash row at ``C`` and contribute nothing.  The
experts run as batched products over ``[E, C + 1, d]`` buffers.  The
Switch load-balancing loss ``E * sum_e f_e * p_e`` comes back beside the
output.

The reference's expert-parallel `shard_map` path (``_moe_shard_map``)
needs a device mesh and waits for the distributed slice (ROADMAP Queue 1,
item 4).  No Pallas kernel is involved, so the expert products are
`torch.einsum` calls.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn
from torch.nn import functional as F

from .layers import Linear, linear

__all__ = ["MoE", "Routing", "moe_ffn", "route", "top_k"]


class MoE(nn.Module):
    """``router`` and the stacked expert weights ``w1, w3 [E, d, ff]``,
    ``w2 [E, ff, d]``, drawn as the reference's ``init_moe``."""

    def __init__(self, cfg, *, gen=None, device=None, dtype=torch.float32):
        super().__init__()
        d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe_experts
        self.router = Linear(d, e, scale=0.02, gen=gen, device=device, dtype=dtype)

        def experts(d_in, d_out):
            w = torch.randn((e, d_in, d_out), generator=gen, device=device) * d_in ** -0.5
            return nn.Parameter(w.to(dtype), requires_grad=False)

        self.w1 = experts(d, ff)
        self.w2 = experts(ff, d)
        if cfg.mlp == "swiglu":
            self.w3 = experts(d, ff)


def _expert_ffn(buf, w1, w2, w3, kind: str):
    """buf: ``[E, C, d]`` -> ``[E, C, d]``; plain batched products."""
    h1 = torch.einsum("ecd,edf->ecf", buf, w1)
    if w3 is not None and kind == "swiglu":
        h = F.silu(h1) * torch.einsum("ecd,edf->ecf", buf, w3)
    else:
        h = F.gelu(h1, approximate="tanh")   # jax.nn.gelu's default
    return torch.einsum("ecf,efd->ecd", h, w2)


def top_k(probs, k: int):
    """The ``k`` largest router probabilities of each token and their
    experts, in descending order, the lower expert first on a tie, as
    ``lax.top_k`` orders them (`torch.topk` leaves ties unordered, and bf16
    router logits tie often: they take few distinct values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """Where the (token, choice) pairs go, flattened k-minor."""

    eid: torch.Tensor      # [T*k] expert of each pair
    wts: torch.Tensor      # [T*k] renormalised router weight (f32)
    slot: torch.Tensor     # [T*k] slot in the expert's buffer; ``cap`` if dropped
    keep: torch.Tensor     # [T*k] the pair fits its expert's capacity
    cap: int               # capacity per expert
    aux: torch.Tensor      # Switch load-balancing loss (f32)


def route(p: MoE, xt, cfg, dropless: bool = False) -> Routing:
    """Route tokens ``xt [T, d]``: softmax router, top-k, renormalised
    weights, the aux loss and each pair's slot under the capacity."""
    t = xt.shape[0]
    e, k = cfg.moe_experts, cfg.moe_topk
    logits = linear(p.router, xt).float()                     # [T, E]
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)                            # [T, k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = torch.zeros(e, device=xt.device).index_add_(
        0, top_e.reshape(-1), torch.ones(t * k, device=xt.device)) / (t * k)
    aux = e * (me * ce).sum()

    cap = t * k if dropless else int(max(1, t * k / e * cfg.capacity_factor))
    eid = top_e.reshape(t * k)                                 # k-minor pairs
    onehot = F.one_hot(eid, e)                                 # [T*k, E]
    rank = onehot.cumsum(dim=0) - onehot                       # grouped rank
    slot = rank.gather(1, eid[:, None])[:, 0]
    keep = slot < cap
    return Routing(eid, top_p.reshape(t * k), torch.where(keep, slot, cap), keep,
                   cap, aux)


def moe_ffn(p: MoE, x, cfg, dropless: bool = False):
    """x: ``[B, S, d]`` -> ``(out [B, S, d] in x's dtype, aux loss f32)``."""
    b, s, d = x.shape
    k = cfg.moe_topk
    xt = x.reshape(b * s, d)
    r = route(p, xt, cfg, dropless)
    xrep = xt.repeat_interleave(k, dim=0)                      # [T*k, d]
    xrep = torch.where(r.keep[:, None], xrep, 0).to(x.dtype)

    buf = x.new_zeros((cfg.moe_experts, r.cap + 1, d))         # row cap: trash
    buf.index_put_((r.eid, r.slot), xrep, accumulate=True)
    w3 = getattr(p, "w3", None)
    ye = _expert_ffn(buf, p.w1.to(x.dtype), p.w2.to(x.dtype),
                     None if w3 is None else w3.to(x.dtype), cfg.mlp)
    y = ye[r.eid, r.slot].float() * r.wts[:, None]
    y = torch.where(r.keep[:, None], y, 0.0)
    out = y.reshape(b * s, k, d).sum(dim=1)
    return out.reshape(b, s, d).to(x.dtype), r.aux
