"""Mixture-of-Experts FFN: top-k routing with grouped capacity and a
scatter dispatch.  Ports `repro/models/moe.py`.

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

On a device mesh (``flags.mesh``) tokens are processed in G = dp groups
(one per data-parallel rank, when the token count divides; else one
group), routed and ranked within their group, with the capacity from the
group's ``T/G`` tokens: GShard's grouped-drop semantics, as the
reference's mesh path, so a sharded MoE computes a different function
from the unsharded one.  Expert parallelism (``_moe_shard_map``'s
counterpart, `_moe_mesh`) runs through `local_map`: rank (i, j) owns group
i and the j-th slice of experts (their weights stay where the placements
put them); dispatch and the expert products run on local tensors, and the
only collective is one all-gather of the expert outputs over "model" (in
the backward pass, one all-reduce of the tokens' gradient).  The aux loss
takes the router statistics of all groups.

No Pallas kernel is involved, so the expert products are `torch.einsum`
calls.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch.distributed.sharding import gather_over, mesh_axes, partial_on, unshard

from .layers import Linear, RuntimeFlags, linear, shard

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
    return _route(linear(p.router, xt).float(), cfg, dropless)


def _route(logits, cfg, dropless: bool) -> Routing:
    """`route` from the router logits ``[T, E]`` (f32)."""
    t = logits.shape[0]
    e, k = cfg.moe_experts, cfg.moe_topk
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = top_k(probs, k)                            # [T, k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = torch.zeros(e, device=logits.device).index_add_(
        0, top_e.reshape(-1), torch.ones(t * k, device=logits.device)) / (t * k)
    aux = e * (me * ce).sum()

    cap = t * k if dropless else int(max(1, t * k / e * cfg.capacity_factor))
    eid = top_e.reshape(t * k)                                 # k-minor pairs
    onehot = F.one_hot(eid, e)                                 # [T*k, E]
    rank = onehot.cumsum(dim=0) - onehot                       # grouped rank
    slot = rank.gather(1, eid[:, None])[:, 0]
    keep = slot < cap
    return Routing(eid, top_p.reshape(t * k), torch.where(keep, slot, cap), keep,
                   cap, aux)


def _dp_groups(flags: RuntimeFlags | None, t: int) -> int:
    if flags is None or flags.mesh is None:
        return 1
    axes = mesh_axes(flags.mesh)
    g = int(np.prod([axes[a] for a in flags.dp]))
    return g if t % g == 0 else 1


def _dispatch(xt, router_w, w1, w2, w3, cfg, dropless, e0: int = 0, xe=None):
    """Route one group's tokens ``xt [T, d]`` and run the experts ``[e0, e0
    + E_local)`` whose weights are given (all of them by default) on the
    pairs routed to them; ``xe``, the same tokens, feeds the experts when
    given (a separate input for its gradient).  Returns the expert outputs
    ``[E_local, C + 1, d]`` (row ``C``: the dropped pairs' trash), the
    routing and the router logits (f32 ``[T, E]``)."""
    d, k = xt.shape[1], cfg.moe_topk
    e_loc = w1.shape[0]
    logits = (xt @ router_w.to(xt.dtype)).float()
    r = _route(logits, cfg, dropless)
    xrep = (xt if xe is None else xe).repeat_interleave(k, dim=0)   # [T*k, d]
    mine = (r.eid >= e0) & (r.eid < e0 + e_loc) & r.keep
    buf = xt.new_zeros((e_loc, r.cap + 1, d))
    buf.index_put_((torch.where(mine, r.eid - e0, 0), torch.where(mine, r.slot, r.cap)),
                   torch.where(mine[:, None], xrep, 0).to(xt.dtype), accumulate=True)
    ye = _expert_ffn(buf, w1.to(xt.dtype), w2.to(xt.dtype),
                     None if w3 is None else w3.to(xt.dtype), cfg.mlp)
    return ye, r, logits


def _combine(ye, r: Routing, k: int):
    """Each token's output ``[T, d]`` f32: its kept pairs' expert outputs
    ``ye [E, C + 1, d]``, weighted and summed over its k choices."""
    y = ye[r.eid, r.slot].float() * r.wts[:, None]
    y = torch.where(r.keep[:, None], y, 0.0)
    return y.reshape(-1, k, y.shape[-1]).sum(dim=1)


def _moe_mesh(p: MoE, x, cfg, flags: RuntimeFlags, dropless: bool):
    """Expert-parallel MoE on a mesh (the reference's ``_moe_shard_map``,
    and its one-group path on a mesh).

    Gradients: each rank's expert weights and the tokens it dispatched take
    only its own experts' share of the gradient, and the gathered outputs
    hand each rank its experts' rows of theirs (`gather_over`), so the
    tokens enter twice: once routed (the router's gradient, the same on
    every "model" rank) and once dispatched (partial sums over "model",
    summed once where the two meet).  The weights are replicated over dp,
    each dp rank holding its group's share of their gradient."""
    from torch.distributed.tensor.experimental import local_map

    b, s, d = x.shape
    e, k = cfg.moe_experts, cfg.moe_topk
    t = b * s
    g = _dp_groups(flags, t)
    mesh = flags.mesh
    if g == 1 or b % g:      # the groups do not follow the batch split
        x = unshard(x, 0)
    xt = shard(x.reshape(g, t // g, d), flags, "dp" if g > 1 else None, None, None)
    w3 = getattr(p, "w3", None)

    def body(xt_l, xe_l, router_w, w1, w2, w3_l):
        e_loc = w1.shape[0]
        j = mesh.get_local_rank("model") if e_loc < e else 0
        ye, r, logits = _dispatch(xt_l[0], router_w, w1, w2, w3_l, cfg, dropless,
                                  j * e_loc, xe=xe_l[0])
        if e_loc < e:
            ye = gather_over(ye, mesh, "model")
        counts = torch.zeros(e, device=ye.device).index_add_(
            0, r.eid, torch.ones_like(r.wts))
        # the group's router statistics, one row per group like the tokens
        return (_combine(ye, r, k)[None].to(x.dtype),
                torch.softmax(logits, dim=-1).sum(dim=0)[None], counts[None])

    dp = tuple(flags.dp) if g > 1 else ()
    plc = lambda w: None if w is None else w.placements
    grad = lambda w: None if w is None else partial_on(w.placements, mesh, dp)
    experts_split = p.w1.to_local().shape[0] < e
    xe_grad = partial_on(xt.placements, mesh, ("model",)) if experts_split else \
        xt.placements
    out, psum, counts = local_map(
        body, out_placements=(xt.placements,) * 3,
        in_placements=(xt.placements, xt.placements, plc(p.router.w), plc(p.w1),
                       plc(p.w2), plc(w3)),
        in_grad_placements=(xt.placements, xe_grad, grad(p.router.w), grad(p.w1),
                            grad(p.w2), grad(w3)),
        device_mesh=mesh,
    )(xt, xt, p.router.w, p.w1, p.w2, w3)
    me = psum.sum(dim=0) / t
    ce = counts.sum(dim=0) / (t * k)
    return out.reshape(b, s, d), e * (me * ce).sum()


def moe_ffn(p: MoE, x, cfg, flags: RuntimeFlags | None = None, dropless: bool = False):
    """x: ``[B, S, d]`` -> ``(out [B, S, d] in x's dtype, aux loss f32)``."""
    if flags is not None and flags.mesh is not None:
        return _moe_mesh(p, x, cfg, flags, dropless)
    b, s, d = x.shape
    ye, r, _ = _dispatch(x.reshape(b * s, d), p.router.w, p.w1, p.w2,
                         getattr(p, "w3", None), cfg, dropless)
    return _combine(ye, r, cfg.moe_topk).reshape(b, s, d).to(x.dtype), r.aux
