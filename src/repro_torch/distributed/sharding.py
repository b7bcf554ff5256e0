"""Sharding rules: params, activations, caches (DP / TP / EP / SP + pod axis),
as `torch.distributed.tensor` placements.  Ports
`repro/distributed/sharding.py`.

Mesh axes: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
  * DP  — batch over ("pod", "data")
  * TP  — attention heads / FFN hidden / vocab over "model"
  * EP  — MoE expert axis over "model"
  * SP  — long-context decode (global_batch=1): KV-cache/state *sequence*
          over "data" instead of the unshardable batch axis

A spec is the reference's ``PartitionSpec`` as a tuple with one entry per
tensor dim: None (replicated), an axis name, or a tuple of axis names.
`placements` turns it into one placement per mesh dim: ``Shard(dim)`` on
every mesh dim that splits ``dim``, ``Replicate()`` elsewhere.  A dim split
over several axes, such as ``(dp..., "model")``, is ``Shard(dim)`` on each
of them in mesh order, which is the reference's major-to-minor order.

Rules are (path-substring, partition-of-trailing-dims) pairs, most specific
first.  They match the REFERENCE path of a parameter (``layers/attn/wq/w``),
which `models.convert.reference_name` derives from the port's per-layer
name; the port holds one tensor per layer, so the reference's stacked
leading axes (padded with None) drop out.  A spec whose split does not
divide a dim falls back to replication, as in the reference.

Every function takes a `DeviceMesh` or a `MeshShape` (axis names and sizes
only, for planning without a process group).

Folds keep heads split.  Attention and the scan fold heads into the batch
dim (``[B, L, H, D] -> [B*H, L, D]``).  Where "model" divides the heads
(`heads_split`), each rank folds, attends or scans, and unfolds its own
shard inside `local_map` (`models.layers._attention_local_heads`,
`kernels.ssd_scan.ops._local_heads`): local views on plain tensors, so no
global view merges a split dim and no head is gathered.  Each rank's rows
come in its own order (its batch rows, then its heads), not the global
b-major order; attention and the scan are row-wise and each unfold
inverts its own fold, so nothing sees the difference.  Kv heads that
"model" does not divide are gathered for the ranks' query heads; query
heads that it does not divide fall back to the reference's fold
priorities on global DTensors, through `fold_heads`, `unfold_heads`,
`unflatten_rows`, `repeat_rows` and `split_heads`, which make the merged
dims whole first (`unshard`; `unshard_grad` for the gradient), because
torch 2.11 refuses a view that merges a split dim into the dim before it
("Attempted to flatten multiple dimensions"), in the forward pass and in
the backward of a view that splits a dim.  Without a mesh they are the
plain views.

Where gradients are reduced.  The input gradient of a column-parallel
product is a partial sum over "model"; `reduce_grad` on the product's
input sums it there once (Megatron's "f", where GSPMD reduces), so the
residual stream's gradient stays whole on "model" and every row-parallel
weight's gradient comes out split as the weight.  A parameter whole on
"model" has its gradient made whole there as it accumulates
(`distribute_params`).  After the backward pass `reduce_grads` reduces
each gradient once over the data-parallel axes, to its parameter's
placements, before the optimizer reads it; `grads_off_placement` lists
the gradients that miss their parameter's placement on "model".  The
multi-RHS column split of the reference's ``rhs_sharding`` is
`repro_torch.core.shard.rhs_blocks`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate

__all__ = [
    "MeshShape",
    "mesh_axes",
    "dp_axes",
    "dp_size",
    "spec_fits",
    "placements",
    "param_specs",
    "param_placements",
    "distribute_params",
    "batch_spec",
    "batch_placements",
    "cache_specs",
    "cache_placements",
    "place",
    "place_cache",
    "like",
    "full_tensor",
    "unshard",
    "unshard_grad",
    "unshard_table",
    "reduce_grad",
    "reduce_grads",
    "grads_off_placement",
    "model_size",
    "heads_split",
    "partial_on",
    "sum_over",
    "max_over",
    "gather_over",
    "split_heads",
    "fold_heads",
    "unflatten_rows",
    "unfold_heads",
    "repeat_rows",
    "local_rows",
    "with_dp_constraint",
]


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, without devices."""

    axis_names: tuple
    sizes: tuple


def mesh_axes(mesh) -> dict[str, int]:
    """``{axis name: size}`` in mesh order, of a `DeviceMesh` or `MeshShape`."""
    if isinstance(mesh, MeshShape):
        return dict(zip(mesh.axis_names, mesh.sizes))
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> tuple:
    """Data-parallel mesh axes (includes 'pod' when present)."""
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def dp_size(mesh) -> int:
    axes = mesh_axes(mesh)
    return int(np.prod([axes[a] for a in dp_axes(mesh)]))


# (substring, trailing-dims partition) — order matters.
_PARAM_RULES: list[tuple[str, tuple]] = [
    # embeddings / unembedding
    ("emb/emb", ("model", None)),
    ("lm_head/w", (None, "model")),
    ("vis_proj/w", (None, None)),
    # MoE: expert-parallel over model axis
    ("moe/router/w", (None, None)),
    ("moe/w1", ("model", None, None)),
    ("moe/w2", ("model", None, None)),
    ("moe/w3", ("model", None, None)),
    # attention projections (also matches cross/ and shared/ blocks)
    ("wq/w", (None, "model")),
    ("wk/w", (None, "model")),
    ("wv/w", (None, "model")),
    ("wo/w", ("model", None)),
    # RWKV channel-mix reuses wk/wv names but transposed roles
    ("chan/wk/w", (None, "model")),
    ("chan/wv/w", ("model", None)),
    # MLPs
    ("mlp/w1/w", (None, "model")),
    ("mlp/w3/w", (None, "model")),
    ("mlp/w2/w", ("model", None)),
    ("dense_mlp/w1/w", (None, "model")),
    ("dense_mlp/w3/w", (None, "model")),
    ("dense_mlp/w2/w", ("model", None)),
    # Mamba2
    ("in_proj/w", (None, "model")),
    ("out_proj/w", ("model", None)),
    ("conv_w", (None, "model")),
    # RWKV time-mix
    ("time/ww/w", (None, "model")),
    ("time/wr/w", (None, "model")),
    ("time/wg/w", (None, "model")),
    ("time/wo/w", ("model", None)),
]
# "chan/wv/w" is shadowed by the generic "wv/w" rule unless the specific
# rules are checked first — hence the sort.
_PARAM_RULES.sort(key=lambda r: -len(r[0]))


def _spec_for(path: str, ndim: int) -> tuple:
    for pat, trailing in _PARAM_RULES:
        if pat in path:
            if len(trailing) > ndim:  # scalar-ish leaf
                return ()
            return (None,) * (ndim - len(trailing)) + tuple(trailing)
    return ()  # replicate (norms, biases, scalars)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def spec_fits(mesh, shape, spec) -> bool:
    """Whether each split dim divides by the product of its axes' sizes."""
    axes = mesh_axes(mesh)
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        size = int(np.prod([axes[a] for a in _entry_axes(entry)]))
        if dim % size != 0:
            return False
    return True


def placements(mesh, spec) -> tuple:
    """One placement per mesh dim for ``spec``: ``Shard(d)`` on each mesh
    axis that splits tensor dim ``d``, else ``Replicate()`` (everywhere for
    a spec of None)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_axes(mesh))
    owner: dict[str, int] = {}
    for dim, entry in enumerate(spec or ()):
        ax = _entry_axes(entry)
        order = [names.index(a) for a in ax]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: the axes of dim {dim} are not in "
                             f"mesh order {tuple(names)}")
        for a in ax:
            if a in owner:
                raise ValueError(f"spec {spec}: axis {a!r} splits two dims")
            owner[a] = dim
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


def param_specs(mesh, model) -> dict[str, tuple]:
    """``{port parameter name: spec}`` by the reference's rules on the
    reference path, with the divisibility fallback to replication.

    Fallback examples in the zoo: whisper's 51865 vocab and granite-moe's
    49155 vocab don't divide 16 (replicated embeddings); mamba2's fused
    in_proj output (2*d_inner + 2*nh*ds + nh = 15400) is replicated.
    """
    from repro_torch.models.convert import reference_name

    out = {}
    for name, p in model.named_parameters():
        ref, lead = reference_name(name)
        spec = _spec_for(ref.replace(".", "/"), p.ndim + lead)[lead:]
        out[name] = spec if spec_fits(mesh, p.shape, spec) else ()
    return out


def param_placements(mesh, model) -> dict[str, tuple]:
    """``{port parameter name: placements}``, the counterpart of the
    reference's ``param_shardings``."""
    return {name: placements(mesh, spec)
            for name, spec in param_specs(mesh, model).items()}


def _whole_on_model(g):
    """``g`` whole on "model": partial sums summed, a split gathered."""
    names = g.device_mesh.mesh_dim_names
    plc = [Replicate() if names[i] == "model" else p for i, p in enumerate(g.placements)]
    return g if tuple(plc) == tuple(g.placements) else g.redistribute(g.device_mesh, plc)


@torch.no_grad()
def distribute_params(model, mesh):
    """Replace every parameter of ``model`` by a DTensor placed by
    `param_placements`.  Each rank holds the full values (the same seed on
    every rank) and keeps its own shard; no data moves.  Returns ``model``.

    A parameter whole on "model" that meets an activation split there (a
    token-shift mix before a column-parallel product, a gain or a skip on
    split heads) gets its gradient from each rank in part; it is made whole
    on "model" as it accumulates (one small collective per parameter), so
    every gradient leaves the backward pass placed as its parameter there."""
    from torch import nn
    from torch.distributed.tensor import distribute_tensor

    plc = param_placements(mesh, model)
    names = list(mesh_axes(mesh))
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = distribute_tensor(p.detach(), mesh, plc[name], src_data_rank=None)
        param = nn.Parameter(d, requires_grad=True)
        if "model" in names and plc[name][names.index("model")].is_replicate():
            param.register_hook(_whole_on_model)   # kept while training is off
        setattr(mod, leaf, param.requires_grad_(p.requires_grad))
    return model


def batch_spec(mesh, batch_size: int, ndim: int = 2) -> tuple:
    """``[B, ...]`` token/label arrays: batch over dp when it divides."""
    if batch_size % dp_size(mesh) == 0:
        return (dp_axes(mesh),) + (None,) * (ndim - 1)
    return (None,) * ndim


def batch_placements(mesh, batch_size: int, ndim: int = 2) -> tuple:
    """Placements for ``[B, S]`` token/label arrays (``batch_sharding``)."""
    return placements(mesh, batch_spec(mesh, batch_size, ndim))


def _kv_spec(ndim: int, b_ok: bool, dp) -> tuple:
    """[..., B, S, H, D] KV cache: batch over dp + SEQUENCE over model.

    Sequence-split KV (flash-decoding style) instead of kv-head split: the
    zoo's kv-head counts (4..10) don't divide the 16-way model axis.  When
    batch doesn't divide dp (long_500k, B=1) the sequence shards over ALL
    axes — pure SP.
    """
    lead = (None,) * (ndim - 4)
    if b_ok:
        return (*lead, dp, "model", None, None)
    return (*lead, None, (*dp, "model"), None, None)


def _cache_leaves(node, path=()):
    """``(reference path, tensor)`` of a cache tree (dicts and tuples)."""
    if isinstance(node, dict):
        for key, child in node.items():
            yield from _cache_leaves(child, path + (str(key),))
    elif isinstance(node, (list, tuple)):
        for i, child in enumerate(node):
            yield from _cache_leaves(child, path + (str(i),))
    elif isinstance(node, torch.Tensor):
        yield "/".join(path), node


def cache_specs(mesh, cfg, cache, batch: int) -> dict[str, tuple]:
    """``{reference path: spec}`` for the tensors of a decode cache built by
    `models.init_cache` or `models.prefill` (``kv/k``, ``state/1``, ...)."""
    dp = dp_axes(mesh)
    b_ok = batch % dp_size(mesh) == 0
    out = {}
    for path_s, leaf in _cache_leaves(cache):
        nd = leaf.ndim
        if nd == 0:
            spec = ()
        elif "kv/" in path_s or "cross_kv/" in path_s:
            spec = _kv_spec(nd, b_ok, dp)
            if not spec_fits(mesh, leaf.shape, spec):
                # e.g. vlm cross-attn: 1601 vision tokens don't divide the
                # model axis -> keep batch sharding, replicate the rest
                spec = (*([None] * (nd - 4)), dp if b_ok else None, None, None, None)
            if not spec_fits(mesh, leaf.shape, spec):
                spec = ()
        elif "_enc_out" in path_s or "_vis" in path_s:
            spec = (dp if b_ok else None, None, None)
            if not spec_fits(mesh, leaf.shape, spec):
                spec = ()
        elif "state/" in path_s:
            bspec = dp if b_ok else None
            bdim = 2 if cfg.family == "hybrid" else 1
            if cfg.family == "hybrid":
                # state/0 conv [G,P,B,kw,C]; state/1 ssm [G,P,B,nh,ds,hd]
                if "state/0" in path_s:
                    spec = (None, None, bspec, None, "model")
                else:
                    spec = (None, None, bspec, "model", None, None)
            elif "state/1" in path_s:
                # rwkv: state/0,2 shift [L,B,1,d]; state/1 wkv [L,B,nh,ds,ds]
                spec = (None, bspec, "model", None, None)
            else:
                spec = (None, bspec, None, None)
            if not spec_fits(mesh, leaf.shape, spec):
                # fall back: batch-only, then full replication
                spec = tuple(bspec if i == bdim else None for i in range(nd))
            if not spec_fits(mesh, leaf.shape, spec):
                spec = ()
        else:
            spec = ()
        out[path_s] = spec
    return out


def cache_placements(mesh, cfg, cache, batch: int) -> dict[str, tuple]:
    """``{reference path: placements}``, the counterpart of the reference's
    ``cache_shardings``."""
    return {path: placements(mesh, spec)
            for path, spec in cache_specs(mesh, cfg, cache, batch).items()}


def place(t, mesh, plc):
    """``t`` as a DTensor with placements ``plc``: a DTensor is
    redistributed; a plain tensor, the same global value on every rank,
    keeps this rank's shard (no data moves)."""
    from torch.distributed.tensor import distribute_tensor

    if isinstance(t, DTensor):
        return t.redistribute(mesh, plc)
    return distribute_tensor(t, mesh, plc, src_data_rank=None)


def place_cache(cache: dict, mesh, cfg, batch: int) -> dict:
    """The decode cache with every tensor placed by `cache_placements`."""
    plc = cache_placements(mesh, cfg, cache, batch)

    def walk(node, path=()):
        if isinstance(node, dict):
            return {k: walk(v, path + (str(k),)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),)) for i, v in enumerate(node))
        if isinstance(node, torch.Tensor):
            return place(node, mesh, plc["/".join(path)])
        return node

    return walk(cache)


def like(ref, t):
    """``t``, a plain tensor with the same value on every rank, as a
    replicated DTensor on ``ref``'s mesh when ``ref`` is a DTensor."""
    if isinstance(ref, DTensor) and not isinstance(t, DTensor):
        mesh = ref.device_mesh
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t


def full_tensor(t):
    """A DTensor's global value (a collective: every rank calls it); any
    other tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def unshard(t, *dims: int):
    """``t`` with ``dims`` whole on every rank: a DTensor split on one of
    them is gathered there (other placements kept); any other tensor as it
    is.  Used before a view that merges a split dim into the one before it,
    which DTensor refuses to do by itself."""
    if not isinstance(t, DTensor):
        return t
    dims = {d % t.ndim for d in dims}
    if not any(p.is_shard() and p.dim in dims for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_shard() and p.dim in dims
                                          else p for p in t.placements])


def unshard_grad(t, *dims: int):
    """``t`` itself; in the backward pass its gradient is made whole on
    ``dims`` before it flows on (`unshard`).  Put on the result of a view
    that splits a dim in two: the gradient then merges them again, which
    DTensor refuses when the second is split."""
    if isinstance(t, DTensor) and t.requires_grad:
        t.register_hook(lambda g: unshard(g, *dims))
    return t


def _sum_partial(g, axes):
    """``g`` with its partial sums over the mesh ``axes`` reduced there."""
    names = g.device_mesh.mesh_dim_names
    plc = [Replicate() if p.is_partial() and names[i] in axes else p
           for i, p in enumerate(g.placements)]
    return g if tuple(plc) == tuple(g.placements) else g.redistribute(g.device_mesh, plc)


def reduce_grad(t):
    """``t`` itself; in the backward pass its gradient, partial sums over
    "model", is summed there (one all-reduce) before it flows on.  Put on
    the input of a column-parallel product (its weight split over "model"
    by columns): each rank's part of the input gradient comes from its own
    columns.  This is Megatron's "f" operator, and where GSPMD reduces; the
    residual stream's gradient then stays whole on "model", so every
    row-parallel weight's gradient comes out split as the weight.  Without
    a mesh it does nothing."""
    if isinstance(t, DTensor) and t.requires_grad:
        t.register_hook(lambda g: _sum_partial(g, ("model",)))
    return t


def grads_off_placement(model) -> dict[str, tuple]:
    """``{name: (gradient placements, parameter placements)}`` of each
    DTensor parameter whose gradient is placed otherwise, over "model" or
    in its local shape: what `reduce_grad` should have prevented.  Partial
    sums over the data-parallel axes are left for `reduce_grads`."""
    out = {}
    for name, p in model.named_parameters():
        g = p.grad
        if not isinstance(g, DTensor):
            continue
        names = p.device_mesh.mesh_dim_names
        on_model = lambda plc: [q for i, q in enumerate(plc) if names[i] == "model"]
        if (on_model(g.placements) != on_model(p.placements)
                or g.to_local().shape != p.to_local().shape):
            out[name] = (tuple(g.placements), tuple(p.placements))
    return out


@torch.no_grad()
def reduce_grads(model) -> None:
    """Redistribute each DTensor parameter's gradient to the parameter's
    placements: the partial sums over the data-parallel axes reduced, once
    per gradient, before the optimizer reads them (the reference's jitted
    step hands AdamW gradients in the parameters' shardings)."""
    for p in model.parameters():
        g = p.grad
        if isinstance(g, DTensor) and tuple(g.placements) != tuple(p.placements):
            p.grad = g.redistribute(p.device_mesh, p.placements)


def model_size(mesh) -> int:
    """The size of the "model" axis (1 without one)."""
    return int(mesh_axes(mesh).get("model", 1))


def heads_split(mesh, heads: int) -> bool:
    """Whether ``heads`` split evenly over "model": each rank then folds,
    and attends or scans, whole heads of its own shard."""
    return heads % model_size(mesh) == 0


def partial_on(plc, mesh, axes) -> tuple:
    """``plc`` with ``Partial()`` in place of ``Replicate()`` on the mesh
    ``axes``: the placements of a gradient each rank holds its own share
    of (`local_map`'s ``in_grad_placements``)."""
    from torch.distributed.tensor import Partial

    names = list(mesh_axes(mesh))
    return tuple(Partial() if names[i] in axes and p.is_replicate() else p
                 for i, p in enumerate(plc))


def _group_name(mesh, axis: str) -> str:
    return mesh.get_group(mesh.mesh_dim_names.index(axis)).group_name


class _SumOver(torch.autograd.Function):
    """All-reduce sum; the gradient passes unchanged, which is right where
    every rank goes on with the sum the same way (a replicated result)."""

    @staticmethod
    def forward(ctx, t, group: str):
        c10d = torch.ops._c10d_functional
        return c10d.wait_tensor(c10d.all_reduce(t.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherOver(torch.autograd.Function):
    """All-gather on dim 0; the gradient is this rank's rows of the
    gathered one, which is right where every rank goes on with the gathered
    tensor the same way."""

    @staticmethod
    def forward(ctx, t, group: str, size: int, rank: int):
        c10d = torch.ops._c10d_functional
        ctx.rows, ctx.rank = t.shape[0], rank
        return c10d.wait_tensor(c10d.all_gather_into_tensor(t.contiguous(), size, group))

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rank * ctx.rows:(ctx.rank + 1) * ctx.rows], None, None, None


def sum_over(t, mesh, axis: str):
    """Inside `local_map`: ``t`` summed over the mesh ``axis`` (one
    all-reduce), its gradient passed on unchanged (the sum is used alike
    on every rank)."""
    return _SumOver.apply(t, _group_name(mesh, axis))


@torch.no_grad()
def max_over(t, mesh, axis: str):
    """Inside `local_map`: the elementwise max of ``t`` over the mesh
    ``axis`` (one all-reduce, no gradient)."""
    c10d = torch.ops._c10d_functional
    return c10d.wait_tensor(c10d.all_reduce(t.contiguous(), "max", _group_name(mesh, axis)))


def gather_over(t, mesh, axis: str):
    """Inside `local_map`: every rank's ``t`` of the mesh ``axis``
    concatenated on dim 0 (one all-gather); the gradient is this rank's
    rows (the gathered tensor is used alike on every rank)."""
    return _GatherOver.apply(t, _group_name(mesh, axis), mesh.size(
        mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis))


def unshard_table(t, dim: int = 0):
    """`unshard` for a table that a lookup reads: ``t`` whole on ``dim`` on
    every rank.  The gradient, each rank's lookups, is cut back to ``t``'s
    split (no data moves) before the gather's backward reduces it over the
    data-parallel axes, so each rank reduces its shard, not the table."""
    full = unshard(t, dim)
    if full is not t and full.requires_grad:
        plc = t.placements
        full.register_hook(lambda g: g.redistribute(
            g.device_mesh, [p if p.is_shard(dim) else q for p, q in zip(plc, g.placements)]))
    return full


def split_heads(t, h: int, whole: bool = False):
    """``t [..., h * D]`` as ``[..., h, D]``.  A DTensor split on the last
    dim keeps the split on the heads when ``h`` divides by it, else the dim
    is made whole first; ``whole``: the heads whole on every rank (for a
    product that merges them into the dims before)."""
    if isinstance(t, DTensor):
        mesh, last = t.device_mesh, t.ndim - 1
        n = int(np.prod([mesh.size(i) for i, p in enumerate(t.placements)
                         if p.is_shard(last)]))
        if h % n:
            t = unshard(t, last)
    t = t.reshape(*t.shape[:-1], h, t.shape[-1] // h)
    return unshard(t, -2) if whole else t


def fold_heads(t, heads: int | None = None):
    """``t [B, L, H, D]`` (or ``[B, L, H * D]`` with ``heads``) folded to
    ``[B * H, L, D]``, b-major.  A DTensor's sequence and heads are made
    whole first, and its gradient handed back contiguous (DTensor views the
    transposed gradient as its global layout); place the result with
    `flash_attention.ops.constrain_folded`."""
    if isinstance(t, DTensor) and t.requires_grad:
        t.register_hook(lambda g: g.contiguous())
    if heads is not None:
        t = split_heads(t, heads)
    b, l, h, d = t.shape
    return unshard(t, 1, 2).transpose(1, 2).reshape(b * h, l, d)


def _rows_over_dp(t, flags, lead: int):
    """A DTensor ``[R, ...]`` with its rows split over dp only (when
    ``lead`` divides by it) and every other dim whole."""
    if not isinstance(t, DTensor):
        return t
    dp = tuple(flags.dp)
    dp_n = int(np.prod([mesh_axes(flags.mesh)[a] for a in dp]))
    spec = (dp, None) if lead % dp_n == 0 else (None,)
    return t.redistribute(t.device_mesh, placements(flags.mesh, spec))


def unflatten_rows(t, flags, lead: int):
    """``t [R, ...]`` as ``[lead, R // lead, ...]`` (batch, heads): the
    rows stay split over dp, the heads come out whole on every rank, and
    the gradient is made whole on them before the view merges it back."""
    t = _rows_over_dp(t, flags, lead)
    return unshard_grad(t.reshape(lead, t.shape[0] // lead, *t.shape[1:]), 1)


def unfold_heads(tf, flags, batch: int):
    """``tf [B * H, L, D]`` unfolded to ``[B, L, H, D]`` (`fold_heads`'s
    inverse)."""
    return unflatten_rows(tf, flags, batch).transpose(1, 2)


def repeat_rows(tf, flags, batch: int, g: int):
    """``tf [B * H, L, D]`` with each head repeated ``g`` times in a row:
    ``[B * H * g, L, D]`` (kv heads broadcast to their query heads)."""
    bh, l, d = tf.shape
    h = bh // batch
    t = unshard_grad(_rows_over_dp(tf, flags, batch).reshape(batch, h, 1, l, d), 1)
    return unshard_grad(t.expand(batch, h, g, l, d), 1, 2).reshape(bh * g, l, d)


def local_rows(fn, mesh, spec, n_in: int, n_out: int = 1):
    """``fn`` on each rank's local rows of ``n_in`` DTensor arguments placed
    by ``spec`` (redistributed to it), returning ``n_out`` DTensors placed
    the same way: `local_map` with every placement equal."""
    from torch.distributed.tensor.experimental import local_map

    plc = list(placements(mesh, spec))   # a list: one output's placements
    return local_map(fn, out_placements=plc if n_out == 1 else (plc,) * n_out,
                     in_placements=(plc,) * n_in, device_mesh=mesh,
                     redistribute_inputs=True)


def with_dp_constraint(x, mesh):
    """Place a [B, ...] activation batch over dp."""
    return place(x, mesh, placements(mesh, (dp_axes(mesh),) + (None,) * (x.ndim - 1)))
