"""Rank programs of `test_torch_mesh.py`: each runs in one of 4 spawned
processes on gloo, on a (2, 2) ("data", "model") mesh from
`make_local_mesh(2, device="cpu")`, and rank 0 writes what the test compares
to ``<out>/rank0.npz``.  No jax here: the test holds the results against
the reference in its own process."""

from __future__ import annotations

import copy
import dataclasses
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

SEED = 0


def run(rank: int, world: int, out: str, case: str, args: tuple) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"),
                                                             world),
                                rank=rank, world_size=world)
        from repro_torch.launch.mesh import make_local_mesh

        mesh = make_local_mesh(2, device="cpu")
        result = CASES[case](mesh, out, *args)
        if rank == 0:
            np.savez(os.path.join(out, "rank0.npz"), **result)
    except BaseException:
        with open(os.path.join(out, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _flags(mesh, **kw):
    from repro_torch.distributed.sharding import dp_axes
    from repro_torch.models import RuntimeFlags

    return (RuntimeFlags(**kw), RuntimeFlags(mesh=mesh, dp=dp_axes(mesh), **kw))


def _models(cfg, mesh, **kw):
    """The same seeded model twice: plain, and placed on the mesh."""
    from repro_torch.distributed.sharding import distribute_params
    from repro_torch.models import init_params

    model = init_params(torch.Generator().manual_seed(SEED), cfg, device="cpu", **kw)
    return model, distribute_params(copy.deepcopy(model), mesh)


def _host(t):
    from torch.distributed.tensor import DTensor

    t = t.full_tensor() if isinstance(t, DTensor) else t
    return t.detach().float().numpy().copy()


def _dims(placements):
    """The tensor dim each mesh dim splits, -1 where it replicates."""
    return np.array([p.dim if p.is_shard() else -1 for p in placements])


def serve(mesh, out, arch):
    """Prefill and 4 greedy decode steps with the kernels (their plain
    versions under local_map on the CPU), with and without the mesh; the
    cache placed by cache_placements between them, as the server does."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import place_cache
    from repro_torch.launch.serve import stub_extra
    from repro_torch.models import decode_step, prefill

    cfg = get_config(arch).reduced()
    plain, sharded = _models(cfg, mesh)
    f0, f1 = _flags(mesh, use_kernels=True)
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (4, 24)))
    # the frontends' inputs (vlm, encdec): seeded normal, not the server's zeros
    extra = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
             for k, v in stub_extra(cfg, 4, "cpu").items()}
    res = {}
    l0, c0 = prefill(plain, tokens, cfg, f0, extra, pad_to=28)
    l1, c1 = prefill(sharded, tokens, cfg, f1, extra, pad_to=28)
    res["prefill_plain"], res["prefill_mesh"] = _host(l0), _host(l1)
    for name in ("k", "v"):
        if "kv" in c0:
            res[f"cache_{name}_plain"], res[f"cache_{name}_mesh"] = (
                _host(c0["kv"][name]), _host(c1["kv"][name]))
    for i, s in enumerate(c0.get("state", ())):
        res[f"state{i}_plain"], res[f"state{i}_mesh"] = _host(s), _host(c1["state"][i])
    c1 = place_cache(c1, mesh, cfg, tokens.shape[0])
    tok = l0[:, -1].argmax(-1, keepdim=True)
    for step in range(4):
        l0, c0 = decode_step(plain, tok, c0, cfg, f0)
        l1, c1 = decode_step(sharded, tok, c1, cfg, f1)
        res[f"decode{step}_plain"], res[f"decode{step}_mesh"] = _host(l0), _host(l1)
        tok = l0[:, -1].argmax(-1, keepdim=True)
    return res


def attention(mesh, out):
    """Causal GQA attention with the query sequence split over "model"
    (fold priority 2: B*H = 6 divides dp = 2, not dp * model = 4)."""
    from types import SimpleNamespace

    from repro_torch.distributed.sharding import dp_axes, place, placements
    from repro_torch.kernels.flash_attention import ops

    flags = SimpleNamespace(mesh=mesh, dp=dp_axes(mesh))
    rng = np.random.default_rng(2)
    b, hq, hkv, lq, d = 2, 3, 1, 16, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((b * h, lq, d)).astype(np.float32))
               for h in (hq, hkv, hkv))
    spec = ops.attention_fold_specs(flags, b * hq, lq)
    assert spec == (("data",), "model", None), spec
    qd = place(q, mesh, placements(mesh, spec))
    kv_spec = ops.attention_fold_specs(flags, b * hkv, lq, is_kv=True)
    kd, vd = (place(t, mesh, placements(mesh, kv_spec)) for t in (k, v))
    want = ops.gqa_attention_folded(q, k, v, batch=b, causal=True, use_kernels=True)
    got = ops.gqa_attention_folded(qd, kd, vd, batch=b, causal=True, use_kernels=True,
                                   flags=flags)
    return {"plain": _host(want), "mesh": _host(got),
            "placements": _dims(qd.placements)}


def moe(mesh, out, capacity_factor):
    """granite-moe's moe_ffn at dp = 2: the input, the weights, and the
    output and aux loss on the mesh."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import batch_placements, distribute_params, place
    from repro_torch.models.moe import MoE, moe_ffn

    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(),
                              capacity_factor=capacity_factor)
    layer = MoE(cfg, gen=torch.Generator().manual_seed(SEED), device="cpu")
    weights = {n: p.detach().numpy().copy() for n, p in layer.named_parameters()}
    holder = torch.nn.Module()      # the rules match the parameters' path: moe/w1
    holder.moe = copy.deepcopy(layer)
    sharded = distribute_params(holder, mesh).moe
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 8, cfg.d_model)).astype(np.float32))
    _, flags = _flags(mesh)
    xd = place(x, mesh, batch_placements(mesh, x.shape[0], x.ndim))
    got, aux = moe_ffn(sharded, xd, cfg, flags)
    return {"x": x.numpy(), "out": _host(got), "aux": _host(aux),
            "expert_placement": _dims(sharded.w1.placements),
            **{f"w/{n}": w for n, w in weights.items()}}


def train(mesh, out, lr, warmup, total, arch="smollm-360m"):
    """One train step of ``arch``, with and without the mesh: the loss and
    every gradient (train_forward, backward), then make_train_step's AdamW
    update from the initial weights."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import train_forward
    from repro_torch.optim import adamw_init

    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(4)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 16))) for k in
             ("tokens", "labels")}
    res = {}
    for name, flags, model in zip(("plain", "mesh"), _flags(mesh, remat=True),
                                  _models(cfg, mesh, param_dtype=torch.float32)):
        model.requires_grad_(True)
        loss, _ = train_forward(model, batch["tokens"], batch["labels"], cfg, flags)
        loss.backward()
        res[f"loss_{name}"] = _host(loss)
        for n, p in model.named_parameters():
            res[f"grad_{name}/{n}"] = _host(p.grad)
        model.zero_grad(set_to_none=True)
        opt = adamw_init(model)
        met = make_train_step(cfg, flags, lr=lr, warmup=warmup, total=total)(
            model, opt, batch)
        res[f"step_loss_{name}"] = _host(met["loss"])
        res[f"grad_norm_{name}"] = _host(met["grad_norm"])
        for n, p in model.named_parameters():
            res[f"param_{name}/{n}"] = _host(p)
            res[f"m_{name}/{n}"] = _host(opt["m"][n])
    res["tokens"], res["labels"] = batch["tokens"].numpy(), batch["labels"].numpy()
    return res


def checkpoint(mesh, out):
    """A checkpoint of a mesh-placed model and its AdamW state written by 4
    ranks (host_<rank>.npz, COMMITTED after the barrier), then restored into
    zeroed DTensors."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models.convert import load_train_state, train_state_tree
    from repro_torch.optim import adamw_init

    cfg = get_config("smollm-360m").reduced()
    _, model = _models(cfg, mesh, param_dtype=torch.float32)
    opt = adamw_init(model)
    with torch.no_grad():
        for m in opt["m"].values():
            m.fill_(0.5)
    opt["step"] = 3
    want = {n: _host(p) for n, p in model.named_parameters()}
    mgr = CheckpointManager(os.path.join(out, "ckpt"), host_id=dist.get_rank(),
                            num_hosts=dist.get_world_size())
    mgr.save_async(3, train_state_tree(model, opt), meta={"loss": 1.0})
    mgr.wait()
    with torch.no_grad():
        for p in model.parameters():
            p.zero_()
        for m in opt["m"].values():
            m.zero_()
    opt["step"] = 0
    restored, step = mgr.restore(train_state_tree(model, opt, "meta"))
    load_train_state(model, opt, restored)
    res = {"step": np.array(step), "opt_step": np.array(opt["step"]),
           "m_min": np.array(min(float(_host(m).min()) for m in opt["m"].values()))}
    for n, p in model.named_parameters():
        res[f"got/{n}"], res[f"want/{n}"] = _host(p), want[n]
        res[f"local/{n}"] = np.array(tuple(p.to_local().shape))
    return res


CASES = {"serve": serve, "attention": attention, "moe": moe, "train": train,
         "checkpoint": checkpoint}
