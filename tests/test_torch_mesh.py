"""The port on a device mesh: 4 gloo ranks on the CPU, mesh (2, 2).

Each case spawns 4 processes (`torch_mesh_workers.py`) that meet through a
FileStore under ``tmp_path`` (no fixed port: pytest runs several workers at
once), each joined within 300 s.  Rank 0 writes its results, and the test
holds them, in this process, against the unsharded port and the JAX
package, in f32 on reduced configs:

  * serving (all six families; vlm and encdec with seeded frontend
    inputs): prefill and 4 decode steps with
    ``use_kernels=True`` (the kernels' plain versions under `local_map`)
    equal the unsharded port to 1e-5 of the largest logit, the caches too;
  * causal attention with the query sequence split over "model" (fold
    priority 2) equals the unsharded result: the kernel call takes whole
    query rows (B*H over dp), since its causal mask has no query offset;
  * granite-moe's moe_ffn at dp = 2 with a capacity that drops pairs
    equals the reference's moe_ffn run on each dp group's tokens,
    concatenated (GShard's grouped capacity), with the aux loss from the
    reference's formula over all tokens;
  * one smollm train step: the loss, every gradient leaf and one AdamW
    update equal the unsharded port and the reference's make_train_step
    without a mesh, to 1e-5 (the other five families and 3 query heads on
    a 2-way "model" axis: the unsharded port), and after the backward pass
    every gradient has its parameter's placement on "model" and its local
    shape;
  * a 4-rank checkpoint writes host_0..3.npz, meta.json and COMMITTED,
    restores equal, and its host_0.npz loads through the reference's
    restore_checkpoint.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_workers as workers
from repro.checkpoint import checkpoint as jckpt
from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import RuntimeFlags as JFlags
from repro.models import init_params as jinit_params
from repro.models import moe as jmoe
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.models.convert import tree_from_named

WORLD, JOIN_S = 4, 300
LR, WARMUP, TOTAL = 3e-3, 2, 10


def _spawn(tmp_path, case, *args) -> dict:
    """Run ``case`` on 4 ranks; rank 0's results."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=workers.run, args=(r, WORLD, str(tmp_path), case, args))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join()
    errors = [open(tmp_path / f"error{r}.txt").read() for r in range(WORLD)
              if (tmp_path / f"error{r}.txt").exists()]
    assert not alive, f"{case}: {len(alive)} ranks still running after {JOIN_S} s"
    assert not errors and all(p.exitcode == 0 for p in procs), "\n".join(errors)
    with np.load(tmp_path / "rank0.npz") as f:
        return dict(f)


def _close(got, want, rel, what):
    err = float(np.abs(got - want).max())
    assert err <= rel * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b", "zamba2-2.7b",
                                  "granite-moe-1b-a400m", "whisper-base",
                                  "llama-3.2-vision-11b"])
def test_serving_on_the_mesh_equals_unsharded(tmp_path, arch):
    res = _spawn(tmp_path, "serve", arch)
    names = sorted({k.rsplit("_", 1)[0] for k in res})
    assert {"prefill", "decode0", "decode3"} <= set(names), names
    for name in names:
        _close(res[f"{name}_mesh"], res[f"{name}_plain"], 1e-5, f"{arch} {name}")


def test_causal_attention_with_the_query_sequence_sharded(tmp_path):
    res = _spawn(tmp_path, "attention")
    assert list(res["placements"]) == [0, 1]      # B*H over data, queries over model
    _close(res["mesh"], res["plain"], 1e-6, "attention")


def test_moe_at_dp2_equals_the_reference_per_group(tmp_path):
    capacity_factor = 1.0       # drops pairs: the grouped capacity matters
    res = _spawn(tmp_path, "moe", capacity_factor)
    cfg_j = jget_config("granite-moe-1b-a400m").reduced()
    cfg_j = type(cfg_j)(**{**cfg_j.__dict__, "capacity_factor": capacity_factor})
    p = {"router": {"w": jnp.asarray(res["w/router.w"])},
         **{k: jnp.asarray(res[f"w/{k}"]) for k in ("w1", "w2", "w3") if f"w/{k}" in res}}
    x = res["x"]
    b, s, d = x.shape
    groups = x.reshape(2, b * s // 2, d)
    outs = [np.asarray(jmoe.moe_ffn(p, jnp.asarray(xg[None]), cfg_j,
                                    JFlags(mesh=None))[0])[0] for xg in groups]
    want = np.concatenate(outs).reshape(b, s, d)
    _close(res["out"], want, 1e-5, "moe out")
    unsharded, _ = jmoe.moe_ffn(p, jnp.asarray(x), cfg_j, JFlags(mesh=None))
    assert not np.allclose(np.asarray(unsharded), want, atol=1e-6), \
        "the capacity drops nothing: grouped and ungrouped routing agree"
    # aux: the reference's formula over all tokens
    xt = x.reshape(b * s, d)
    probs = jax.nn.softmax(jnp.asarray(xt) @ p["router"]["w"], axis=-1)
    _, top_e = jax.lax.top_k(probs, cfg_j.moe_topk)
    e, k = cfg_j.moe_experts, cfg_j.moe_topk
    me = np.asarray(probs).mean(axis=0)
    ce = np.bincount(np.asarray(top_e).reshape(-1), minlength=e) / (b * s * k)
    np.testing.assert_allclose(float(res["aux"]), e * float(np.sum(me * ce)), rtol=1e-5)
    assert list(res["expert_placement"]) == [-1, 0]   # experts split over model


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _train_step_equals_unsharded(res, adamw=True):
    """Rank 0's train-step results: the mesh's loss, every gradient leaf
    and (``adamw``) the AdamW update against the unsharded port's, to
    1e-5."""
    from test_torch_train import _assert_params_after_adamw

    np.testing.assert_allclose(res["loss_mesh"], res["loss_plain"], rtol=1e-5)
    assert list(res["off_placement"]) == [], res["off_placement"]
    grads = sorted(k.split("/", 1)[1] for k in res if k.startswith("grad_plain/"))
    assert len(grads) > 10
    for n in grads:
        assert _rel_l2(res[f"grad_mesh/{n}"], res[f"grad_plain/{n}"]) <= 1e-5, n
    named = lambda kind, side: {n: torch.from_numpy(res[f"{kind}_{side}/{n}"])
                                for n in grads}
    if adamw:
        _assert_params_after_adamw(tree_from_named(named("param", "mesh")),
                                   tree_from_named(named("param", "plain")),
                                   tree_from_named(named("m", "mesh")),
                                   tree_from_named(named("m", "plain")), LR / WARMUP,
                                   1e-5, "mesh vs unsharded parameters")
    return named


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-2.7b"])
def test_scan_families_train_on_the_mesh(tmp_path, arch):
    """The scan's backward through local_map and the merged-B*H views: the
    loss and every gradient leaf (AdamW's update is the smollm test's)."""
    _train_step_equals_unsharded(_spawn(tmp_path, "train", LR, WARMUP, TOTAL, arch),
                                 adamw=False)


@pytest.mark.parametrize("arch, heads", [
    ("granite-moe-1b-a400m", None), ("whisper-base", None),
    ("llama-3.2-vision-11b", None),
    # 3 query heads, 1 kv head: "model" (2) divides neither, so attention
    # folds whole heads by the reference's fold priorities
    ("smollm-360m", (3, 1))])
def test_other_families_train_on_the_mesh(tmp_path, arch, heads):
    """One train step of the experts (expert-parallel gradients through
    local_map, no pair dropped), the cross-attention families (the kv
    source's gradient reduced once over every layer) and query heads that
    "model" does not divide: the loss, every gradient leaf and AdamW's
    update equal the unsharded port's, each gradient placed as its
    parameter on "model"."""
    _train_step_equals_unsharded(_spawn(tmp_path, "train", LR, WARMUP, TOTAL, arch,
                                        heads))


def test_train_step_on_the_mesh_equals_unsharded_and_reference(tmp_path):
    from test_torch_train import _assert_params_after_adamw

    res = _spawn(tmp_path, "train", LR, WARMUP, TOTAL)
    named = _train_step_equals_unsharded(res)
    # the reference's step without a mesh, from the same initial weights
    cfg = get_config("smollm-360m").reduced()
    model = init_params(torch.Generator().manual_seed(workers.SEED), cfg, device="cpu",
                        param_dtype=torch.float32)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                           tree_from_named(dict(model.named_parameters())))
    jflags = JFlags(use_pallas=False, remat=True, mesh=None)
    jstep = jax.jit(jmake_train_step(jget_config("smollm-360m").reduced(), jflags, lr=LR,
                                     warmup=WARMUP, total=TOTAL))
    batch = {k: res[k].astype(np.int32) for k in ("tokens", "labels")}
    jp, jopt, jmet = jstep(jparams, jadamw_init(jparams), batch)
    np.testing.assert_allclose(res["step_loss_mesh"], float(jmet["loss"]), rtol=1e-5)
    np.testing.assert_allclose(res["grad_norm_mesh"], float(jmet["grad_norm"]), rtol=1e-5)
    _assert_params_after_adamw(tree_from_named(named("param", "mesh")), jp,
                               tree_from_named(named("m", "mesh")), jopt["m"],
                               float(jmet["lr"]), 1e-5, "mesh vs reference parameters")


def test_four_rank_checkpoint_restores_and_loads_in_the_reference(tmp_path):
    res = _spawn(tmp_path, "checkpoint")
    step_dir = tmp_path / "ckpt" / "step_00000003"
    assert sorted(os.listdir(step_dir)) == ["COMMITTED", "host_0.npz", "host_1.npz",
                                           "host_2.npz", "host_3.npz", "meta.json"]
    assert int(res["step"]) == 3 and int(res["opt_step"]) == 3
    assert float(res["m_min"]) == 0.5
    names = [k.split("/", 1)[1] for k in res if k.startswith("got/")]
    sharded = 0
    for n in names:
        np.testing.assert_array_equal(res[f"got/{n}"], res[f"want/{n}"], err_msg=n)
        sharded += tuple(res[f"local/{n}"]) != res[f"want/{n}"].shape
    assert sharded > 0, "no parameter was split over the ranks"
    # every host wrote the gathered tree
    with np.load(step_dir / "host_0.npz") as h0, np.load(step_dir / "host_3.npz") as h3:
        assert sorted(h0.files) == sorted(h3.files)
        for key in h0.files:
            np.testing.assert_array_equal(h0[key], h3[key])
    # host_0.npz through the reference's restore
    cfg_j = jget_config("smollm-360m").reduced()
    params = jax.eval_shape(lambda: jinit_params(jax.random.PRNGKey(0), cfg_j))
    example = {"params": params, "opt": jax.eval_shape(jadamw_init, params)}
    tree, step = jckpt.restore_checkpoint(str(tmp_path / "ckpt"), example, host_id=0)
    assert step == 3 and int(tree["opt"]["step"]) == 3
    want = tree_from_named({n: torch.from_numpy(res[f"want/{n}"]) for n in names})
    got_leaves = jax.tree_util.tree_leaves_with_path(tree["params"])
    want_leaves = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), want)))
    assert len(got_leaves) == len(want_leaves)
    for path, leaf in got_leaves:
        np.testing.assert_array_equal(np.asarray(leaf), want_leaves[path])
