"""The port's training substrate against the JAX package's, on the CPU:
schedules, clipping, AdamW, the data pipeline, the fault-tolerance and
elastic copies, checkpoints (cross-loading both ways, bf16 bit for bit)
and `launch/train.py` (restart-resume, an injected failure, the refused
mesh flags).

The JAX package's own `test_substrate.py` scenarios are repeated on the
port.  Its `test_train_restart_resumes` fails on the reference
(``jax.make_mesh``'s Explicit axes, ROADMAP Queue 3); the port's twin here
runs it on the port alone.
"""

import dataclasses
import json
import os
import re
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import checkpoint as jckpt
from repro import optim as joptim
from repro.configs import get_config as jget_config
from repro.data import SyntheticLMDataset as JDataset
from repro.data import make_train_iterator as jmake_train_iterator
from repro.distributed import HeartbeatMonitor as JHeartbeat
from repro.distributed import StragglerPolicy as JStraggler
from repro.distributed import plan_remesh as jplan_remesh
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import RuntimeFlags as JFlags
from repro_torch import optim
from repro_torch.checkpoint import (
    CheckpointManager,
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMDataset, make_train_iterator
from repro_torch.distributed import HeartbeatMonitor, StragglerPolicy, plan_remesh
from repro_torch.launch import steps, train
from repro_torch.models import RuntimeFlags, init_params, params_from_jax, prefill
from repro_torch.models.convert import (
    load_train_state,
    named_from_tree,
    train_state_tree,
    tree_from_named,
)

from test_torch_families import _jax_params

F32 = np.float32


def _seeded_tree(seed):
    """A small parameter-like tree of normal leaves (numpy f32)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 7)).astype(F32),
            "b": rng.standard_normal(7).astype(F32),
            "layers": {"g": rng.standard_normal((3, 4)).astype(F32)}}


def _bits(a):
    """The raw 16 bits of a bf16 jax array or torch tensor."""
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


# ------------------------------------------------------------------ schedules
@pytest.mark.parametrize("base,warmup,total", [(1.0, 10, 100), (3e-3, 20, 30),
                                               (3e-4, 100, 10000), (0.1, 0, 5)])
def test_schedules_equal_reference(base, warmup, total):
    for s in list(range(0, 120)) + [total, 5 * total]:
        want = float(joptim.cosine_warmup(jnp.asarray(s), base, warmup, total))
        got = optim.cosine_warmup(s, base, warmup, total)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f"cosine step {s}")
        want = float(joptim.linear_warmup(jnp.asarray(s), base, warmup))
        np.testing.assert_allclose(optim.linear_warmup(s, base, warmup), want,
                                   rtol=1e-6, err_msg=f"linear step {s}")


def test_cosine_warmup_schedule():
    lrs = [optim.cosine_warmup(s, 1.0, 10, 100) for s in range(100)]
    assert lrs[0] < 0.2
    assert abs(max(lrs) - 1.0) < 0.1
    assert lrs[-1] < 0.2


# ------------------------------------------------------------------ clipping
@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e3])
def test_clip_by_global_norm_equals_reference(max_norm):
    tree = _seeded_tree(0)
    tree["h"] = np.random.default_rng(1).standard_normal(9).astype(F32)
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["h"] = jtree["h"].astype(jnp.bfloat16)
    want, jnorm = joptim.clip_by_global_norm(jtree, max_norm)
    grads = {k: torch.from_numpy(np.array(v, F32)) for k, v in _flat(jtree).items()}
    grads["h"] = grads["h"].to(torch.bfloat16)
    before = {k: v.clone() for k, v in grads.items()}
    norm = optim.clip_by_global_norm(list(grads.values()) + [None], max_norm)
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    np.testing.assert_allclose(float(optim.global_norm(before.values())), float(jnorm),
                               rtol=1e-6)
    for k, w in _flat(want).items():
        assert grads[k].dtype == before[k].dtype       # cast back to its dtype
        np.testing.assert_allclose(grads[k].float().numpy(), np.asarray(w, F32),
                                   rtol=1e-2 if k == "h" else 1e-6, err_msg=k)


def test_clip_by_global_norm():
    g = torch.ones(4) * 10.0
    norm = optim.clip_by_global_norm([g], 1.0)
    assert abs(float(norm) - 20.0) < 1e-4
    assert abs(float(torch.linalg.norm(g)) - 1.0) < 1e-4


def _flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{path}.{k}" if path else k))
        return out
    return {path: tree}


# ------------------------------------------------------------------ AdamW
class _Params(torch.nn.Module):
    """A module holding ``named`` as parameters (a dot in a name becomes an
    underscore), with ``.grad`` set from ``grads``."""

    def __init__(self, named, grads, dtype):
        super().__init__()
        for name, value in named.items():
            t = torch.nn.Parameter(torch.from_numpy(np.array(value)).to(dtype))
            t.grad = torch.from_numpy(np.array(grads[name])).to(dtype)
            self.register_parameter(name.replace(".", "_"), t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_three_updates_equal_reference(dtype):
    """Three updates on the same parameters and gradients: f32 moments
    whatever the parameter's dtype, the reference's formula (bf16
    parameters within one bf16 rounding of the reference's)."""
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    params = _flat(_seeded_tree(2))
    jparams = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jstate = joptim.adamw_init(jparams)
    model = _Params(params, params, tdt)
    state = optim.adamw_init(model)
    for i, lr in enumerate((1e-3, 3e-3, 2e-3)):
        grads = _flat(_seeded_tree(10 + i))
        jgrads = {k: jnp.asarray(v, jdt) for k, v in grads.items()}
        jparams, jstate = joptim.adamw_update(jparams, jgrads, jstate, lr)
        for name, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[name.replace("_", ".")]).to(tdt)
        optim.adamw_update(model, state, lr)
    assert state["step"] == int(jstate["step"]) == 3
    for name, p in model.named_parameters():
        key = name.replace("_", ".")
        m, v = state["m"][name], state["v"][name]
        assert p.dtype == tdt and m.dtype == v.dtype == torch.float32
        np.testing.assert_allclose(m.numpy(), np.asarray(jstate["m"][key]), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(v.numpy(), np.asarray(jstate["v"][key]), rtol=1e-5,
                                   atol=1e-9)
        rtol = 1e-6 if dtype == "float32" else 2 ** -7     # one bf16 rounding
        np.testing.assert_allclose(p.detach().float().numpy(), np.asarray(jparams[key], F32),
                                   rtol=rtol, atol=1e-7)


def test_adamw_config_has_the_reference_fields():
    from repro.optim.adamw import AdamWConfig as JConfig
    from repro_torch.optim.adamw import AdamWConfig

    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(JConfig())
    assert AdamWConfig.__dataclass_params__.frozen
    with pytest.raises(dataclasses.FrozenInstanceError):
        AdamWConfig().lr = 1.0


def test_adamw_minimizes_quadratic():
    w = torch.nn.Parameter(torch.tensor([5.0, -3.0]))
    model = torch.nn.Module()
    model.w = w
    state = optim.adamw_init(model)
    target = torch.tensor([1.0, 2.0])
    for _ in range(300):
        w.grad = 2 * (w.detach() - target)
        optim.adamw_update(model, state, 0.05, weight_decay=0.0)
    np.testing.assert_allclose(w.detach().numpy(), target.numpy(), atol=1e-2)
    assert state["step"] == 300


def test_adamw_state_is_f32_for_bf16_parameters():
    cfg = get_config("smollm-360m").reduced()
    model = init_params(torch.Generator().manual_seed(0),
                        dataclasses.replace(cfg, dtype="bfloat16"), device="cpu")
    assert model.layers[0].attn.wq.w.dtype == torch.bfloat16
    state = optim.adamw_init(model)
    assert state["step"] == 0
    assert {t.dtype for t in state["m"].values()} == {torch.float32}
    assert state["m"].keys() == state["v"].keys() == dict(model.named_parameters()).keys()


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("seed,step,host,hosts", [(0, 0, 0, 1), (1, 7, 0, 1),
                                                  (3, 123, 2, 4), (9, 5, 1, 2)])
def test_dataset_batches_byte_identical(seed, step, host, hosts):
    mine = SyntheticLMDataset(vocab=300, seq_len=24, global_batch=8, seed=seed)
    ref = JDataset(vocab=300, seq_len=24, global_batch=8, seed=seed)
    np.testing.assert_array_equal(mine.tables, ref.tables)
    got, want = mine.batch(step, host, hosts), ref.batch(step, host, hosts)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()


def test_train_iterator_resumes_like_reference():
    mine = make_train_iterator(SyntheticLMDataset(100, 8, 4, seed=5), start_step=3)
    ref = jmake_train_iterator(JDataset(100, 8, 4, seed=5), start_step=3)
    try:
        for _ in range(3):
            (s1, b1), (s2, b2) = next(mine), next(ref)
            assert s1 == s2
            np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    finally:
        mine.close()
        ref.close()


def test_data_deterministic_and_step_indexed():
    ds = SyntheticLMDataset(vocab=100, seq_len=16, global_batch=8, seed=1)
    b1 = ds.batch(7)
    np.testing.assert_array_equal(b1["tokens"], ds.batch(7)["tokens"])
    assert not np.array_equal(ds.batch(8)["tokens"], b1["tokens"])
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


# ------------------------------------------------------------------ fault tolerance
@pytest.mark.parametrize("chips,model_axis,per_pod", [(512, 16, 256), (500, 16, 256),
                                                      (200, 16, 256), (1, 1, 1),
                                                      (7, 2, 8), (64, 4, 16)])
def test_plan_remesh_equals_reference(chips, model_axis, per_pod):
    got = plan_remesh(chips, model_axis, per_pod, 8)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jplan_remesh(chips, model_axis, per_pod, 8))
    assert got.dp_size * model_axis == got.chips_used
    with pytest.raises(RuntimeError):
        plan_remesh(8, model_axis=16)


def test_heartbeat_and_straggler_decisions_equal_reference():
    def script(monitor_cls, policy_cls):
        t = [0.0]
        mon = monitor_cls([0, 1, 2], timeout_s=10.0, clock=lambda: t[0])
        out = []
        for now, beats in ((5.0, (0, 1)), (12.0, (0,)), (25.0, (0, 1, 2))):
            t[0] = now
            for h in beats:
                mon.beat(h)
            out.append((mon.check(), mon.healthy, mon.failed))
        mon.rejoin(2)
        out.append(mon.healthy)
        pol = policy_cls(factor=1.5, patience=3, clock=lambda: 0.0)
        for d in [1.0] * 3 + [2.5] * 6 + [10.0] * 6:
            v = pol.record_step({0: 1.0, 1: 1.0, 2: 1.0, 3: d})
            out.append((v.rebalance, v.evict))
        out.append(pol.host_share([0, 1, 2, 3], [3]))
        return out

    assert script(HeartbeatMonitor, StragglerPolicy) == script(JHeartbeat, JStraggler)


# ------------------------------------------------------------------ checkpoint
def test_checkpoint_roundtrip_and_layout(tmp_path):
    tree = {"params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "opt": {"m": np.ones(3), "step": torch.tensor(5, dtype=torch.int32)},
            "pair": (torch.zeros(2), [np.arange(2)])}
    save_checkpoint(str(tmp_path), 5, tree, meta={"loss": 1.5})
    step_dir = tmp_path / "step_00000005"
    assert sorted(os.listdir(step_dir)) == ["COMMITTED", "host_0.npz", "meta.json"]
    assert sorted(np.load(step_dir / "host_0.npz").files) == [
        "opt/m", "opt/step", "pair/0", "pair/1/0", "params/w"]
    zero = {"params": {"w": torch.zeros(2, 3)},
            "opt": {"m": np.zeros(3), "step": torch.tensor(0, dtype=torch.int32)},
            "pair": (torch.ones(2), [np.zeros(2, np.int64)])}
    restored, step = restore_checkpoint(str(tmp_path), zero)
    assert step == 5 and latest_step(str(tmp_path)) == 5
    torch.testing.assert_close(restored["params"]["w"], tree["params"]["w"])
    assert isinstance(restored["opt"]["m"], np.ndarray)
    assert int(restored["opt"]["step"]) == 5 and isinstance(restored["pair"], tuple)


def test_save_checkpoint_in_the_reference_argument_order(tmp_path):
    """``save_checkpoint(d, 1, tree, 0, 1, {"loss": 1.0})``, positional in the
    reference's order (host_id, num_hosts, meta), writes the same step
    directory in both packages: the same files, ``meta.json`` and arrays."""
    tree = _seeded_tree(7)
    save_checkpoint(str(tmp_path / "port"), 1, jax.tree.map(torch.from_numpy, tree),
                    0, 1, {"loss": 1.0})
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1, jax.tree.map(jnp.asarray, tree),
                          0, 1, {"loss": 1.0})
    port, ref = (tmp_path / side / "step_00000001" for side in ("port", "ref"))
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref)) == [
        "COMMITTED", "host_0.npz", "meta.json"]
    for name in ("COMMITTED", "meta.json"):
        assert (port / name).read_text() == (ref / name).read_text()
    got, want = np.load(port / "host_0.npz"), np.load(ref / "host_0.npz")
    assert sorted(got.files) == sorted(want.files)
    for key in want.files:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_checkpoint_manager_passes_meta_by_keyword(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(4, {"w": torch.full((3,), 4.0)}, meta={"loss": 2.5})
    mgr.wait()
    with open(tmp_path / "step_00000004" / "meta.json") as f:
        assert json.load(f) == {"step": 4, "loss": 2.5}
    restored, step = mgr.restore({"w": torch.zeros(3)})
    assert step == 4 and restored["w"].tolist() == [4.0] * 3


def test_checkpoint_ignores_uncommitted(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"w": torch.ones(2)})
    os.makedirs(str(tmp_path / "step_00000009"))  # crashed partial write
    _, step = restore_checkpoint(str(tmp_path), {"w": torch.zeros(2)})
    assert step == 1
    assert restore_checkpoint(str(tmp_path / "none"), {"w": 0}) == ({"w": 0}, None)


def test_checkpoint_manager_async_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    w = torch.zeros(3)
    for s in (10, 20, 30):
        w.fill_(s)
        mgr.save_async(s, {"w": w.clone()})
    mgr.wait()
    assert mgr.latest_step() == 30
    restored, step = mgr.restore({"w": torch.zeros(3)})
    assert step == 30 and float(restored["w"][0]) == 30
    assert len([n for n in os.listdir(tmp_path) if n.startswith("step_")]) == 2


def test_checkpoint_errors_reach_the_caller(tmp_path):
    """A save that fails on its thread raises from the next wait; a
    restore into an example of another shape raises."""
    mgr = CheckpointManager(str(tmp_path))
    (tmp_path / "step_00000001.tmp0").write_text("in the way")
    mgr.save_async(1, {"w": torch.ones(2)})
    with pytest.raises(FileExistsError):
        mgr.wait()
    mgr.wait()                                          # raised once
    mgr.save_async(2, {"w": torch.ones(2)})
    mgr.wait()
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(3)})


def test_bf16_leaves_are_raw_bits_like_the_reference(tmp_path):
    """The port writes a bf16 leaf as the reference writes one (a 2-byte
    void of raw bits) and reads it back bit for bit; the reference's own
    restore raises on it (``No cast function``, ROADMAP Queue 3)."""
    vals = torch.randn(4, 5, generator=torch.Generator().manual_seed(0))
    tree = {"w": vals.to(torch.bfloat16)}
    save_checkpoint(str(tmp_path / "port"), 1, tree)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 1,
                          {"w": jnp.asarray(vals.numpy()).astype(jnp.bfloat16)})
    headers = []
    for side in ("port", "ref"):
        with zipfile.ZipFile(tmp_path / side / "step_00000001" / "host_0.npz") as zf:
            headers.append(re.search(rb"'descr': '(.)V2'", zf.read("w.npy")[:128]))
            assert headers[-1], side
        assert np.load(tmp_path / side / "step_00000001" / "host_0.npz")["w"].dtype == "V2"
        got, _ = restore_checkpoint(str(tmp_path / side), {"w": torch.zeros(4, 5,
                                                                 dtype=torch.bfloat16)})
        np.testing.assert_array_equal(_bits(got["w"]), _bits(tree["w"]))
    with pytest.raises(ValueError, match="cast"):
        jckpt.restore_checkpoint(str(tmp_path / "port"),
                                 {"w": jnp.zeros((4, 5), jnp.bfloat16)})


def test_bf16_tree_saved_by_reference_restores_bit_for_bit(tmp_path):
    cfg_j = jget_config("smollm-360m").reduced()
    params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                          _jax_params(cfg_j))
    jckpt.save_checkpoint(str(tmp_path), 4, {"params": params})
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), dtype="bfloat16")
    model = init_params(torch.Generator().manual_seed(1), cfg, device="cpu")
    model.to(torch.bfloat16)                    # every leaf bf16, as saved
    example = {"params": tree_from_named(dict(model.named_parameters()), "meta")}
    restored, step = restore_checkpoint(str(tmp_path), example)
    assert step == 4
    got = named_from_tree(restored["params"])
    want = named_from_tree(params)
    assert got.keys() == want.keys() == dict(model.named_parameters()).keys()
    for name, t in got.items():
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(t), _bits(want[name]), err_msg=name)


def _reference_state(cfg_j, steps):
    """The reference's (params, opt) after ``steps`` jitted train steps."""
    flags = JFlags(use_pallas=False, remat=True, mesh=None, ssm_chunk=64)
    jstep = jax.jit(jmake_train_step(cfg_j, flags, lr=3e-3, warmup=2, total=10))
    params = jax.tree.map(jnp.asarray, _jax_params(cfg_j))
    opt = joptim.adamw_init(params)
    ds = JDataset(cfg_j.vocab, 32, 2)
    for s in range(steps):
        params, opt, _ = jstep(params, opt, ds.batch(s))
    return params, opt, jstep, ds


def test_reference_checkpoint_restores_and_continues_in_the_port(tmp_path):
    """A checkpoint the JAX package wrote (f32 smollm params and AdamW
    state after two steps) restores in the port, whose next step equals the
    reference's next step."""
    cfg_j, cfg = jget_config("smollm-360m").reduced(), get_config("smollm-360m").reduced()
    params, opt, jstep, ds = _reference_state(cfg_j, 2)
    jckpt.save_checkpoint(str(tmp_path), 2, {"params": params, "opt": opt})
    model = init_params(torch.Generator().manual_seed(7), cfg, device="cpu")
    state = optim.adamw_init(model)
    restored, step = restore_checkpoint(str(tmp_path), train_state_tree(model, state,
                                                                        "meta"))
    assert step == 2
    load_train_state(model, state, restored)
    assert state["step"] == 2
    for name, t in named_from_tree(jax.tree.map(np.asarray, params)).items():
        np.testing.assert_array_equal(
            dict(model.named_parameters())[name].detach().numpy(), t)

    _, jopt, jmet = jstep(params, opt, ds.batch(2))
    batch = {k: torch.from_numpy(v).long() for k, v in ds.batch(2).items()}
    met = steps.make_train_step(cfg, RuntimeFlags(), lr=3e-3, warmup=2, total=10)(
        model, state, batch)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=1e-5,
                                   err_msg=key)
    for key in ("m", "v"):
        for name, t in named_from_tree(jax.tree.map(np.asarray, jopt[key])).items():
            got = state[key][name].numpy()
            assert np.linalg.norm(got - t) <= 1e-4 * np.linalg.norm(t), (key, name)


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg_j, cfg = jget_config("smollm-360m").reduced(), get_config("smollm-360m").reduced()
    model = params_from_jax(_jax_params(cfg_j), cfg, device="cpu")
    state = optim.adamw_init(model)
    flags = RuntimeFlags()
    step = steps.make_train_step(cfg, flags, lr=3e-3, warmup=2, total=10)
    ds = SyntheticLMDataset(cfg.vocab, 32, 2)
    for s in range(2):
        step(model, state, {k: torch.from_numpy(v).long() for k, v in ds.batch(s).items()})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(2, train_state_tree(model, state), meta={"loss": 1.0})
    mgr.wait()
    jparams, jopt, _, _ = _reference_state(cfg_j, 0)
    restored, rstep = jckpt.restore_checkpoint(str(tmp_path),
                                               {"params": jparams, "opt": jopt})
    assert rstep == 2 and int(restored["opt"]["step"]) == 2
    want = train_state_tree(model, state)
    for section in ("params",):
        for name, t in named_from_tree(restored[section]).items():
            np.testing.assert_array_equal(t, named_from_tree(want[section])[name].numpy())
    for key in ("m", "v"):
        for name, t in named_from_tree(restored["opt"][key]).items():
            np.testing.assert_array_equal(t, state[key][name].numpy())


def test_tree_from_named_inverts_named_from_tree():
    for arch in ("llama-3.2-vision-11b", "zamba2-2.7b", "whisper-base"):
        cfg = get_config(arch).reduced()
        model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
        named = dict(model.named_parameters())
        tree = tree_from_named(named)
        back = named_from_tree(tree)
        assert back.keys() == named.keys()
        for name, t in named.items():
            assert torch.equal(back[name], t)
        tree["emb"]["emb"].zero_()                      # a copy, not a view
        assert model.emb.emb.abs().sum() > 0


# ------------------------------------------------------------------ the trainer
ARGS = ["--arch", "smollm-360m", "--reduced", "--steps", "6", "--batch", "2",
        "--seq", "32", "--ckpt-every", "3", "--log-every", "100", "--device", "cpu"]


def test_train_restart_resumes(tmp_path):
    """End-to-end restart: train, 'crash', restart, verify continuation."""
    args = ARGS + ["--ckpt-dir", str(tmp_path)]
    r1 = train.main(args)
    assert r1["steps"] == 6 and np.isfinite(r1["last_loss"])
    assert latest_step(str(tmp_path)) == 6
    r2 = train.main(args[:4] + ["12"] + args[5:])  # resumes from step 6
    assert r2["steps"] == 12 - 6


def test_train_injected_failure_rolls_back(tmp_path, capsys):
    r = train.main(ARGS + ["--ckpt-dir", str(tmp_path), "--inject-failure", "4"])
    out = capsys.readouterr().out
    assert "[FT] injected failure at step 4" in out and "rolled back to step 3" in out
    assert "re-mesh plan: ElasticPlan(mesh_shape=(1, 1)" in out
    assert r["steps"] == 5 + 3    # steps 0-4, then 3-5 again


def test_train_refuses_a_mesh():
    """A mesh that the ranks cannot fill is refused, as ``jax.make_mesh``
    refuses a device count that does not fit: this process is a world of
    one, and the production mesh needs 256 ranks."""
    for extra, msg in ((["--production-mesh"], "needs 256 ranks"),
                       (["--model-axis", "2"], "does not divide 1 rank")):
        with pytest.raises(ValueError, match=msg):
            train.main(ARGS + extra)


def test_launchers_own_the_process_group():
    """A world of one trains and serves plain tensors and starts no process
    group; a refused mesh leaves none behind; a caller's (1, 1) mesh, passed
    in, is used, left to the caller, and trains the plain run's losses;
    after it ends, the next run is plain again."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import serve
    from repro_torch.launch.mesh import launch_mesh, make_local_mesh

    assert not dist.is_initialized()
    plain = train.main(ARGS)
    assert not dist.is_initialized()
    with launch_mesh(device="cpu") as mesh:
        assert mesh is None
    with pytest.raises(ValueError, match="does not divide 1 rank"):
        train.main(ARGS + ["--model-axis", "2"])
    assert not dist.is_initialized()
    served = serve.main(["--reduced", "--device", "cpu", "--requests", "2",
                         "--prefill-len", "8", "--decode-steps", "2"])
    assert served["mesh"] is None and not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    try:
        with launch_mesh(device="cpu") as m:      # still a world of one
            assert m is None
        assert dist.is_initialized()              # the caller's group stays
        tr = train.setup(train.parse_args(ARGS), mesh=mesh)
        assert all(isinstance(p, DTensor) for p in tr.model.parameters())
        on_mesh = train.main(ARGS, mesh=mesh)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(on_mesh["losses"], plain["losses"], rtol=1e-6)
    again = train.main(ARGS)
    assert again["losses"] == plain["losses"] and not dist.is_initialized()


def test_prefill_and_decode_steps_equal_the_entry_points():
    cfg = get_config("whisper-base").reduced()
    model = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    specs = steps.extra_specs(cfg, 2)
    assert {k: (tuple(v.shape), v.device.type) for k, v in specs.items()} == {
        "frames": ((2, cfg.enc_frames, cfg.d_model), "meta")}
    assert steps.extra_specs(get_config("smollm-360m"), 2) == {}
    frames = torch.randn(2, cfg.enc_frames, cfg.d_model,
                         generator=torch.Generator().manual_seed(1))
    tokens = torch.randint(0, cfg.vocab, (2, 8), generator=torch.Generator().manual_seed(2))
    flags = RuntimeFlags()
    logits, cache = steps.make_prefill_step(cfg, flags, pad_to=12)(
        model, {"tokens": tokens, "frames": frames})
    want, _ = prefill(model, tokens, cfg, flags, {"frames": frames}, pad_to=12)
    torch.testing.assert_close(logits, want, rtol=0, atol=0)
    out, cache = steps.make_decode_step(cfg, flags)(model, tokens[:, :1], cache)
    assert out.shape == (2, 1, cfg.vocab) and cache["pos"] == 9
