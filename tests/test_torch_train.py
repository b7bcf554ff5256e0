"""The port's training path against the JAX package's, on the CPU.

Reduced configs (f32) of the six families, smollm-360m (dense),
granite-moe-1b-a400m (moe), rwkv6-1.6b (ssm), zamba2-2.7b (hybrid),
whisper-base (encdec) and llama-3.2-vision-11b (vlm), with the reference's
parameters (``init_params(PRNGKey(0))`` plus seeded noise on its constant
leaves, `test_torch_families._jax_params`) carried across with
`params_from_jax`.  The reference runs its plain paths with per-layer
remat, as its trainer does, and ``ssm_chunk=64`` (the port's scan tile;
the reference's chunk 512 overflows at the decay clamp, ROADMAP Queue 3):
``RuntimeFlags(use_pallas=False, remat=True, mesh=None, ssm_chunk=64)``.

  * `train_forward`: the loss within 1e-5 (relative), the metrics, and
    every gradient leaf within 1e-4 relative L2 of ``jax.value_and_grad``;
  * three steps of `make_train_step` against the reference's jitted step,
    each from the reference's state: loss, grad norm and learning rate,
    then every leaf of the parameters, ``m`` and ``v``, compared per leaf
    in relative L2, not elementwise.  At step 1 AdamW's update is ``lr *
    g / |g|`` entry by entry (and so on a later step for an entry that
    sees its first gradient), so a gradient entry near zero whose sign
    differs by rounding moves by ``2 * lr`` in one package and not the
    other.  An elementwise comparison would flag that rounding; so would a
    per-leaf norm on a leaf as small as a reduced embedding (one such
    entry moved rwkv6's by 1.7e-3 relative L2), so the norm leaves out the
    entries whose moments the packages do not resolve (near zero, 10%
    apart) and holds them to ``2 * lr``;
  * remat on and off give the same gradients;
  * bf16 compute over f32 master weights (the reference's bf16 configs)
    matches the reference's loss and grad norm within bf16 rounding;
  * 30 steps of the trainer follow the reference's trajectory.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import RuntimeFlags as JFlags
from repro.models import train_forward as jtrain_forward
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models import RuntimeFlags, params_from_jax, train_forward
from repro_torch.models.convert import load_train_state, tree_from_named
from repro_torch.optim import adamw_init

from test_torch_families import _jax_params

ARCHS = ("smollm-360m", "granite-moe-1b-a400m", "rwkv6-1.6b", "zamba2-2.7b",
         "whisper-base", "llama-3.2-vision-11b")
B, S = 2, 40
JFLAGS = JFlags(use_pallas=False, remat=True, mesh=None, ssm_chunk=64)
FLAGS = RuntimeFlags(use_kernels=False, remat=True)
LR, WARMUP, TOTAL = 3e-3, 2, 10    # warmup ends inside the three steps


def _cfgs(arch, dtype="float32"):
    cut = lambda c: dataclasses.replace(c.reduced(), dtype=dtype)
    return cut(jget_config(arch)), cut(get_config(arch))


def _batch(cfg, seed=0):
    """Seeded tokens, labels and normal frontend inputs (numpy)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def _torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def _leaves(tree, path=""):
    """{"a/b/c": float32 numpy} of a nested dict of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for key, child in tree.items():
            out.update(_leaves(child, f"{path}/{key}" if path else key))
        return out
    if isinstance(tree, torch.Tensor):
        return {path: tree.detach().float().numpy()}
    return {path: np.asarray(tree, np.float32)}


def _rel_l2(got, want):
    den = float(np.linalg.norm(want))
    return float(np.linalg.norm(got - want)) / den if den else float(np.linalg.norm(got))


def _assert_trees(got, want, tol, what):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys()))
    bad = {k: _rel_l2(got[k], want[k]) for k in want}
    bad = {k: e for k, e in bad.items() if not e <= tol}
    assert not bad, f"{what}: leaves over {tol} relative L2: {bad}"


def _port_grads(model, cfg, batch, flags=FLAGS):
    model.requires_grad_(True)
    model.zero_grad(set_to_none=True)
    tb = _torch_batch(batch)
    extra = {k: v for k, v in tb.items() if k not in ("tokens", "labels")}
    loss, metrics = train_forward(model, tb["tokens"], tb["labels"], cfg, flags, extra)
    loss.backward()
    grads = tree_from_named({n: p.grad for n, p in model.named_parameters()})
    return loss.item(), metrics, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_loss_and_gradients_match_reference(arch):
    cfg_j, cfg = _cfgs(arch)
    params = _jax_params(cfg_j)
    batch = _batch(cfg)
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    (jloss, jmet), jgrads = jax.value_and_grad(
        lambda p: jtrain_forward(p, batch["tokens"], batch["labels"], cfg_j, JFLAGS,
                                 extra), has_aux=True)(params)

    model = params_from_jax(params, cfg, device="cpu")
    loss, metrics, grads = _port_grads(model, cfg, batch)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    for key in ("nll", "aux", "ppl"):
        np.testing.assert_allclose(float(metrics[key]), float(jmet[key]), rtol=1e-5,
                                   atol=1e-7, err_msg=key)
    if cfg.family == "moe":
        assert float(metrics["aux"]) > 0
    _assert_trees(grads, jgrads, 1e-4, f"{arch} gradients")


def _assert_params_after_adamw(got, want, m_got, m_want, lr, tol, what):
    """Parameters per leaf within ``tol`` relative L2, leaving out the
    entries whose gradient the two packages do not resolve: their new
    moments m differ by more than 10%.  There AdamW's ``m / sqrt(v)`` is
    rounding over rounding and may take either sign, so those entries must
    have near-zero moments (at most 1e-4 of the leaf's largest) and are
    held to what two AdamW updates can differ by, elementwise:
    ``|m_hat / sqrt(v_hat)| <= 1.001`` over the first three steps
    (Cauchy-Schwarz on the moments' b1, b2 weights), so ``2.01 * lr``."""
    got, want = _leaves(got), _leaves(want)
    m_got, m_want = _leaves(m_got), _leaves(m_want)
    assert got.keys() == want.keys(), (what, sorted(got.keys() ^ want.keys()))
    bad = {}
    for k in want:
        mw = m_want[k]
        loose = np.abs(m_got[k] - mw) > 0.1 * np.abs(mw)
        if not np.all(np.abs(mw[loose]) <= 1e-4 * np.abs(mw).max()):
            bad[k] = "an unresolved moment that is not near zero"
        elif not _rel_l2(got[k][~loose], want[k][~loose]) <= tol:
            bad[k] = _rel_l2(got[k][~loose], want[k][~loose])
        elif not np.all(np.abs(got[k][loose] - want[k][loose]) <= 2.01 * lr):
            bad[k] = "an unresolved entry's update past 2 lr"
    assert not bad, f"{what}: {bad}"


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch):
    """Three steps (the schedule through its warmup, AdamW's bias
    corrections at steps 1-3), each from the reference's state: before a
    step the port loads the reference's parameters, m, v and step counter
    (`load_train_state`), so each step is compared alone, not the two
    trajectories, which drift apart by AdamW's sign noise."""
    cfg_j, cfg = _cfgs(arch)
    params = _jax_params(cfg_j, seed=1)
    jstep = jax.jit(jmake_train_step(cfg_j, JFLAGS, lr=LR, warmup=WARMUP, total=TOTAL))
    step = make_train_step(cfg, FLAGS, lr=LR, warmup=WARMUP, total=TOTAL)
    model = params_from_jax(params, cfg, device="cpu")
    opt = adamw_init(model)
    jparams, jopt = jax.tree.map(jnp.asarray, params), jadamw_init(params)
    for i in range(3):
        load_train_state(model, opt, jax.tree.map(np.asarray, {"params": jparams,
                                                               "opt": jopt}))
        batch = _batch(cfg, seed=10 + i)
        jparams, jopt, jmet = jstep(jparams, jopt, batch)
        met = step(model, opt, _torch_batch(batch))
        what = f"{arch} step {i + 1}"
        for key, rtol in (("loss", 1e-5), ("grad_norm", 1e-5), ("lr", 1e-6)):
            np.testing.assert_allclose(float(met[key]), float(jmet[key]), rtol=rtol,
                                       err_msg=f"{what} {key}")
        assert opt["step"] == int(jopt["step"]) == i + 1
        assert all(m.dtype == torch.float32 for m in opt["m"].values())
        _assert_trees(tree_from_named(opt["m"]), jopt["m"], 1e-4, f"{what} m")
        _assert_trees(tree_from_named(opt["v"]), jopt["v"], 1e-4, f"{what} v")
        _assert_params_after_adamw(tree_from_named(dict(model.named_parameters())),
                                   jparams, tree_from_named(opt["m"]), jopt["m"],
                                   met["lr"], 1e-5, f"{what} parameters")


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m", "zamba2-2.7b",
                                  "llama-3.2-vision-11b"])
def test_remat_does_not_change_gradients(arch):
    cfg_j, cfg = _cfgs(arch)
    params = _jax_params(cfg_j)
    batch = _batch(cfg)
    runs = []
    for remat in (False, True):
        model = params_from_jax(params, cfg, device="cpu")
        runs.append(_port_grads(model, cfg, batch, RuntimeFlags(remat=remat)))
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
    _assert_trees(runs[1][2], runs[0][2], 1e-6, f"{arch} remat on vs off")


@pytest.mark.parametrize("arch", ["smollm-360m", "rwkv6-1.6b"])
def test_bf16_compute_over_f32_master_weights(arch):
    """The reference's bf16 configs keep f32 parameters and compute in bf16;
    the port trains the same way (``param_dtype=torch.float32``).  The
    loss and grad norm agree within bf16 rounding (XLA fuses elementwise
    chains in f32 where eager PyTorch rounds each op to bf16)."""
    cfg_j, cfg = _cfgs(arch, "bfloat16")
    params = _jax_params(cfg_j)
    batch = _batch(cfg)
    jstep = jax.jit(jmake_train_step(cfg_j, JFLAGS, lr=LR, warmup=WARMUP, total=TOTAL))
    _, _, jmet = jstep(jax.tree.map(jnp.asarray, params), jadamw_init(params), batch)
    model = params_from_jax(params, cfg, device="cpu")
    model.float()                            # f32 master weights
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    met = make_train_step(cfg, FLAGS, lr=LR, warmup=WARMUP, total=TOTAL)(
        model, adamw_init(model), _torch_batch(batch))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]), rtol=1e-2)
    np.testing.assert_allclose(float(met["grad_norm"]), float(jmet["grad_norm"]),
                               rtol=5e-2)


@pytest.mark.parametrize("dtype,loss_rtol,gnorm_rtol", [("float32", 1e-5, 1e-4),
                                                        ("bfloat16", 1e-3, 5e-2)])
def test_thirty_steps_follow_the_reference(dtype, loss_rtol, gnorm_rtol):
    """30 steps of `launch/train.py`'s trainer (`train.setup`) and of the
    reference's jitted step on the trainer's data, each package on its own
    trajectory from the same weights (`scripts/train_curves.py`, reduced
    smollm-360m): the loss at every step within ``loss_rtol`` relative and
    the grad norm within ``gnorm_rtol``.  In f32 the issue's 1e-5 on the
    loss; in bf16 an eighth of bf16's epsilon on the loss and, on the grad
    norm, the single bf16 step's 5e-2 (`test_bf16_compute_over_f32_master_
    weights`; XLA fuses elementwise chains in f32 where eager PyTorch
    rounds each op to bf16)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "scripts"))
    from train_curves import curves

    out = curves(["--reduced", "--dtype", dtype, "--steps", "30", "--batch", "4",
                  "--seq", "64"])
    assert len(out["port"]["loss"]) == len(out["reference"]["loss"]) == 30
    for key, tol in (("loss", loss_rtol), ("grad_norm", gnorm_rtol)):
        np.testing.assert_allclose(out["port"][key], out["reference"][key], rtol=tol,
                                   err_msg=key)
