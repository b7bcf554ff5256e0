"""The port's user entry points outside `src/` against the JAX package's, on
the CPU: the lint CLI (`scripts/torch_lint_program.py`), the SSM example's
three granularities (`examples/torch_ssm_as_sptrsv.py`), the training and
serving examples (`examples/torch_{train_lm,serve_batch}.py`) and the
quickstart's blocked solve and dataflow comparison
(`examples/torch_quickstart.py` steps 6-7).

Inputs are made from a seed with numpy and handed to both packages; the
port runs on ``device="cpu"``, where its kernel wrappers take their plain
twins.  Each test states its tolerance.
"""

import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from repro.core import api as japi
from repro.core import robust as jrobust
from repro.core.csr import from_coo as jfrom_coo
from repro.core.csr import serial_solve as jserial_solve
from repro.kernels.ssd_scan import ops as jops
from repro.kernels.ssd_scan.ref import scan_ref as jscan_ref
from repro_torch.core import api
from repro_torch.core.csr import serial_solve

REPO = Path(__file__).resolve().parent.parent


def _load(relpath):
    """A script or example of the repository, imported from its path."""
    path = REPO / relpath
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jlint, tlint = _load("scripts/lint_program.py"), _load("scripts/torch_lint_program.py")
ssm = _load("examples/torch_ssm_as_sptrsv.py")


# ------------------------------------------------------------------ lint CLI
# The one difference on purpose (ROADMAP Queue 3, PR 15): SPT205's message
# and SPT114's hint name the port's memories where the reference says VMEM.
# The port's phrases are mapped back before the byte-for-byte comparison.
PORT_WORDING = {
    "vector resident (in shared memory where it fits, else in device memory)":
        "vector VMEM-resident",
    "misplace the shared-memory window": "misplace the VMEM window",
}


def _run_cli(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _as_reference(out):
    assert "VMEM" not in out
    for port, ref in PORT_WORDING.items():
        out = out.replace(port, ref)
    return out


@pytest.fixture(scope="module")
def program_files(tmp_path_factory):
    """Program files saved by the JAX package: a clean ckt_add20 program
    and one whose psum slots are corrupted (error diagnostics, exit 1)."""
    d = tmp_path_factory.mktemp("progs")
    prog = japi.compile(japi.matrix("ckt_add20"))
    bad = jrobust.FaultInjector(0).corrupt_slots(prog, 2)
    japi.save_program(prog, d / "clean.prog")
    japi.save_program(bad, d / "corrupt.prog")
    return d


LINT_CASES = {
    "hub_small": ["--matrix", "hub_small"],
    "rajat04_frontier": ["--matrix", "ckt_rajat04", "--schedule", "paper", "--frontier"],
    "hub_mid_verify_ir": ["--matrix", "hub_mid", "--verify-ir"],
    "program_files": ["{d}/clean.prog", "{d}/corrupt.prog"],
    "suite": ["--suite", "--max-n", "700"],
}


@pytest.mark.parametrize("fmt", ["text", "json"])
@pytest.mark.parametrize("case", list(LINT_CASES))
def test_lint_cli_equals_reference(case, fmt, program_files, capsys):
    """stdout and exit code of the two CLIs equal, byte for byte after the
    port's memory names are mapped back (no report holds a wall-clock
    field, so nothing else is left out)."""
    argv = [a.format(d=program_files) for a in LINT_CASES[case]]
    argv += ["--json"] if fmt == "json" else []
    want_rc, want = _run_cli(jlint.main, argv, capsys)
    got_rc, got = _run_cli(tlint.main, argv, capsys)
    assert got_rc == want_rc
    assert _as_reference(got) == want
    if fmt == "json":
        assert [r["ok"] for r in json.loads(got)] == [r["ok"] for r in json.loads(want)]
    assert want_rc == (1 if case == "program_files" else 0)
    if case == "rajat04_frontier":
        assert "SPT208" in got


def test_lint_cli_without_input_is_a_usage_error(capsys):
    for main in (jlint.main, tlint.main):
        with pytest.raises(SystemExit) as exc:
            main([])
        assert exc.value.code == 2
        assert "nothing to lint" in capsys.readouterr().err


# ------------------------------------------------------------------ the SSM example
SMALL = (2, 256, 2, 8, 8)            # B, L, H, K, V
SSM_REL = 1e-4                       # of the largest |y|


def _small_inputs():
    """The example's inputs at SMALL, drawn as it draws them, as numpy and
    as port tensors on the CPU."""
    q, k, v, w = ssm.recurrence_inputs(np.random.default_rng(7), SMALL, "cpu")
    return [t.numpy() for t in (q, k, v, w)], (q, k, v, w)


def _jmerge(x):
    b, seq, h, d = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b * h, seq, d)


def _junmerge(y, b):
    bh, seq, v = y.shape
    return y.reshape(b, bh // b, seq, v).transpose(0, 2, 1, 3)


def _reference_fine(q, k, v, w):
    """The reference example's fine granularity, rebuilt:
    `jax.lax.associative_scan` over (decay, state) pairs."""
    b = q.shape[0]
    km, vm, wm = _jmerge(k), _jmerge(v), _jmerge(w)
    kv = jnp.einsum("blk,blv->blkv", km, vm)
    d = jnp.exp(wm)[..., None]

    def combine(x, y):
        dx, sx = x
        dy, sy = y
        return dx * dy, sy + dy * sx

    _, s = jax.lax.associative_scan(combine, (d, kv), axis=1)
    return _junmerge(jnp.einsum("blk,blkv->blv", _jmerge(q), s), b)


def _within(got, want, what):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert err <= SSM_REL * scale, (what, err, scale)


def _reference_granularity(name, arrs):
    """The reference's coarse (`scan_ref`), medium (`linear_recurrence`,
    chunk 64, plain jnp and Pallas in interpret mode) or fine outputs."""
    q, k, v, w = (jnp.asarray(a) for a in arrs)
    b, _, h, kdim = q.shape
    if name == "coarse":
        s0 = jnp.zeros((b * h, kdim, v.shape[3]))
        return [_junmerge(jscan_ref(_jmerge(q), _jmerge(k), _jmerge(v), _jmerge(w), s0)[0], b)]
    if name == "medium":
        return [jops.linear_recurrence(q, k, v, w, chunk=64)[0],
                jops.linear_recurrence(q, k, v, w, chunk=64, use_pallas=True,
                                       interpret=True)[0]]
    return [_reference_fine(q, k, v, w)]


@pytest.mark.parametrize("name", ["coarse", "medium", "fine"])
def test_ssm_granularities_equal_reference(name):
    """Each granularity of the port's example against the reference's
    within 1e-4 of the largest |y|; all three also agree with each other."""
    arrs, tensors = _small_inputs()
    got = dict(ssm.GRANULARITIES)[name](*tensors)
    assert got.shape == (SMALL[0], SMALL[1], SMALL[2], SMALL[4])
    for want in _reference_granularity(name, arrs):
        _within(got.numpy(), np.asarray(want), name)
    _within(got.numpy(), ssm.coarse(*tensors).numpy(), f"{name} vs the port's coarse")


@pytest.mark.parametrize("n", [1, 2, 3, 7, 13])
def test_fine_scan_any_length(n):
    """The odd/even recursion at lengths that are not powers of two."""
    arrs, tensors = (lambda t: ([x.numpy() for x in t], t))(
        ssm.recurrence_inputs(np.random.default_rng(n), (1, n, 2, 4, 3), "cpu"))
    want = _reference_fine(*(jnp.asarray(a) for a in arrs))
    _within(ssm.fine(*tensors).numpy(), np.asarray(want), f"fine, L={n}")


def test_ssm_bidiagonal_equivalence_equals_reference():
    """The example's bidiagonal system: the port's serial solve equals the
    reference's bit for bit, its batched solve (one stream pass, f32) is
    within 1e-5 of the reference's serial solve, and the checks hold."""
    rng = np.random.default_rng(0)
    mat, a, u = ssm.bidiagonal(ssm.N, rng)
    U = rng.standard_normal((ssm.N, ssm.N_RHS))
    jmat = jfrom_coo(ssm.N, range(1, ssm.N), range(0, ssm.N - 1), -a, np.ones(ssm.N), "ssm")
    np.testing.assert_array_equal(serial_solve(mat, u), jserial_solve(jmat, u))
    eq = ssm.equivalence(mat, a, u, U, device="cpu")
    assert eq["sptrsv_eq_scan"] and eq["batched_eq_scans"]
    want = np.stack([jserial_solve(jmat, U[:, i]) for i in range(ssm.N_RHS)], axis=1)
    np.testing.assert_array_equal(eq["H_ref"], want)
    got = api.solve_batch(eq["prog"], U, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_ssm_example_main_on_the_cpu(monkeypatch):
    monkeypatch.setattr(ssm, "SIZES", SMALL)
    out = ssm.main(["--device", "cpu"])
    assert all(out["checks"].values()), out["checks"]
    assert set(out["ms"]) == {"coarse", "medium", "fine"} and out["device"] == "cpu"


# ------------------------------------------------------------------ training
def _auto_axes_mesh(model_axis: int = 1):
    """The reference trainer's (1, 1) local mesh, on one device as the
    port's world of one, with Auto axes: under this jax `jax.make_mesh`
    defaults to Explicit axes, which the reference's
    `with_sharding_constraint` refuses (ROADMAP Queue 3), and a worker may
    hold 8 fake CPU devices (`test_sharded.py` sets XLA_FLAGS on import)."""
    assert model_axis == 1
    return jax.make_mesh((1, 1), ("data", "model"), devices=jax.devices()[:1],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def test_tiny_training_example_equals_reference(tmp_path, monkeypatch, capsys):
    """`torch_train_lm --tiny --device cpu` (30 steps of reduced smollm-360m)
    and the reference's `train_lm --tiny`, each with its own checkpoint
    directory seeded with the reference trainer's step-0 state (its
    PRNGKey(0) weights, fresh AdamW), so both start from the same weights:
    the first and last loss within 1e-5 relative (f32, as
    tests/test_torch_train.py holds training), the same step count, and the
    example's own assertion (the loss decreased) holds in both."""
    from repro import checkpoint as jckpt
    from repro import optim as joptim
    from repro.configs import get_config as jget_config
    from repro.launch import train as jtrain
    from repro.models import init_params as jinit_params

    params = jinit_params(jax.random.PRNGKey(0), jget_config("smollm-360m").reduced())
    state = {"params": params, "opt": joptim.adamw_init(params)}
    port_dir, ref_dir = tmp_path / "port", tmp_path / "reference"
    for d in (port_dir, ref_dir):
        jckpt.save_checkpoint(str(d), 0, state)

    got = _load("examples/torch_train_lm.py").main(
        ["--tiny", "--device", "cpu", "--ckpt-dir", str(port_dir)])

    ref_example = _load("examples/train_lm.py")
    results = []
    monkeypatch.setattr(jtrain, "make_local_mesh", _auto_axes_mesh)
    monkeypatch.setattr(ref_example, "train_main",
                        lambda argv: results.append(jtrain.main(argv)) or results[-1])
    monkeypatch.setattr(sys, "argv", ["train_lm.py", "--tiny", "--ckpt-dir", str(ref_dir)])
    ref_example.main()
    (want,) = results
    assert "restored checkpoint at step 0" in capsys.readouterr().out
    assert got["steps"] == want["steps"] == 30
    for key in ("first_loss", "last_loss"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)


def test_training_examples_build_the_same_argv_with_their_own_ckpt_dir(monkeypatch):
    """Both examples hand their trainer the same flags, tiny and full, except
    the default checkpoint directory, which must differ: the port restores
    the reference's checkpoints and would resume its run."""
    port, ref = _load("examples/torch_train_lm.py"), _load("examples/train_lm.py")
    seen = {}
    for name, mod in (("port", port), ("reference", ref)):
        monkeypatch.setattr(mod, "train_main", lambda argv, name=name: seen.setdefault(
            name, []).append(argv) or {"first_loss": 1.0, "last_loss": 0.0})
    for extra in ([], ["--tiny"]):
        port.main(extra)
        monkeypatch.setattr(sys, "argv", ["train_lm.py"] + extra)
        ref.main()
    for got, want in zip(seen["port"], seen["reference"]):
        i, j = got.index("--ckpt-dir"), want.index("--ckpt-dir")
        assert got[i + 1] != want[j + 1] == "/tmp/repro_train_lm"
        assert got[:i] + got[i + 2:] == want[:j] + want[j + 2:]
    assert port.DEFAULT_CKPT_DIR.endswith("repro_torch_train_lm")


# ------------------------------------------------------------------ serving
def test_serve_batch_example_on_the_cpu():
    """granite-moe-1b-a400m reduced, 8 requests, 32 decode steps on the
    kernels' plain twins: decode tokens/s > 0 and no launch on the CPU."""
    out = _load("examples/torch_serve_batch.py").main(["--device", "cpu"])
    assert out["decode_tokens_per_s"] > 0 and out["device"] == "cpu"
    assert np.array(out["tokens"]).shape == (8, 32)
    assert not any(n for phase in out["launches"].values() for n in phase.values())


# ------------------------------------------------------------------ quickstart
def test_quickstart_blocked_solve_and_dataflow_cycles_equal_reference():
    """Step 6's blocked plain version within 1e-5 of max|x_ref| against
    serial_solve; step 7's cycles equal the reference's on ckt_add20."""
    out = _load("examples/torch_quickstart.py").main(["--device", "cpu"])
    blk = out["blocked"]
    assert blk["placement"] == "blocked" and blk["num_blocks"] > 1
    assert blk["max_err"] <= 1e-5 * blk["max_ref"], blk
    mat = japi.matrix("ckt_add20")
    assert out["cycles"] == {"coarse": japi.baseline_coarse(mat).stats.cycles,
                             "fine": japi.baseline_fine(mat).effective_cycles,
                             "medium": japi.compile(mat).stats.cycles}
    # the blocked solve's answer itself, against the reference's serial solve
    band = api.matrix("band_cz")
    b = np.random.default_rng(3).standard_normal((band.n, 4))
    solver = api.make_solver(api.compile(band), batch=4, backend="cuda",
                             placement="blocked", device="cpu")
    x = solver(b).numpy()
    want = np.stack([jserial_solve(japi.matrix("band_cz"), b[:, j]) for j in range(4)], 1)
    assert float(np.abs(x - want).max()) <= 1e-5 * float(np.abs(want).max())
