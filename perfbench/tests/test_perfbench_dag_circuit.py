"""The ``dag_circuit`` builder and the port on ``dag_circ85k``: the DAG
against the matrix solve it stands for, the reference tuple against a
direct evaluation of the DAG, the port's solve against the reference within
the configuration's limit and the bfloat16 control outside it, the work
count, and the kernel's time a cycle read from a trace."""

import json

import numpy as np
import pytest

from perfbench import harness, reference, work
from perfbench.builders import dag_circuit, tri_csr
from perfbench.devtrace import Trace
from perfbench.tests import helpers
from repro_torch.core import api
from repro_torch.core.frontends import lower_circuit
from repro_torch.core.frontends.sptrsv import lower_tri

FULL = json.loads((harness.HERE / "configs" / "dag_circ85k.json").read_text())
SMALL = json.loads(helpers.small_copy("dag_circ85k").read_text())
LIMIT = SMALL["limits"]["max_rel_err"]


def _direct(ptr, src, w, scale, u):
    """``x[i] = scale[i] * (u[i] + sum_k w[k] x[src[k]])`` in float64, one
    node after another."""
    u = np.asarray(u, dtype=np.float64)
    x = np.zeros_like(u)
    for i in range(len(scale)):
        lo, hi = ptr[i], ptr[i + 1]
        x[i] = scale[i] * (u[i] + w[lo:hi] @ x[src[lo:hi]])
    return x


def _inputs(n, seed, cols=4):
    return np.random.default_rng(seed).standard_normal((n, cols))


@pytest.fixture(scope="module")
def full_system():
    return dag_circuit.build(FULL, 2**31 + 3)


@pytest.mark.parametrize("which", ["full", "small"])
def test_dag_is_the_matrix_solve(which, full_system):
    """The circuit lowers to the compiler IR that the ``tri_csr`` builder's
    matrix of the same configuration and seed lowers to, array for array."""
    cfg, seed = {"full": (FULL, 2**31 + 3), "small": (SMALL, 4)}[which]
    system = full_system if which == "full" else dag_circuit.build(cfg, seed)
    dag, tri = lower_circuit(system.mat), lower_tri(tri_csr.build(cfg, seed).mat)
    assert (dag.n, system.n) == (tri.n, tri.n)
    for key in ("ptr", "src", "weight", "scale"):
        got, want = getattr(dag, key), getattr(tri, key)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), key


def test_work_of_the_full_configuration(full_system):
    n, nnz = full_system.n, full_system.nnz
    assert (n, nnz) == (85392, full_system.mat.n_edges + n) == (85392, 342719)
    assert work.flops(n, nnz) == 600046
    assert work.bytes_moved(n, nnz) == 3766460
    assert work.roofline_s(n, nnz) == pytest.approx(3766460 / work.PEAK_HBM_BYTES)


def test_values_follow_the_seed_pattern_does_not():
    seed = 2**31 + 11
    a, b, c = (dag_circuit.build(SMALL, s).mat for s in (seed, seed, seed + 1))
    for key in ("ptr", "src", "weight", "scale"):
        np.testing.assert_array_equal(getattr(a, key), getattr(b, key))
    np.testing.assert_array_equal(a.ptr, c.ptr)
    np.testing.assert_array_equal(a.src, c.src)
    assert not np.array_equal(a.weight, c.weight)
    assert np.abs(a.weight).max() <= 0.5
    assert np.all((np.abs(a.scale) >= 0.5) & (np.abs(a.scale) <= 1.0))
    assert (a.scale > 0).any() and (a.scale < 0).any()


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_reference_tuple_is_the_circuit(seed):
    system = dag_circuit.build(SMALL, seed)
    circ = system.mat
    assert (system.n, system.nnz) == (circ.n, circ.n_edges + circ.n)
    u = _inputs(circ.n, seed)
    want = _direct(circ.ptr, circ.src, circ.weight, circ.scale, u)
    got = reference.solve(*system.ref, u)
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    np.testing.assert_allclose(circ.eval(u), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("seed", [5, 6, 2**31 + 7])
def test_port_solve_is_within_the_limit(seed):
    system = dag_circuit.build(SMALL, seed)
    prog = system.compile()
    assert system.program_cycles == prog.cycles and system.compile_s > 0
    solver = api.make_solver(prog, backend="cuda", device="cpu",
                             **system.solver_opts)
    u = _inputs(system.n, seed).astype(np.float32)
    x = np.stack([solver(u[:, c]).numpy() for c in range(u.shape[1])], 1)
    err = reference.rel_err(x, reference.solve(*system.ref, u))
    assert err.max() <= LIMIT


def test_bfloat16_control_fails_the_limit():
    system = dag_circuit.build(SMALL, 8)
    u = _inputs(system.n, 8)
    err = reference.rel_err(reference.solve_lowered(*system.ref, u),
                            reference.solve(*system.ref, u))
    assert np.all(err > LIMIT)


def test_ns_per_cycle_reader():
    read = harness.load_module(
        harness.reader_path("sptrsv_cuda_ns_per_cycle.solve_ckt")).read
    device = [("Memcpy HtoD", 0.0, 0.001),
              ("r resident_kernel<1, 2, false>", 0.001, 0.004),
              ("r resident_kernel<1, 2, false>", 0.005, 0.010)]
    rec = {"trace": Trace([], device, (0.0, 0.010)), "program_cycles": 10_000}
    # 4 ms a launch over 10,000 cycles
    assert read(rec) == pytest.approx(400.0)
    assert read({**rec, "trace": None}) is None
    assert read({**rec, "program_cycles": None}) is None
    assert read({**rec, "trace": Trace([], device[:1], (0.0, 0.001))}) is None
