"""The port's DAG-workload frontends against the JAX package's.

Twins tests/test_frontends.py.  Upper, transpose-pair and circuit
workloads compile through both packages to the same programs (the 23
suite matrices with n <= 5k; with and without ``verify_ir=True``);
`random_circuit` draws the same arrays for a seed; and every port backend
(``"numpy"``; ``"torch"`` and ``"cuda"`` on ``device="cpu"``, where the
kernels' plain versions run) agrees with the JAX package's Pallas solve
(interpret mode) and with the float64 oracles within 1e-5.  The
reference's sharded case is left out: the port has no multi-device path.
"""

import numpy as np
import pytest

from repro.core import api as ref_api
from repro.core import csr as ref_csr
from repro.core.frontends import dagcirc as ref_dagcirc
from repro.core.frontends import upper as ref_upper
from repro_torch.core import api, matrices, shard
from repro_torch.core.csr import (
    from_coo,
    serial_solve,
    serial_solve_upper,
    transpose_upper,
)
from repro_torch.core.dag import analyze
from repro_torch.core.frontends import dagcirc, upper
from repro_torch.core.frontends.dagcirc import random_circuit
from repro_torch.core.program import AccelConfig
from test_torch_compiler import SMALL, assert_same_program

TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu")
# every port backend, on the CPU: the oracle, the eager executor and the
# kernels' plain versions (placement "auto")
BACKENDS = [("numpy", {}), ("torch", CPU), ("cuda", CPU)]


def random_lower(n, density, seed, name=None, *, lib=None):
    """A random lower-triangular system, built by the port's ``from_coo``
    (or the JAX package's, ``lib=ref_csr``) from the same seeded draws."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(1, n):
        m = rng.random(i) < density
        for j in np.nonzero(m)[0]:
            rows.append(i)
            cols.append(int(j))
    vals = rng.uniform(-0.5, 0.5, len(rows))
    diag = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
    make = lib.from_coo if lib is not None else from_coo
    return make(n, rows, cols, vals, diag, name=name or f"rnd_{seed}")


def _same_dag(got, ref):
    """Two `ComputeDag`s or two `DagCircuit`s hold the same arrays."""
    assert got.name == ref.name and got.n == ref.n
    for f in ("ptr", "src", "weight", "scale"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# --------------------------------------------------------- same programs
@pytest.mark.parametrize("name", SMALL)
def test_upper_program_matches_reference(name):
    u = transpose_upper(matrices.generate(name))
    ref_u = ref_csr.transpose_upper(ref_api.matrix(name))
    _same_dag(upper.lower_upper(u)[0], ref_upper.lower_upper(ref_u)[0])
    cw, ref_cw = api.compile_upper(u), ref_api.compile_upper(ref_u)
    np.testing.assert_array_equal(cw.perm, ref_cw.perm)
    assert cw.name == ref_cw.name
    assert_same_program(cw.program, ref_cw.program)


@pytest.mark.parametrize("verify_ir", [False, True])
@pytest.mark.parametrize("n,seed,locality", [
    (300, 0, None), (400, 1, 60), (1024, 9, 48), (2000, 21, 48)])
def test_circuit_program_matches_reference(n, seed, locality, verify_ir):
    kw = dict(max_fan_in=5, seed=seed, locality=locality)
    circ = random_circuit(n, **kw)
    ref_circ = ref_dagcirc.random_circuit(n, **kw)
    _same_dag(circ, ref_circ)
    _same_dag(dagcirc.lower_circuit(circ), ref_dagcirc.lower_circuit(ref_circ))
    assert_same_program(api.compile_circuit(circ, verify_ir=verify_ir).program,
                        ref_api.compile_circuit(ref_circ, verify_ir=verify_ir).program)


@pytest.mark.parametrize("kw", [
    dict(n=2), dict(n=500, max_fan_in=1), dict(n=700, leaf_frac=0.9, seed=3),
    dict(n=1000, max_fan_in=8, locality=16, seed=7, name="c"),
    # the DPU-v2-style circuit the on-card smoke solves (85,392 nodes)
    dict(n=85392, max_fan_in=6, seed=85392, locality=85392 // 16),
], ids=["n2", "fan1", "leafy", "local", "smoke85392"])
def test_random_circuit_same_arrays(kw):
    kw = dict(kw)
    n = kw.pop("n")
    _same_dag(random_circuit(n, **kw), ref_dagcirc.random_circuit(n, **kw))


def test_lower_transpose_matches_reference():
    mat = random_lower(90, 0.2, 5)
    ref_mat = random_lower(90, 0.2, 5, lib=ref_csr)
    dag, perm = upper.lower_transpose(mat)
    ref_dag, ref_perm = ref_upper.lower_transpose(ref_mat)
    _same_dag(dag, ref_dag)
    np.testing.assert_array_equal(perm, ref_perm)


# ------------------------------------------------------------------ upper
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_upper_solve_matches_scipy(seed):
    scipy_sparse = pytest.importorskip("scipy.sparse")
    import scipy.sparse.linalg  # noqa: F401

    n = 80 + 17 * seed
    u = transpose_upper(random_lower(n, 0.25, seed))
    b = np.random.default_rng(100 + seed).standard_normal(n)
    mat = scipy_sparse.csr_matrix((u.values, u.colidx, u.rowptr), shape=(n, n))
    ref = scipy_sparse.linalg.spsolve_triangular(mat, b, lower=False)
    cw = api.compile_upper(u)
    for backend, opts in BACKENDS:
        got = cw.solve(b, backend=backend, **opts)
        assert got.shape == (n,)
        np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(serial_solve_upper(u, b), ref, rtol=1e-10)


def test_upper_solve_suite_matrix_all_executors():
    mat = matrices.generate("band_cz")
    u = transpose_upper(mat)
    b = np.random.default_rng(7).standard_normal(mat.n)
    ref = serial_solve_upper(u, b)
    cw = api.compile_upper(u)
    ref_cw = ref_api.compile_upper(ref_csr.transpose_upper(ref_api.matrix("band_cz")))
    for backend, opts in BACKENDS:
        np.testing.assert_allclose(cw.solve(b, backend=backend, **opts), ref, **TOL)
    for placement in ("resident", "blocked"):
        got = cw.solve(b, backend="cuda", placement=placement,
                       cycles_per_block=64, **CPU)
        want = ref_cw.solve(b, backend="pallas", placement=placement,
                            cycles_per_block=64, interpret=True)
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, want, **TOL)


def test_upper_batched():
    u = transpose_upper(matrices.generate("band_cz"))
    bmat = np.random.default_rng(11).standard_normal((u.n, 8))
    ref = np.stack([serial_solve_upper(u, bmat[:, k]) for k in range(8)], axis=1)
    cw = api.compile_upper(u)
    for backend, opts in BACKENDS:
        got = cw.solve(bmat, backend=backend, **opts)
        assert got.shape == (u.n, 8)
        np.testing.assert_allclose(got, ref, **TOL)


def test_solve_upper_accepts_raw_matrix():
    u = transpose_upper(random_lower(40, 0.3, 5))
    b = np.random.default_rng(5).standard_normal(40)
    np.testing.assert_allclose(api.solve_upper(u, b, **CPU),
                               serial_solve_upper(u, b), **TOL)


def test_workload_solve_argument_rules():
    cw = api.compile_upper(transpose_upper(random_lower(30, 0.3, 1)))
    b = np.zeros(30)
    with pytest.raises(ValueError, match="numpy"):
        cw.solve(b, backend="numpy", device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        cw.solve(b, mesh=object())
    with pytest.raises(ValueError, match="mesh"):
        cw.solve(b, mesh=shard.batch_mesh(devices=("cpu",)), **CPU)
    from repro_torch.core.errors import UnknownBackendError

    with pytest.raises(UnknownBackendError):
        cw.solve(b, backend="pallas")


# --------------------------------------------------------- transpose pair
@pytest.mark.parametrize("seed", [3, 4])
def test_compile_pair_ic_sweep(seed):
    """One compiled pair runs the full forward+backward IC application:
    x = Lᵀ \\ (L \\ b) == (L Lᵀ)⁻¹ b."""
    mat = random_lower(70 + 11 * seed, 0.3, seed)
    dense = mat.to_dense()
    b = np.random.default_rng(200 + seed).standard_normal(mat.n)
    ref = np.linalg.solve(dense @ dense.T, b)
    pair = api.compile_pair(mat)
    ref_pair = ref_api.compile_pair(random_lower(70 + 11 * seed, 0.3, seed, lib=ref_csr))
    assert_same_program(pair.forward.program, ref_pair.forward.program)
    assert_same_program(pair.backward.program, ref_pair.backward.program)
    for backend, opts in BACKENDS:
        got = pair.solve(b, backend=backend, **opts)
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5)
    # the backward sweep alone must match the serial upper oracle
    y = serial_solve(mat, b)
    np.testing.assert_allclose(pair.backward.solve(y, **CPU),
                               serial_solve_upper(transpose_upper(mat), y), **TOL)
    np.testing.assert_allclose(api.solve_pair(pair, b, **CPU),
                               pair.solve(b, **CPU), rtol=0, atol=0)


def test_pair_pallas_blocked_placement():
    mat = matrices.generate("band_cz")
    pair = api.compile_pair(mat)
    b = np.random.default_rng(13).standard_normal(mat.n)
    dense = mat.to_dense()
    ref = np.linalg.solve(dense @ dense.T, b)
    got = pair.solve(b, backend="cuda", placement="blocked", cycles_per_block=64, **CPU)
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-4)
    want = ref_api.compile_pair(ref_api.matrix("band_cz")).solve(
        b, backend="pallas", placement="blocked", cycles_per_block=64, interpret=True)
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------- circuits
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_circuit_matches_oracle(seed):
    circ = random_circuit(120 + 40 * seed, max_fan_in=5, seed=seed,
                          locality=60 if seed % 2 else None)
    cw = api.compile_circuit(circ)
    u = np.random.default_rng(300 + seed).standard_normal(circ.n)
    ref = circ.eval(u)
    ref_circ = ref_dagcirc.random_circuit(120 + 40 * seed, max_fan_in=5, seed=seed,
                                          locality=60 if seed % 2 else None)
    np.testing.assert_array_equal(ref, ref_circ.eval(u))
    for backend, opts in BACKENDS:
        np.testing.assert_allclose(cw.solve(u, backend=backend, **opts), ref, **TOL)


def test_circuit_pallas_and_batched():
    circ = random_circuit(256, max_fan_in=4, seed=9, locality=48)
    cw = api.compile_circuit(circ)
    umat = np.random.default_rng(42).standard_normal((circ.n, 4))
    ref = circ.eval(umat)
    np.testing.assert_allclose(cw.solve(umat, **CPU), ref, **TOL)
    got = cw.solve(umat, backend="cuda", placement="resident", cycles_per_block=32, **CPU)
    want = ref_api.compile_circuit(ref_dagcirc.random_circuit(
        256, max_fan_in=4, seed=9, locality=48)).solve(
        umat, backend="pallas", placement="resident", cycles_per_block=32, interpret=True)
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_circuit_pallas_blocked_placement():
    """Strongly-local circuits admit the row-blocked window placement."""
    from repro.kernels.sptrsv import ops as ref_ops
    from repro_torch.kernels.sptrsv import ops

    circ = random_circuit(1024, max_fan_in=4, seed=21, locality=48)
    cw = api.compile_circuit(circ)
    plan = ops.plan_window(cw.program, 32)
    assert plan.feasible and plan.num_blocks > 1
    ref_cw = ref_api.compile_circuit(
        ref_dagcirc.random_circuit(1024, max_fan_in=4, seed=21, locality=48))
    ref_plan = ref_ops.plan_window(ref_cw.program, 32)
    assert (plan.stride, plan.window, plan.n_hbm, plan.num_blocks) == (
        ref_plan.stride, ref_plan.window, ref_plan.n_hbm, ref_plan.num_blocks)
    u = np.random.default_rng(1).standard_normal((circ.n, 4))
    got = cw.solve(u, backend="cuda", placement="blocked", cycles_per_block=32, **CPU)
    want = ref_cw.solve(u, backend="pallas", placement="blocked", cycles_per_block=32,
                        interpret=True)
    np.testing.assert_allclose(got, circ.eval(u), **TOL)
    np.testing.assert_allclose(got, want, **TOL)


def test_circuit_stats_and_analysis():
    """Generic DAG workloads get the paper's Table III treatment too."""
    circ = random_circuit(300, seed=4)
    info = analyze(circ)
    assert info.n == 300 and info.nnz == circ.n_edges + circ.n
    prog = api.compile_circuit(circ, AccelConfig()).program
    assert prog.stats.exec_edges == circ.n_edges
    assert prog.stats.exec_finals == circ.n
    rep = api.report(prog)
    assert rep["emitted_cycles"] == prog.cycles
    assert rep["planes"] == prog.planes
    assert rep["instr_bytes"] == prog.instr_bytes()
    ref_rep = ref_api.report(ref_api.compile_circuit(ref_dagcirc.random_circuit(
        300, seed=4)).program)
    rep.pop("compile_s"), ref_rep.pop("compile_s")
    assert rep == ref_rep


# -------------------------------------------------- hypothesis wide sweeps
def test_upper_property_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(st.integers(2, 70), st.floats(0.0, 0.5), st.integers(0, 2**31 - 1))
    def run(n, density, seed):
        u = transpose_upper(random_lower(n, density, seed))
        b = np.random.default_rng(seed ^ 0xABC).standard_normal(n)
        cw = api.compile_upper(u)
        ref = serial_solve_upper(u, b)
        np.testing.assert_allclose(cw.solve(b, backend="numpy"), ref, **TOL)
        ref_cw = ref_api.compile_upper(
            ref_csr.transpose_upper(random_lower(n, density, seed, lib=ref_csr)))
        assert_same_program(cw.program, ref_cw.program)

    run()


def test_circuit_property_hypothesis():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(st.integers(2, 120), st.integers(1, 8), st.floats(0.05, 0.9),
           st.integers(0, 2**31 - 1))
    def run(n, fan_in, leaf_frac, seed):
        kw = dict(max_fan_in=fan_in, leaf_frac=leaf_frac, seed=seed)
        circ = random_circuit(n, **kw)
        u = np.random.default_rng(seed ^ 0x5A5).standard_normal(n)
        cw = api.compile_circuit(circ)
        np.testing.assert_allclose(cw.solve(u, backend="numpy"), circ.eval(u), **TOL)
        ref_circ = ref_dagcirc.random_circuit(n, **kw)
        _same_dag(circ, ref_circ)
        assert_same_program(cw.program, ref_api.compile_circuit(ref_circ).program)

    run()
