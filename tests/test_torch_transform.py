"""The port's node splitting and baselines against the JAX package's.

Twins tests/test_transform.py.  `split_heavy_nodes` builds the same split
system, `compile_split` and `baseline_coarse` the same programs, and
`schedule_fine` the same statistics, on the 23 suite matrices with
n <= 5k; `solve_split` on every port backend (``"torch"`` and ``"cuda"``
on ``device="cpu"``: the eager executor and the kernels' plain versions)
agrees with the JAX package's Pallas solve (interpret mode) and with the
serial solve of the unsplit matrix.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import api as ref_api
from repro.core import csr as ref_csr
from repro.core import transform as ref_transform
from repro_torch.core import api, matrices
from repro_torch.core.csr import from_coo, random_rhs, serial_solve
from repro_torch.core.transform import split_heavy_nodes
from test_torch_compiler import SMALL, assert_same_program

CPU = dict(device="cpu")


def _same_split(got, ref):
    assert got.n_aux == ref.n_aux and got.mat.name == ref.mat.name
    np.testing.assert_array_equal(got.orig_index, ref.orig_index)
    for f in ("rowptr", "colidx", "values"):
        np.testing.assert_array_equal(getattr(got.mat, f), getattr(ref.mat, f), err_msg=f)


@pytest.mark.parametrize("name", SMALL)
def test_split_program_matches_reference(name):
    prog, split = api.compile_split(matrices.generate(name), max_indegree=48)
    ref_prog, ref_split = ref_api.compile_split(ref_api.matrix(name), max_indegree=48)
    _same_split(split, ref_split)
    assert_same_program(prog, ref_prog)


@pytest.mark.parametrize("name", SMALL)
def test_baselines_match_reference(name):
    mat, ref_mat = matrices.generate(name), ref_api.matrix(name)
    assert_same_program(api.baseline_coarse(mat), ref_api.baseline_coarse(ref_mat))
    assert dataclasses.asdict(api.baseline_fine(mat)) == dataclasses.asdict(
        ref_api.baseline_fine(ref_mat))


@pytest.mark.parametrize("name", ["hub_wall", "hub_small", "ckt_rajat04", "band_cz"])
def test_split_equivalence_on_suite(name):
    mat = matrices.generate(name)
    b = random_rhs(mat, 3)
    ref = serial_solve(mat, b)
    prog, split = api.compile_split(mat, max_indegree=48)
    for backend in ("torch", "cuda"):
        got = api.solve_split(prog, split, b, backend=backend, **CPU)
        assert got.shape == (mat.n,)
        np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("placement,cpb", [("resident", 128), ("blocked", 64)])
def test_split_kernels_match_reference_pallas(placement, cpb):
    """The batched split solve through the kernels' plain versions, against
    the JAX package's Pallas kernel in interpret mode, both placements."""
    mat = matrices.generate("hub_small")
    bmat = np.random.default_rng(5).standard_normal((mat.n, 3))
    prog, split = api.compile_split(mat, max_indegree=48)
    got = api.solve_split(prog, split, bmat, backend="cuda", placement=placement,
                          cycles_per_block=cpb, **CPU)
    ref_prog, ref_split = ref_api.compile_split(ref_api.matrix("hub_small"),
                                                max_indegree=48)
    want = ref_api.solve_split(ref_prog, ref_split, bmat, backend="pallas",
                               placement=placement, cycles_per_block=cpb,
                               interpret=True)
    ref = np.stack([serial_solve(mat, bmat[:, k]) for k in range(3)], 1)
    assert got.shape == (mat.n, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-4)


def test_split_bounds_indegree():
    mat = matrices.generate("hub_wall")
    split = split_heavy_nodes(mat, max_indegree=32)
    assert split.mat.in_degree().max() <= 32 + split.n_aux  # parent gets aux edges
    assert split.n_aux > 0
    sp2 = split_heavy_nodes(matrices.generate("chain_1k"), max_indegree=32)
    assert sp2.n_aux == 0
    assert sp2.mat.n == matrices.generate("chain_1k").n


def test_split_speedup_on_load_imbalance():
    """The paper's §V-E open problem: splitting must beat the plain medium
    dataflow AND the fine baseline on pure hub-wall load imbalance."""
    mat = matrices.generate("hub_wall")
    base = api.compile(mat)
    prog, _ = api.compile_split(mat, max_indegree=64)
    assert prog.stats.cycles < base.stats.cycles / 3
    fine = api.baseline_fine(mat)
    flops = 2 * mat.nnz - mat.n
    gops_split = flops / (prog.stats.cycles * prog.config.clock_period_s) / 1e9
    assert gops_split > fine.throughput_gops()


def test_split_equivalence_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=20, deadline=None)
    @given(st.integers(0, 10_000), st.integers(2, 9))
    def run(seed, max_indeg):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(5, 60))
        rows, cols = [], []
        for i in range(1, n):
            m = rng.random(i) < 0.4
            for j in np.nonzero(m)[0]:
                rows.append(i)
                cols.append(int(j))
        coo = (n, rows, cols, rng.uniform(-1, 1, len(rows)), rng.uniform(1, 2, n))
        mat = from_coo(*coo, name=f"h{seed}")
        b = rng.standard_normal(n)
        split = split_heavy_nodes(mat, max_indegree=max_indeg)
        ref_split = ref_transform.split_heavy_nodes(ref_csr.from_coo(*coo, name=f"h{seed}"),
                                                    max_indegree=max_indeg)
        _same_split(split, ref_split)
        prog = api.compile(split.mat)
        got = split.extract(api.solve_numpy(prog, split.expand_rhs(b)))
        np.testing.assert_allclose(got, serial_solve(mat, b), rtol=5e-4, atol=5e-4)

    run()
