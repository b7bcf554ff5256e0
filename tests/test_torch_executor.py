"""The port's executors against the JAX package's, on programs it compiled.

Programs come from the reference compiler and cross over with
`program_from_arrays`; the port's `execute_numpy` (a copy) must agree
exactly, the torch executor and the kernels' plain versions within the
reference tests' tolerance.
"""

import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core.csr import random_rhs, serial_solve
from repro.core.executor import execute_numpy as ref_execute_numpy
from repro.core.matrices import generate
from repro.core.schedule import compile_program as ref_compile_program
from repro_torch.core import api, executor
from repro_torch.core.errors import BackendOptionsError, UnknownBackendError
from repro_torch.core.program import program_from_arrays

CPU = "cpu"


def port_program(ref):
    return program_from_arrays(
        ref.config, ref.n, ref.instr, ref.val_idx, ref.stream, ref.stats,
        num_slots=ref.num_slots, row_lo=ref.row_lo, row_hi=ref.row_hi,
        stream_src=ref.stream_src)


@pytest.fixture(scope="module")
def progs():
    ref = ref_api.compile(generate("band_cz"))
    return ref, port_program(ref)


def test_program_from_arrays_copies_every_field(progs):
    ref, prog = progs
    for field in ("instr", "val_idx", "stream", "row_lo", "row_hi", "stream_src"):
        a, b = getattr(prog, field), getattr(ref, field)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and not np.shares_memory(a, b), field
    assert prog.config.num_cus == ref.config.num_cus
    assert prog.stats.cycles == ref.stats.cycles
    assert (prog.cycles, prog.planes, prog.num_cus) == (ref.cycles, ref.planes, ref.num_cus)


def test_program_from_arrays_takes_mappings(progs):
    import dataclasses

    ref, _ = progs
    prog = program_from_arrays(dataclasses.asdict(ref.config), ref.n, ref.instr,
                               ref.val_idx, ref.stream,
                               {f.name: getattr(ref.stats, f.name)
                                for f in dataclasses.fields(ref.stats)},
                               num_slots=ref.num_slots)
    assert prog.config.psum_words == ref.config.psum_words
    assert prog.row_lo is None


# B=1 degenerate, non-multiples of the pad width (3, 13), and a padded width
@pytest.mark.parametrize("B", [1, 3, 13, 16])
def test_execute_numpy_is_the_reference_oracle(progs, B):
    ref, prog = progs
    bmat = np.random.default_rng(B).standard_normal((prog.n, B))
    np.testing.assert_array_equal(executor.execute_numpy(prog, bmat),
                                  ref_execute_numpy(ref, bmat))


@pytest.mark.parametrize("B", [1, 3, 13, 16])
def test_torch_executor_matches_reference(progs, B):
    ref, prog = progs
    bmat = np.random.default_rng(B).standard_normal((prog.n, B))
    want = ref_execute_numpy(ref, bmat)
    got = api.solve_batch(prog, bmat, device=CPU)
    assert got.shape == (prog.n, B)
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-5, rel
    for i in range(B):  # each column as its own single-RHS solve
        one = api.solve(prog, bmat[:, i], device=CPU)
        assert one.shape == (prog.n,)
        assert np.abs(one - got[:, i]).max() / max(np.abs(one).max(), 1e-12) <= 1e-5


@pytest.mark.parametrize("name", ["band_cz", "ckt_rajat04", "hub_small"])
@pytest.mark.parametrize("planes", [1, 2])
def test_all_executors_parity_both_regimes(name, planes):
    mat = generate(name)
    ref = ref_compile_program(mat, planes=planes)
    prog = port_program(ref)
    assert prog.planes == planes
    b = random_rhs(mat, 17 + planes)
    want = serial_solve(mat, b)
    tol = dict(rtol=1e-5, atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(api.solve_numpy(prog, b), want, **tol)
    np.testing.assert_allclose(api.solve(prog, b, device=CPU), want, **tol)
    np.testing.assert_allclose(
        api.solve_batch(prog, b, backend="cuda", device=CPU)[:, 0], want, **tol)


def test_padded_width_cache_contract(progs):
    prog = port_program(progs[0])  # a fresh program: an empty cache
    dev = torch.device(CPU)
    with pytest.raises(AssertionError, match="padded width"):
        executor._cached_executor(prog, 3, dev)
    rng = np.random.default_rng(5)
    api.solve_batch(prog, rng.standard_normal((prog.n, 3)), device=CPU)
    before = executor.trace_count()
    api.solve_batch(prog, rng.standard_normal((prog.n, 3)), device=CPU)
    api.solve_batch(prog, rng.standard_normal((prog.n, 5)), device=CPU)  # pads to 8 too
    assert executor.trace_count() == before
    api.solve_batch(prog, rng.standard_normal((prog.n, 9)), device=CPU)  # pads to 16
    assert executor.trace_count() == before + 1
    for key in executor.cached_entries(prog):
        assert key[1] == executor.pad_batch(key[1]), key


def test_cuda_executor_cached_per_knobs(progs):
    _, prog = progs
    n_before = len(executor.cached_entries(prog))
    executor.make_cuda_executor(prog, batch=5, placement="blocked",
                                cycles_per_block=64, device=CPU)
    executor.make_cuda_executor(prog, batch=7, placement="blocked",
                                cycles_per_block=64, device=CPU)
    assert len(executor.cached_entries(prog)) == n_before + 1
    executor.make_cuda_executor(prog, batch=5, placement="resident", device=CPU)
    assert len(executor.cached_entries(prog)) == n_before + 2


def test_pad_batch_widths():
    assert executor.BATCH_PAD == 8
    assert [executor.pad_batch(w) for w in (1, 3, 8, 9)] == [1, 8, 8, 16]


def test_validate_backend():
    executor.validate_backend("torch", {"device": CPU})
    executor.validate_backend("cuda", {"placement": "blocked", "device": CPU})
    with pytest.raises(UnknownBackendError):
        executor.validate_backend("pallas", {})
    with pytest.raises(BackendOptionsError):
        executor.validate_backend("torch", {"placement": "blocked"})
    with pytest.raises(BackendOptionsError):
        executor.validate_backend("cuda", {"interpret": True})


def test_bad_rhs_shape_rejected(progs):
    _, prog = progs
    solver = api.make_solver(prog, batch=4, device=CPU)
    with pytest.raises(ValueError, match="shape"):
        solver(np.zeros((prog.n, 3)))
    assert tuple(solver(np.zeros((prog.n, 4))).shape) == (prog.n, 4)
