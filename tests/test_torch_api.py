"""The port's slice end to end against the JAX package.

matrix -> compile -> solve_batch(backend="cuda", device="cpu") runs the
port's staging, placement and the kernels' plain versions; it is held
against the reference api (Pallas in interpret mode) and against the
serial forward substitution, for both placements.
"""

import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core.csr import serial_solve
from repro_torch.core import api

TOL = 1e-5


def _serial(mat, bmat):
    return np.stack([serial_solve(mat, bmat[:, i]) for i in range(bmat.shape[1])], 1)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())


@pytest.mark.parametrize("name,placement,cpb", [
    ("band_cz", "resident", 128), ("band_cz", "blocked", 64),
    ("ckt_rajat04", "resident", 128), ("chain_1k", "blocked", 128),
])
def test_slice_matches_reference_pallas(name, placement, cpb):
    mat = api.matrix(name)
    prog = api.compile(mat)
    bmat = np.random.default_rng(7).standard_normal((mat.n, 6))
    got = api.solve_batch(prog, bmat, backend="cuda", device="cpu",
                          placement=placement, cycles_per_block=cpb)
    ref_prog = ref_api.compile(ref_api.matrix(name))
    want = ref_api.solve_batch(ref_prog, bmat, backend="pallas",
                               placement=placement, cycles_per_block=cpb,
                               interpret=True)
    assert got.shape == (mat.n, 6) and got.dtype == np.float32
    _close(got, np.asarray(want))
    _close(got, _serial(mat, bmat))


def test_torch_backend_matches_reference_jax():
    mat = api.matrix("ckt_c204")
    prog = api.compile(mat)
    b = np.random.default_rng(8).standard_normal(mat.n)
    got = api.solve(prog, b, device="cpu")
    want = ref_api.solve(ref_api.compile(ref_api.matrix("ckt_c204")), b)
    _close(got, np.asarray(want))
    _close(got, serial_solve(mat, b))


def test_make_solver_reports_placement_and_reuses_cache():
    prog = api.compile(api.matrix("band_cz"))
    a = api.make_solver(prog, batch=6, backend="cuda", device="cpu",
                        placement="blocked", cycles_per_block=64)
    assert a.placement == "blocked" and a.plan.feasible
    b = api.make_solver(prog, batch=6, backend="cuda", device="cpu",
                        placement="blocked", cycles_per_block=64)
    bmat = np.random.default_rng(9).standard_normal((prog.n, 6))
    torch.testing.assert_close(a(bmat), b(bmat), rtol=0, atol=0)
    one = api.make_solver(prog, backend="cuda", device="cpu")
    assert one.placement == "resident"
    assert tuple(one(bmat[:, 0]).shape) == (prog.n,)


def test_solve_batch_accepts_vector():
    prog = api.compile(api.matrix("band_cz"))
    b = np.random.default_rng(1).standard_normal(prog.n)
    x = api.solve_batch(prog, b, device="cpu")
    assert x.shape == (prog.n, 1)
    np.testing.assert_allclose(x[:, 0], api.solve(prog, b, device="cpu"),
                               rtol=1e-6, atol=1e-6)


def test_report_matches_reference():
    got = api.report(api.compile(api.matrix("chem_bp")))
    want = ref_api.report(ref_api.compile(ref_api.matrix("chem_bp")))
    got.pop("compile_s"), want.pop("compile_s")
    assert got == want


def test_mesh_not_ported_yet():
    """mesh= is ported (tests/test_torch_shard.py): a BatchMesh splits the
    columns; anything else is refused, as is a device= beside it."""
    from repro_torch.core import shard

    prog = api.compile(api.matrix("band_cz"))
    with pytest.raises(TypeError, match="mesh"):
        api.make_solver(prog, batch=2, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="mesh"):
        api.solve_batch(prog, np.zeros((prog.n, 2)), mesh=object(), device="cpu")
    mesh = shard.batch_mesh(devices=("cpu", "cpu"))
    with pytest.raises(ValueError, match="mesh"):
        api.solve_batch(prog, np.zeros((prog.n, 2)), mesh=mesh, device="cpu")
    b = np.random.default_rng(3).standard_normal((prog.n, 2))
    np.testing.assert_array_equal(api.solve_batch(prog, b, mesh=mesh),
                                  api.solve_batch(prog, b, device="cpu"))


def test_ops_solve_keeps_rhs_shape():
    from repro_torch.kernels.sptrsv import ops

    mat = api.matrix("band_cz")
    prog = api.compile(mat)
    b = np.random.default_rng(11).standard_normal((mat.n, 3))
    x = ops.solve(prog, b, placement="blocked", cycles_per_block=64, device="cpu")
    assert x.shape == (mat.n, 3)
    _close(x, _serial(mat, b))
    one = ops.solve(prog, b[:, 0], device="cpu")
    assert one.shape == (mat.n,)
    _close(one, serial_solve(mat, b[:, 0]))
