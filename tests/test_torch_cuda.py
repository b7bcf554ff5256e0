"""The Hopper kernels on the card; every test here skips without one.

Imports only the port (no jax, no ``repro``), so it runs on a machine
that has a CUDA card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch twin on the same CUDA
tensors (rtol 1e-5, atol 1e-5, as tests/test_blocked.py), and the slice
end to end against the serial forward substitution.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import api
from repro_torch.core.csr import serial_solve
from repro_torch.core.executor import _psum_slots
from repro_torch.core.schedule import compile_program
from repro_torch.kernels.sptrsv import kernel, ops

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _staged(prog, cpb, rows, nb, seed, device):
    instr, values = ops._stage_instructions(prog, cpb)
    b = np.zeros((rows, nb), np.float32)
    b[:prog.n] = np.random.default_rng(seed).standard_normal((prog.n, nb))
    return [torch.from_numpy(a).to(device) for a in (instr, values, b)]


@pytest.mark.cuda
@pytest.mark.parametrize("name,planes", [("ckt_rajat04", 1), ("band_cz", 2)])
def test_resident_kernel_matches_plain(cuda, name, planes):
    prog = compile_program(api.matrix(name), planes=planes)
    instr, values, b = _staged(prog, 128, prog.n + 1, 16, 3, cuda)
    slots = _psum_slots(prog)
    want = kernel.sptrsv_plain(instr, values, b, num_slots=slots)
    for x_in_smem, cols in ((True, 1), (False, 2)):
        before = kernel.sptrsv_cuda.launches
        got = kernel.sptrsv_cuda(instr, values, b, num_slots=slots,
                                 x_in_smem=x_in_smem, cols_per_cta=cols)
        assert kernel.sptrsv_cuda.launches == before + 1
        torch.testing.assert_close(got[:prog.n], want[:prog.n], **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("name,cpb,planes", [("band_dw2048", 64, 1), ("band_cz", 32, 2)])
def test_blocked_kernel_matches_plain(cuda, name, cpb, planes):
    prog = compile_program(api.matrix(name), planes=planes)
    plan = ops.plan_window(prog, cpb)
    instr, values, b = _staged(prog, cpb, plan.n_hbm, 16, 4, cuda)
    kw = dict(window=plan.window, stride=plan.stride, cycles_per_block=cpb,
              num_slots=_psum_slots(prog))
    want = kernel.sptrsv_blocked_plain(instr, values, b, **kw)
    for cols in (1, 2):
        before = kernel.sptrsv_cuda_blocked.launches
        got = kernel.sptrsv_cuda_blocked(instr, values, b, cols_per_cta=cols, **kw)
        assert kernel.sptrsv_cuda_blocked.launches == before + 1
        torch.testing.assert_close(got[:prog.n], want[:prog.n], **TOL)


@pytest.mark.cuda
def test_refused_launch_raises(cuda):
    prog = api.compile(api.matrix("band_cz"))
    rows = 100_000  # x of 400 KB per column cannot sit in shared memory
    instr, values, b = _staged(prog, 128, rows, 1, 5, cuda)
    before = kernel.sptrsv_cuda.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        kernel.sptrsv_cuda(instr, values, b, num_slots=_psum_slots(prog),
                           x_in_smem=True)
    assert kernel.sptrsv_cuda.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("placement", ["resident", "blocked"])
def test_slice_on_card(cuda, placement):
    mat = api.matrix("band_dw2048")
    prog = api.compile(mat)
    bmat = np.random.default_rng(10).standard_normal((mat.n, 16))
    solver = api.make_solver(prog, batch=16, backend="cuda", placement=placement)
    assert solver.placement == placement
    x = solver(bmat)
    assert x.device.type == "cuda"
    want = np.stack([serial_solve(mat, bmat[:, i]) for i in range(16)], 1)
    np.testing.assert_allclose(x.cpu().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
