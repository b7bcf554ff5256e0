"""The kernels' plain versions against the Pallas kernels, and placement.

On the CPU the wrappers run their plain PyTorch versions; these are held
against `sptrsv_pallas` / `sptrsv_pallas_blocked` in interpret mode on the
same staged inputs, at the tolerance of tests/test_blocked.py.  The
kernels themselves are held against the plain versions on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as ref_api
from repro.core.executor import _psum_slots
from repro.core.matrices import generate
from repro.core.schedule import compile_program as ref_compile_program
from repro.kernels.sptrsv import ops as ref_ops
from repro.kernels.sptrsv.kernel import sptrsv_pallas, sptrsv_pallas_blocked
from repro_torch.core import api
from repro_torch.core.errors import PlacementInfeasibleError
from repro_torch.core.program import program_from_arrays
from repro_torch.kernels.sptrsv import kernel, ops

TOL = dict(rtol=1e-5, atol=1e-5)


def port_program(ref):
    return program_from_arrays(
        ref.config, ref.n, ref.instr, ref.val_idx, ref.stream, ref.stats,
        num_slots=ref.num_slots, row_lo=ref.row_lo, row_hi=ref.row_hi,
        stream_src=ref.stream_src)


def _staged(ref, cpb, rows, nb, seed):
    instr, values = ref_ops._stage_instructions(ref, cpb)
    b = np.zeros((rows, nb), np.float32)
    b[:ref.n] = np.random.default_rng(seed).standard_normal((ref.n, nb))
    return instr, values, b


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------- plain vs Pallas
@pytest.mark.parametrize("name,planes", [
    ("band_cz", 1), ("ckt_rajat04", 1), ("hub_small", 1), ("band_cz", 2),
])
def test_resident_plain_matches_pallas(name, planes):
    ref = ref_compile_program(generate(name), planes=planes)
    instr, values, b = _staged(ref, 128, ref.n + 1, 5, seed=planes)
    slots = _psum_slots(ref)
    want = np.asarray(sptrsv_pallas(jnp.asarray(instr), jnp.asarray(values),
                                    jnp.asarray(b), num_slots=slots,
                                    interpret=True))
    got = kernel.sptrsv_plain(*_t(instr, values, b), num_slots=slots).numpy()
    np.testing.assert_allclose(got[:ref.n], want[:ref.n], **TOL)


@pytest.mark.parametrize("name,cpb,planes", [
    ("band_cz", 64, 1), ("band_cz", 32, 1), ("chain_1k", 128, 1),
    ("band_dw2048", 64, 1), ("band_cz", 32, 2),
])
def test_blocked_plain_matches_pallas(name, cpb, planes):
    ref = ref_compile_program(generate(name), planes=planes)
    plan = ref_ops.plan_window(ref, cpb)
    assert plan.feasible and plan.num_blocks > 1 and plan.window < ref.n
    instr, values, b = _staged(ref, cpb, plan.n_hbm, 3, seed=cpb)
    slots = _psum_slots(ref)
    want = np.asarray(sptrsv_pallas_blocked(
        jnp.asarray(instr), jnp.asarray(values), jnp.asarray(b),
        window=plan.window, stride=plan.stride, cycles_per_block=cpb,
        num_slots=slots, interpret=True))
    got = kernel.sptrsv_blocked_plain(
        *_t(instr, values, b), window=plan.window, stride=plan.stride,
        cycles_per_block=cpb, num_slots=slots).numpy()
    np.testing.assert_allclose(got[:ref.n], want[:ref.n], **TOL)


def test_wrappers_take_plain_path_on_cpu_without_launching():
    ref = ref_api.compile(generate("band_cz"))
    plan = ref_ops.plan_window(ref, 64)
    slots = _psum_slots(ref)
    before = (kernel.sptrsv_cuda.launches, kernel.sptrsv_cuda_blocked.launches)
    instr, values, b = _t(*_staged(ref, 64, ref.n + 1, 2, seed=1))
    torch.testing.assert_close(kernel.sptrsv_cuda(instr, values, b, num_slots=slots),
                               kernel.sptrsv_plain(instr, values, b, num_slots=slots),
                               rtol=0, atol=0)
    instr, values, b = _t(*_staged(ref, 64, plan.n_hbm, 2, seed=2))
    kw = dict(window=plan.window, stride=plan.stride, cycles_per_block=64,
              num_slots=slots)
    torch.testing.assert_close(kernel.sptrsv_cuda_blocked(instr, values, b, **kw),
                               kernel.sptrsv_blocked_plain(instr, values, b, **kw),
                               rtol=0, atol=0)
    assert (kernel.sptrsv_cuda.launches, kernel.sptrsv_cuda_blocked.launches) == before


def test_wrappers_reject_bad_inputs():
    ref = ref_api.compile(generate("band_cz"))
    instr, values, b = _t(*_staged(ref, 128, ref.n + 1, 2, seed=0))
    slots = _psum_slots(ref)
    with pytest.raises(ValueError, match="int32"):
        kernel.sptrsv_cuda(instr.long(), values, b, num_slots=slots)
    with pytest.raises(ValueError, match="float32"):
        kernel.sptrsv_cuda(instr, values, b.double(), num_slots=slots)
    with pytest.raises(ValueError, match="contiguous"):
        kernel.sptrsv_cuda(instr, values, b.t().contiguous().t(), num_slots=slots)
    with pytest.raises(ValueError, match="num_slots"):
        kernel.sptrsv_cuda(instr, values, b, num_slots=0)
    with pytest.raises(ValueError, match="window sweep"):
        kernel.sptrsv_cuda_blocked(instr, values, b, window=64, stride=16,
                                   cycles_per_block=128, num_slots=slots)


# ------------------------------------------------------- staging + planning
@pytest.mark.parametrize("name,planes", [("band_cz", 1), ("hub_small", 2)])
def test_staging_matches_reference(name, planes):
    ref = ref_compile_program(generate(name), planes=planes)
    prog = port_program(ref)
    for cpb in (32, 128):
        for got, want in zip(ops._stage_instructions(prog, cpb),
                             ref_ops._stage_instructions(ref, cpb)):
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,cpb,min_window", [
    ("band_cz", 64, None), ("band_cz", 32, None), ("chain_1k", 128, None),
    ("band_dw2048", 64, 512), ("ckt_rajat04", 128, None), ("band_cz", 1024, None),
])
def test_plan_window_matches_reference(name, cpb, min_window):
    ref = ref_api.compile(generate(name))
    got = ops.plan_window(port_program(ref), cpb, min_window=min_window)
    want = ref_ops.plan_window(ref, cpb, min_window=min_window)
    assert (got.feasible, got.stride, got.window, got.n_hbm, got.num_blocks) == (
        want.feasible, want.stride, want.window, want.n_hbm, want.num_blocks)


def test_placement_against_smem_budget():
    prog = port_program(ref_api.compile(generate("band_cz")))
    resident = ops.state_bytes(prog, placement="resident")
    assert resident["x"] == (prog.n + 1) * 4
    assert resident["rf"] == ops._psum_slots(prog) * prog.num_cus * 4
    assert ops.instr_buffer_bytes(prog) == 2 * kernel.PREFETCH_CYCLES * prog.num_cus * 8
    # the whole vector fits the default 227 KB budget: resident
    assert ops.resolve_placement(prog, 8) == ("resident", None)
    # just below the resident state: the row window takes over
    limit = resident["total"] - 1
    mode, plan = ops.resolve_placement(prog, 8, smem_limit_bytes=limit,
                                       cycles_per_block=64)
    assert mode == "blocked" and plan.window < prog.n
    blocked = ops.state_bytes(prog, placement="blocked", plan=plan)
    assert blocked["total"] <= limit and blocked["x"] == plan.window * 4
    # the column tile multiplies what a CTA holds
    assert ops.state_bytes(prog, 4, placement="blocked", plan=plan)["total"] \
        == 4 * blocked["total"]
    # neither fits: resident, with x in device memory
    tiny = blocked["total"] - 1
    assert ops.resolve_placement(prog, 8, smem_limit_bytes=tiny,
                                 cycles_per_block=64) == ("resident", None)
    solver = api.make_solver(prog, batch=8, backend="cuda", device="cpu",
                             smem_limit_bytes=tiny, cycles_per_block=64)
    assert solver.placement == "resident" and not solver.x_in_smem
    with pytest.raises(ValueError, match="cols_per_cta"):
        ops.resolve_placement(prog, 8, cols_per_cta=3)


def test_forced_blocked_infeasible_raises():
    ckt = port_program(ref_api.compile(generate("ckt_rajat04")))
    assert not ops.plan_window(ckt, 128).feasible
    assert ops.resolve_placement(ckt, 8, smem_limit_bytes=1024)[0] == "resident"
    with pytest.raises(PlacementInfeasibleError, match="infeasible"):
        ops.resolve_placement(ckt, 8, placement="blocked")
    band = port_program(ref_api.compile(generate("band_cz")))
    with pytest.raises(PlacementInfeasibleError, match="shared memory"):
        ops.resolve_placement(band, 8, placement="blocked", smem_limit_bytes=1024)
    with pytest.raises(PlacementInfeasibleError):
        api.make_solver(band, batch=8, backend="cuda", device="cpu",
                        placement="blocked", smem_limit_bytes=1024)


def test_staging_refuses_out_of_range_words():
    prog = port_program(ref_api.compile(generate("band_cz")))
    instr, _ = ops._stage_instructions(prog, 128)
    plan = ops.plan_window(prog, 128)
    ops._check_stream(instr, ops._psum_slots(prog), prog.n + 1, None, 128)
    ops._check_stream(instr, ops._psum_slots(prog), plan.n_hbm, plan, 128)
    ckt = port_program(ref_api.compile(generate("ckt_rajat04")))
    ckt_instr, _ = ops._stage_instructions(ckt, 128)
    ops._check_stream(ckt_instr, ops._psum_slots(ckt), ckt.n + 1, None, 128)
    with pytest.raises(ValueError, match="psum slot"):
        ops._check_stream(ckt_instr, 4, ckt.n + 1, None, 128)
    narrow = ops.WindowPlan(True, stride=plan.stride, window=16,
                            n_hbm=plan.n_hbm, num_blocks=plan.num_blocks)
    with pytest.raises(ValueError, match="outside"):
        ops._check_stream(instr, ops._psum_slots(prog), plan.n_hbm, narrow, 128)
