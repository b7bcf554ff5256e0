"""The kernels' plain versions against the Pallas kernels, and placement.

On the CPU the wrappers run their plain PyTorch versions; these are held
against `sptrsv_pallas` / `sptrsv_pallas_blocked` in interpret mode on the
same staged inputs, at the tolerance of tests/test_blocked.py.  The
kernels themselves are held against the plain versions on the card in
tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as ref_api
from repro.core.executor import _psum_slots
from repro.core.matrices import generate
from repro.core.program import AccelConfig as RefAccelConfig
from repro.core.schedule import compile_program as ref_compile_program
from repro.kernels.sptrsv import ops as ref_ops
from repro.kernels.sptrsv.kernel import sptrsv_pallas, sptrsv_pallas_blocked
from repro_torch.core import api
from repro_torch.core.errors import PlacementInfeasibleError
from repro_torch.core.program import (
    AccelConfig,
    decode_instructions,
    pack_instructions,
    program_from_arrays,
)
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
    ("band_dw2048", 12, 1), ("band_cz", 100, 2),  # blocks of part of a stream chunk
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


@pytest.mark.parametrize("num_cus,planes,cpb", [(8, 1, 64), (16, 2, 64), (4, 1, 128)])
def test_plain_matches_pallas_at_fewer_than_32_lanes(num_cus, planes, cpb):
    """Programs of P < 32 lanes, which the kernels run on one warp with the
    threads past P masked: both twins against both Pallas kernels."""
    ref = ref_compile_program(generate("band_cz"), RefAccelConfig(num_cus=num_cus),
                              planes=planes)
    assert ref.num_cus == num_cus
    slots = _psum_slots(ref)
    instr, values, b = _staged(ref, cpb, ref.n + 1, 3, seed=num_cus)
    want = np.asarray(sptrsv_pallas(jnp.asarray(instr), jnp.asarray(values),
                                    jnp.asarray(b), num_slots=slots,
                                    cycles_per_block=cpb, interpret=True))
    got = kernel.sptrsv_plain(*_t(instr, values, b), num_slots=slots).numpy()
    np.testing.assert_allclose(got[:ref.n], want[:ref.n], **TOL)
    plan = ref_ops.plan_window(ref, cpb)
    assert plan.feasible
    instr, values, b = _staged(ref, cpb, plan.n_hbm, 3, seed=num_cus + 1)
    want = np.asarray(sptrsv_pallas_blocked(
        jnp.asarray(instr), jnp.asarray(values), jnp.asarray(b), window=plan.window,
        stride=plan.stride, cycles_per_block=cpb, num_slots=slots, interpret=True))
    got = kernel.sptrsv_blocked_plain(
        *_t(instr, values, b), window=plan.window, stride=plan.stride,
        cycles_per_block=cpb, num_slots=slots).numpy()
    np.testing.assert_allclose(got[:ref.n], want[:ref.n], **TOL)


@pytest.mark.parametrize("window", [16, 160, 272, 1024, 1025])
def test_blocked_plain_ring_of_power_of_two_rows(window):
    """The ring holds the power of two >= window rows: a window's rows take
    distinct slots, and the sweep over a window that is not a power of two
    (retire, then refill slots that differ from the retired ones) gives the
    same x as the sweep over a ring of exactly ``window`` rows."""
    rows = kernel.ring_rows(window)
    assert rows >= window and rows & (rows - 1) == 0 and rows < 2 * window
    ref = ref_compile_program(generate("band_cz"))
    plan = ref_ops.plan_window(ref, 32, min_window=window)
    instr, values, b = _staged(ref, 32, plan.n_hbm, 2, seed=window)
    slots = _psum_slots(ref)
    kw = dict(window=plan.window, stride=plan.stride, cycles_per_block=32, num_slots=slots)
    got = kernel.sptrsv_blocked_plain(*_t(instr, values, b), **kw).numpy()
    want = kernel.sptrsv_plain(*_t(instr, values, np.concatenate(
        [b[:ref.n], np.zeros((1, 2), np.float32)])), num_slots=slots).numpy()
    np.testing.assert_array_equal(got[:ref.n], want[:ref.n])


def _sweep(ref, cpb):
    """(window, stride) of a sweep of one row per block of ``cpb`` cycles:
    `plan_window` without its 8-row alignment, so blocks may be shorter
    than one 8-cycle stream chunk."""
    g = -(-ref.cycles // cpb)
    lo = np.full(g * cpb, ref.n, np.int64)
    hi = np.full(g * cpb, -1, np.int64)
    lo[:ref.cycles], hi[:ref.cycles] = ref.row_lo, ref.row_hi
    lo, hi = lo.reshape(g, cpb).min(1), hi.reshape(g, cpb).max(1)
    live = hi >= 0
    assert (lo[live] >= np.arange(g)[live]).all()
    return int((hi[live] - np.arange(g)[live]).max()) + 1, 1


@pytest.mark.parametrize("cpb", [3, 5])
def test_blocked_plain_with_blocks_shorter_than_a_chunk(cpb):
    """A sweep of one row per block of 3 or 5 cycles (more than one block
    boundary in an 8-cycle stream chunk): the blocked twin bit-equal to the
    resident twin."""
    ref = ref_compile_program(generate("chain_1k"))
    window, stride = _sweep(ref, cpb)
    n_hbm = (-(-ref.cycles // cpb) - 1) * stride + window
    instr, values, b = _staged(ref, cpb, n_hbm, 3, seed=cpb)
    slots = _psum_slots(ref)
    got = kernel.sptrsv_blocked_plain(*_t(instr, values, b), window=window, stride=stride,
                                      cycles_per_block=cpb, num_slots=slots).numpy()
    want = kernel.sptrsv_plain(*_t(instr, values, np.concatenate(
        [b[:ref.n], np.zeros((1, 3), np.float32)])), num_slots=slots).numpy()
    np.testing.assert_array_equal(got[:ref.n], want[:ref.n])


@pytest.mark.parametrize("name,cpb,planes", [("band_dw2048", 12, 1), ("band_cz", 100, 2),
                                             ("chain_1k", 3, 1)])
def test_blocks_padded_to_whole_stream_chunks(name, cpb, planes):
    """What `sptrsv_cuda_blocked` launches for a block length that is not a
    multiple of the 8-cycle stream chunk: each block padded with NOP cycles,
    which the blocked twin solves to the same x, bit for bit."""
    ref = ref_compile_program(generate(name), planes=planes)
    if cpb < 8:
        window, stride = _sweep(ref, cpb)
    else:
        plan = ref_ops.plan_window(ref, cpb)
        window, stride = plan.window, plan.stride
    n_hbm = (-(-ref.cycles // cpb) - 1) * stride + window
    instr, values, b = _t(*_staged(ref, cpb, n_hbm, 3, seed=cpb))
    kw = dict(window=window, stride=stride, num_slots=_psum_slots(ref))
    pi, pv, cycles = kernel._pad_blocks(instr, values, cpb)
    assert cycles % kernel.STREAM_CHUNK == 0 and cycles - cpb < kernel.STREAM_CHUNK
    assert pi.shape[0] == instr.shape[0] // cpb * cycles
    want = kernel.sptrsv_blocked_plain(instr, values, b, cycles_per_block=cpb, **kw)
    got = kernel.sptrsv_blocked_plain(pi, pv, b, cycles_per_block=cycles, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# lanes, planes, num_slots, cols_per_cta, cycles_per_block -> accepted?
_LIMITS = [
    ((64, 1, 12, 1, 128), None),
    ((64, 1, 12, 4, None), None),
    ((1, 1, 12, 8, None), None),           # P = 1: one lane, 31 threads masked
    ((32, 1, 12, 8, 16), None),
    ((8, 2, 12, 4, 64), None),
    ((48, 1, 12, 4, None), None),          # P even up to 64
    ((256, 2, 12, 1, 8), None),
    ((256, 1, 12, 2, None), None),
    ((0, 1, 12, 1, None), "lanes"),
    ((257, 1, 12, 1, None), "lanes"),
    ((33, 1, 12, 1, None), "lanes"),       # odd P above 32: 4-byte lanes pairs
    ((102, 1, 12, 1, None), "lanes"),      # P % 4 above 64
    ((64, 3, 12, 1, None), "planes"),
    ((64, 1, 0, 1, None), "num_slots"),
    ((64, 1, 257, 1, None), "num_slots"),
    ((64, 1, 12, 0, None), "cols_per_cta"),
    ((32, 1, 12, 9, None), "cols_per_cta"),   # 8 warps at most
    ((64, 1, 12, 9, None), "cols_per_cta"),
    ((128, 1, 12, 5, None), "cols_per_cta"),  # 4 at four lanes per thread
    ((256, 1, 12, 3, None), "cols_per_cta"),  # 2 at eight
    ((64, 1, 256, 4, None), "shared memory"),  # 4 x (64 KB psum + 20 KB ring)
    ((64, 2, 128, 8, None), "shared memory"),  # 8 x (32 KB psum + 30 KB ring)
    ((64, 1, 12, 1, 0), "cycles_per_block"),
    ((64, 1, 12, 1, -8), "cycles_per_block"),
    ((64, 1, 12, 1, 60), None),            # a boundary inside a stream chunk
    ((64, 1, 12, 1, 4), None),             # two boundaries in one chunk
    ((128, 2, 12, 4, 12), None),
]


@pytest.mark.parametrize("args,refused", _LIMITS)
def test_check_kernel_limits(args, refused):
    if refused is None:
        kernel.check_kernel_limits(*args)
    else:
        with pytest.raises(ValueError, match=refused):
            kernel.check_kernel_limits(*args)


@pytest.mark.parametrize("p,lanes,ring", [(1, 1, 40), (32, 1, 40), (33, 2, 40), (64, 2, 40),
                                          (128, 4, 24), (256, 8, 24)])
def test_kernel_shape_rules(p, lanes, ring):
    assert kernel.lanes_per_thread(p) == lanes
    assert kernel.max_cols_per_cta(p) == {1: 8, 2: 8, 4: 4, 8: 2}[lanes]
    assert kernel.stream_ring_cycles(p) == ring
    assert ring % kernel.STREAM_CHUNK == 0
    # the psum file, the stream ring and x rows, all 4-byte words
    assert kernel.smem_bytes_per_column(p, 2, 12, 100) == \
        4 * (12 * 32 * lanes + ring * 3 * 32 * lanes + 100)


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
    # the stream ring: R cycles of one packed word and one value per lane
    assert ops.instr_buffer_bytes(prog) == \
        kernel.stream_ring_cycles(prog.num_cus) * prog.num_cus * 8
    assert resident["stream"] == ops.instr_buffer_bytes(prog)
    # the whole vector fits the default 227 KB budget: resident
    assert ops.resolve_placement(prog, 8) == ("resident", None)
    # just below the resident state: the row window takes over
    limit = resident["total"] - 1
    mode, plan = ops.resolve_placement(prog, 8, smem_limit_bytes=limit,
                                       cycles_per_block=64)
    assert mode == "blocked" and plan.window < prog.n
    blocked = ops.state_bytes(prog, placement="blocked", plan=plan)
    # x: the power-of-two row ring and the staging rows of b
    assert blocked["total"] <= limit
    assert blocked["x"] == (kernel.ring_rows(plan.window) + plan.stride) * 4
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


@pytest.mark.parametrize("name,placement", [("band_cz", "resident"), ("band_cz", "blocked"),
                                            ("ckt_rajat04", "resident")])
@pytest.mark.parametrize("cols", [1, 2, 4])
def test_state_bytes_is_the_kernels_launch(name, placement, cols):
    """`ops.state_bytes` counts what the C entry points ask the launch for:
    per column the psum file, the stream ring and the x rows."""
    prog = port_program(ref_api.compile(generate(name)))
    plan = ops.plan_window(prog, 64) if placement == "blocked" else None
    got = ops.state_bytes(prog, cols, placement=placement, plan=plan)
    x_words = prog.n + 1 if plan is None else plan.x_words()
    assert got["total"] == cols * kernel.smem_bytes_per_column(
        prog.num_cus, prog.planes, ops._psum_slots(prog), x_words)
    assert got["stream"] == cols * ops.instr_buffer_bytes(prog)
    assert got["x"] == cols * x_words * 4


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
    with pytest.raises(ValueError, match="past the x rows"):
        ops._check_stream(ckt_instr, ops._psum_slots(ckt), 100, None, 128)
    stray = ckt_instr.copy()
    stray[5, 0, 3] |= np.int32(-2 ** 31)  # bit 31: past the slot field
    with pytest.raises(ValueError, match="past their packed fields"):
        ops._check_stream(stray, ops._psum_slots(ckt), ckt.n + 1, None, 128)
    narrow = ops.WindowPlan(True, stride=plan.stride, window=16,
                            n_hbm=plan.n_hbm, num_blocks=plan.num_blocks)
    with pytest.raises(ValueError, match="outside"):
        ops._check_stream(instr, ops._psum_slots(prog), plan.n_hbm, narrow, 128)


# ------------------------------------------------------- lane compaction
def _compacted(name, planes=None):
    prog = api.compile(api.matrix(name)) if planes is None else port_program(
        ref_compile_program(generate(name), planes=planes))
    instr, values = ops._stage_instructions(prog, 128)
    return prog, instr, values, ops.compact_lanes(instr, values)


@pytest.mark.parametrize("name,planes", [("band_jagmesh", 1), ("band_cz", 2), ("chem_bp", 1)])
def test_compacted_stream_scatters_back_to_the_padded_stream(name, planes):
    """Each compacted word, put back in the lane it carries, gives the
    staged stream word for word, values too (the lanes left empty hold
    the zero word, as the staged NOP lanes do)."""
    prog, instr, values, (ci, cv, width) = _compacted(name, planes)
    assert prog.planes == planes and width == 32 < prog.num_cus
    assert ci.shape == (instr.shape[0], 2, 32) and cv.shape == (instr.shape[0], 32)
    got_i, got_v = kernel.expand_lanes(*_t(ci, cv), prog.num_cus, planes=planes)
    np.testing.assert_array_equal(got_i.numpy(), instr)
    np.testing.assert_array_equal(got_v.numpy(), values)


def _first_rows_free(k):
    """``k`` rows with no off-diagonal, then a chain of 8: the compiler
    finalizes the ``k`` in one cycle, so the busiest cycle holds ``k``
    live words."""
    from repro_torch.core.csr import from_coo

    n = k + 8
    rows = list(range(k, n))
    return from_coo(n, rows, [r - 1 for r in rows], np.full(len(rows), 0.5),
                    np.full(n, 1.5), name=f"free{k}")


@pytest.mark.parametrize("case,width", [("band_jagmesh", 32), ("free32", 32),
                                        ("free33", 64), ("ckt_add20", 64),
                                        ("band_cz@16", 16)])
def test_compaction_engages_only_below_the_program_lanes(case, width):
    """The smallest of 32, 64, 128 slots that holds the busiest cycle,
    taken only below P: the band archetype and a busiest cycle of exactly
    32 live words go from 64 lanes to 32; 33 live words, a full cycle (the
    circuit) and a program of 16 lanes stay as staged.  The blocked solve
    closure exposes the width as ``lanes``; the resident one stays at P."""
    name, _, cus = case.partition("@")
    mat = _first_rows_free(int(name[4:])) if name.startswith("free") else api.matrix(name)
    prog = api.compile(mat, AccelConfig(num_cus=int(cus)) if cus else None)
    instr, values = ops._stage_instructions(prog, 128)
    got = ops.compact_lanes(instr, values)
    assert got[2] == width
    if width == prog.num_cus:
        assert got[0] is instr and got[1] is values
    assert ops.plan_window(prog, 128).feasible
    core = ops.build_solver_cols(prog, 2, placement="blocked", device="cpu")
    assert core.lanes == width == core.staged[0].shape[2]
    resident = ops.build_solver_cols(prog, 2, placement="resident", device="cpu")
    assert resident.lanes == prog.num_cus


def test_staging_refuses_compacted_lanes_the_kernel_would_index_unchecked():
    """A compacted stream passes `_check_stream` with its lanes; a lane at
    or past P, or one that two live words of a cycle carry, is refused."""
    prog, instr, _, (ci, _, _) = _compacted("band_jagmesh")
    plan = ops.plan_window(prog, 128)
    slots = ops._psum_slots(prog)
    ops._check_stream(ci, slots, plan.n_hbm, plan, 128, lanes=64)
    live = np.argwhere((ci[:, 1] & 0x1F) != 0)
    t, s = live[0]
    past = ci.copy()
    past[t, 1, s] = (past[t, 1, s] & 0x1FFF) | (64 << kernel.LANE_SHIFT)
    with pytest.raises(ValueError, match="lane past"):
        ops._check_stream(past, slots, plan.n_hbm, plan, 128, lanes=64)
    negative = ci.copy()
    negative[t, 1, s] |= np.int32(-2 ** 31)
    with pytest.raises(ValueError, match="lane past"):
        ops._check_stream(negative, slots, plan.n_hbm, plan, 128, lanes=64)
    t2 = next(c for c in range(ci.shape[0]) if ((ci[c, 1] & 0x1F) != 0).sum() >= 2)
    twice = ci.copy()
    s0, s1 = np.nonzero((ci[t2, 1] & 0x1F) != 0)[0][:2]
    twice[t2, 1, s1] = (twice[t2, 1, s1] & 0x1FFF) | (twice[t2, 1, s0] & ~0x1FFF)
    with pytest.raises(ValueError, match="same lane"):
        ops._check_stream(twice, slots, plan.n_hbm, plan, 128, lanes=64)
    # the slot and window checks still see the upper field under the lane
    slot = ci.copy()
    slot[t, 1, s] = (slot[t, 1, s] & ~(0xFF << 5)) | (slots << 5)
    with pytest.raises(ValueError, match="psum slot"):
        ops._check_stream(slot, slots, plan.n_hbm, plan, 128, lanes=64)
    narrow = ops.WindowPlan(True, stride=plan.stride, window=16,
                            n_hbm=plan.n_hbm, num_blocks=plan.num_blocks)
    with pytest.raises(ValueError, match="outside"):
        ops._check_stream(ci, slots, plan.n_hbm, narrow, 128, lanes=64)


@pytest.mark.parametrize("k,cpb", [(32, 2), (31, 3), ("band_jagmesh", 128)])
def test_compacted_cpu_path_equals_the_blocked_twin(k, cpb):
    """The wrapper on CPU tensors, given a compacted stream and the
    program's lanes, answers bit for bit as `sptrsv_blocked_plain` on the
    staged stream, a busiest cycle of exactly 32 live words included; it
    counts no launch."""
    from torch_strategies import row_sweep

    prog = api.compile(api.matrix(k) if isinstance(k, str) else _first_rows_free(k))
    window, stride, n_hbm = row_sweep(prog, cpb)
    instr, values = ops._stage_instructions(prog, cpb)
    ci, cv, width = ops.compact_lanes(instr, values)
    assert width == 32
    b = np.zeros((n_hbm, 3), np.float32)
    b[:prog.n] = np.random.default_rng(cpb).standard_normal((prog.n, 3))
    kw = dict(window=window, stride=stride, cycles_per_block=cpb,
              num_slots=ops._psum_slots(prog))
    before = (kernel.sptrsv_cuda_blocked.launches, kernel.sptrsv_cuda_blocked.compacted)
    got = kernel.sptrsv_cuda_blocked(*_t(ci, cv, b), program_lanes=prog.num_cus, **kw)
    want = kernel.sptrsv_blocked_plain(*_t(instr, values, b), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (kernel.sptrsv_cuda_blocked.launches,
            kernel.sptrsv_cuda_blocked.compacted) == before


# slots, planes, num_slots, cols_per_cta, program lanes -> refused?
@pytest.mark.parametrize("args,refused", [
    ((32, 2, 12, 1, 64), None),
    ((64, 2, 12, 4, 128), None),
    ((128, 2, 12, 2, 256), None),
    ((32, 1, 12, 1, 64), "compacted"),     # one plane: no room for the lane
    ((48, 2, 12, 1, 64), "compacted"),     # not a whole warp row of slots
    ((64, 2, 12, 1, 64), "compacted"),     # no narrower than the program
    ((32, 2, 12, 1, 257), "compacted"),
    ((32, 2, 256, 4, 256), "shared memory"),  # 4 x (a 256 KB psum file)
])
def test_check_kernel_limits_of_a_compacted_stream(args, refused):
    p, planes, slots, cols, lanes = args
    if refused is None:
        kernel.check_kernel_limits(p, planes, slots, cols, 128, lanes=lanes)
    else:
        with pytest.raises(ValueError, match=refused):
            kernel.check_kernel_limits(p, planes, slots, cols, 128, lanes=lanes)
    # psum file [slots][lanes], fb [lanes], a zero word (16-byte padded), ring
    assert kernel.smem_bytes_per_column(32, 2, 12, 100, lanes=64) == \
        4 * (((12 * 64 + 64 + 1 + 3) // 4) * 4 + 40 * 3 * 32 + 100)


# ------------------------------------------------------------- slot file
def _dag_small():
    """The small copy of the benchmark's DAG cell (`perfbench/tests/data/
    dag_circ85k.json`), compiled as the benchmark compiles it."""
    import json
    from pathlib import Path

    from perfbench.builders import dag_circuit

    path = Path(__file__).resolve().parent.parent / "perfbench/tests/data/dag_circ85k.json"
    return dag_circuit.build(json.loads(path.read_text()), 7).compile()


def _slot_case(prog, nb=3, seed=0):
    """The staged stream, its slot plan, b and `sptrsv_plain`'s x."""
    instr, values = ops._stage_instructions(prog, 128)
    plan = ops.plan_slots(prog, kernel.stream_lead_chunks(prog.num_cus), instr.shape[0])
    b = np.zeros((prog.n + 1, nb), np.float32)
    b[:prog.n] = np.random.default_rng(seed).standard_normal((prog.n, nb))
    want = kernel.sptrsv_plain(*_t(instr, values, b), num_slots=ops._psum_slots(prog))
    return instr, values, plan, b, want


def _slotted(prog, instr, values, plan, b):
    return kernel.sptrsv_slotted_plain(*_t(plan.words(instr), values, b),
                                       num_slots=ops._psum_slots(prog), slot_file=plan.file())


def _liveness(prog, chunks):
    """Each row's FINAL chunk and last-read chunk, from the words alone."""
    op, src, _, _ = decode_instructions(prog.instr, prog.planes)
    cyc = np.broadcast_to(np.arange(prog.cycles)[:, None], op.shape)
    final = np.empty(prog.n, np.int64)
    final[src[op == 2]] = cyc[op == 2] // kernel.STREAM_CHUNK
    last = final.copy()
    np.maximum.at(last, src[op == 1], cyc[op == 1] // kernel.STREAM_CHUNK)
    return final, last


def check_slot_plan(prog, plan):
    """What the kernel relies on: b copied in at least ``lead`` chunks
    before the FINAL, x written out at a chunk top after it, a slot held
    through the last read and until its flush, two rows of one slot never
    overlapping, each list within its 32 x SLOT_LIST entries; and S no more
    than the rows live at once (FINAL to last read, by chunk) plus the
    FINALs of ``lead`` chunks."""
    final, last = _liveness(prog, plan.chunks)
    np.testing.assert_array_equal(plan.final, final)
    assert ((plan.refill == -1) | ((plan.refill >= 0) & (plan.refill <= final - plan.lead))).all()
    tail = plan.flush == plan.chunks  # written out after the last chunk
    assert (tail | (plan.flush >= final + kernel.SLOT_FLUSH_LAG)).all()
    assert (plan.flush <= plan.chunks).all()
    assert (plan.release >= last).all() and (plan.release >= plan.flush - 1).all()
    cap = 32 * kernel.SLOT_LIST
    for when in (plan.refill[plan.refill >= 0], plan.flush[plan.flush < plan.chunks]):
        assert np.bincount(when).max(initial=0) <= cap
    assert 0 <= plan.slot.min() and plan.slot.max() < plan.size
    for s in np.unique(plan.slot):
        rows = np.flatnonzero(plan.slot == s)
        rows = rows[np.argsort(plan.refill[rows])]
        assert (plan.refill[rows[1:]] > plan.release[rows[:-1]]).all()
    live = np.zeros(plan.chunks + kernel.SLOT_FLUSH_LAG, np.int64)
    np.add.at(live, final, 1)
    np.add.at(live, np.maximum(last, final + kernel.SLOT_FLUSH_LAG - 1) + 1, -1)
    finals = np.bincount(final, minlength=plan.chunks + plan.lead)
    ahead = np.convolve(finals, np.ones(plan.lead, np.int64))[plan.lead:]
    assert plan.size <= np.cumsum(live).max() + ahead.max()


def test_slotted_twin_matches_plain_on_the_dag_cell():
    """The benchmark DAG's small copy: its slot plan keeps what the kernel
    relies on, and the slot file's twin (refills and flushes at chunk
    granularity, a slot NaN from the refill's issue until its copy lands)
    answers bit for bit as `sptrsv_plain` on the row stream."""
    prog = _dag_small()
    instr, values, plan, b, want = _slot_case(prog)
    check_slot_plan(prog, plan)
    assert plan.size < prog.n
    got = _slotted(prog, instr, values, plan, b)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("shift", [-1, 1])
def test_slotted_twin_fails_on_a_plan_shifted_by_a_chunk(shift):
    """Refills one chunk early take a slot while its last occupant is still
    read (every free slot goes to the row that comes next, so reuse is
    tight); one chunk late, the FINAL reads its slot before the copy lands.
    Either way the twin reads NaN and the answer is not the solve's."""
    prog = _dag_small()
    instr, values, plan, b, want = _slot_case(prog)
    moved = plan.refill >= (1 if shift < 0 else 0)
    bad = dataclasses.replace(plan, refill=np.where(moved, plan.refill + shift, plan.refill))
    got = _slotted(prog, instr, values, bad, b)
    assert torch.isnan(got[:prog.n]).any()


@pytest.mark.parametrize("name", ["ckt_rajat04", "hub_small", "band_cz"])
def test_slotted_twin_matches_plain_on_the_suite(name):
    prog = port_program(ref_api.compile(generate(name)))
    instr, values, plan, b, want = _slot_case(prog, nb=2, seed=3)
    check_slot_plan(prog, plan)
    torch.testing.assert_close(_slotted(prog, instr, values, plan, b), want, rtol=0, atol=0)


def test_a_row_without_one_final_gets_no_slot_plan():
    """A stream in which some row has no FINAL, or two, or an EDGE that
    reads a row before its FINAL, gets no plan (the closure then keeps x in
    device memory)."""
    prog = _dag_small()
    op, src, ct, sl = decode_instructions(prog.instr, prog.planes)
    t, lane = np.argwhere(op == 2)[0]
    for new_op in (0, 1):  # the FINAL dropped, or turned into an EDGE read
        o = op.copy()
        o[t, lane] = new_op
        words = pack_instructions(o, src, ct, sl, planes=prog.planes)
        assert ops.plan_slots(dataclasses.replace(prog, instr=words), 4) is None
    o, s = op.copy(), src.copy()
    t2, lane2 = np.argwhere(op == 2)[-1]
    o[t2, lane2], s[t2, lane2] = 2, src[t, lane]  # a second FINAL of one row
    assert ops.plan_slots(dataclasses.replace(
        prog, instr=pack_instructions(o, s, ct, sl, planes=prog.planes)), 4) is None


def test_placement_order_shared_blocked_slots_device():
    """``auto`` keeps x in shared memory while it fits, then a row window
    where one fits, then a slot file where its slots fit, then device
    memory; each by what fits the limit alone.  The slotted closure answers
    bit for bit as the shared one, on the CPU through the twin."""
    ckt = api.compile(api.matrix("ckt_add32"))
    p, planes, slots = ckt.num_cus, ckt.planes, ops._psum_slots(ckt)
    resident = ops.state_bytes(ckt, placement="resident")["total"]
    size = ops.plan_slots(ckt, kernel.stream_lead_chunks(p),
                          ops._stage_instructions(ckt, 128)[0].shape[0]).size
    slotted = kernel.smem_bytes_per_column(p, planes, slots,
                                           kernel.slot_file_words(p, size))
    assert slotted < resident
    b = np.random.default_rng(1).standard_normal((ckt.n, 4)).astype(np.float32)
    answers = []
    for limit, want in ((None, (True, 0)), (slotted, (False, size)),
                        (slotted - 1, (False, 0))):
        core = ops.build_solver_cols(ckt, 4, smem_limit_bytes=limit, device="cpu")
        assert (core.placement, core.x_in_smem, core.x_slots) == ("resident",) + want
        assert (core.slot_file is None) == (want[1] == 0)
        answers.append(core(torch.from_numpy(b)))
    for got in answers[1:]:
        torch.testing.assert_close(got, answers[0], rtol=0, atol=0)
    # a program with a row window goes blocked before it takes a slot file
    band = api.compile(api.matrix("band_wide4k"))
    limit = ops.state_bytes(band, placement="resident")["total"] - 1
    core = ops.build_solver_cols(band, 4, smem_limit_bytes=limit, device="cpu")
    assert (core.placement, core.x_slots) == ("blocked", 0)
    core = ops.build_solver_cols(band, 4, placement="resident", smem_limit_bytes=limit,
                                 device="cpu")
    assert (core.placement, core.x_in_smem) == ("resident", False) and core.x_slots > 0


def test_staging_refuses_slot_entries_past_the_file():
    """The staging check of a slot file: the plan's lists pass; an entry
    naming a slot past the file, or a row past x, is refused."""
    prog = _dag_small()
    _, _, plan, _, _ = _slot_case(prog)
    sf = plan.file()
    ops._check_slot_lists(sf, prog.n + 1)
    lists = sf.lists.clone()
    e = torch.nonzero(lists[..., 1] >= 0)[0].tolist()
    for k, bad in ((0, plan.size), (1, prog.n + 1)):
        wrong = lists.clone()
        wrong[tuple(e) + (k,)] = bad
        with pytest.raises(ValueError, match="slot file entry"):
            ops._check_slot_lists(dataclasses.replace(sf, lists=wrong), prog.n + 1)
    with pytest.raises(ValueError, match="slot file entry"):
        ops._check_slot_lists(dataclasses.replace(sf, size=int(plan.slot.max())), prog.n + 1)


def test_slot_file_layout_is_the_kernels():
    """The lists as the kernel reads them: [chunk][refill, flush][thread]
    [SLOT_LIST] (slot, row) pairs, entry e of a list at thread e % 32,
    unused entries row -1; the prologue and tail pairs; the shared words
    of a warp (`slot_file_words`); the wrapper's CPU path runs the twin
    and counts no launch."""
    prog = _dag_small()
    instr, values, plan, b, want = _slot_case(prog)
    sf = plan.file()
    assert tuple(sf.lists.shape) == (plan.chunks, 2, 32, kernel.SLOT_LIST, 2)
    assert sf.lists.dtype == sf.prologue.dtype == sf.tail.dtype == torch.int32
    lists = sf.lists.numpy()
    for k, when in enumerate((plan.refill, plan.flush)):
        for c in range(plan.chunks):
            flat = lists[c, k].transpose(1, 0, 2).reshape(-1, 2)  # entry order
            used = flat[flat[:, 1] >= 0]
            rows = np.flatnonzero(when == c)
            assert sorted(used[:, 1]) == sorted(rows)
            np.testing.assert_array_equal(used[:, 0], plan.slot[used[:, 1]])
            assert (flat[len(used):, 1] == -1).all()
    pro, tail = sf.prologue.numpy(), sf.tail.numpy()
    assert sorted(pro[:, 1]) == sorted(np.flatnonzero(plan.refill < 0))
    assert sorted(tail[:, 1]) == sorted(np.flatnonzero(plan.flush == plan.chunks))
    lead = kernel.stream_lead_chunks(prog.num_cus)
    # the list ring holds the chunks from this one to LEAD ahead
    assert kernel.slot_file_words(prog.num_cus, 5) == \
        (lead + 1) * 2 * 32 * kernel.SLOT_LIST * 2 + 8
    # what the card's launch checks of the tensors it passes
    tb = torch.from_numpy(b)
    kernel._check_slot_file(sf, instr.shape[0], tb)
    for bad in (dataclasses.replace(sf, lists=sf.lists[1:].contiguous()),
                dataclasses.replace(sf, tail=sf.tail.long()),
                dataclasses.replace(sf, size=0)):
        with pytest.raises(ValueError, match="slot"):
            kernel._check_slot_file(bad, instr.shape[0], tb)
    before = (kernel.sptrsv_cuda.launches, kernel.sptrsv_cuda.x_slotted)
    got = kernel.sptrsv_cuda(*_t(plan.words(instr), values, b),
                             num_slots=ops._psum_slots(prog), x_in_smem=False,
                             slot_file=sf)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (kernel.sptrsv_cuda.launches, kernel.sptrsv_cuda.x_slotted) == before


def test_slot_file_with_x_in_shared_memory_is_refused():
    """A slot file and ``x_in_smem=True`` name two places for x: the
    wrapper refuses the pair, on the CPU as on the card, and counts
    nothing."""
    prog = _dag_small()
    instr, values, plan, b, _ = _slot_case(prog)
    before = (kernel.sptrsv_cuda.launches, kernel.sptrsv_cuda.x_slotted,
              kernel.sptrsv_cuda.x_in_device)
    with pytest.raises(ValueError, match="x_in_smem=False"):
        kernel.sptrsv_cuda(*_t(plan.words(instr), values, b),
                           num_slots=ops._psum_slots(prog), slot_file=plan.file())
    assert (kernel.sptrsv_cuda.launches, kernel.sptrsv_cuda.x_slotted,
            kernel.sptrsv_cuda.x_in_device) == before
