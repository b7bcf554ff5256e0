"""The Hopper kernels on the card; every test here skips without one.

Imports only the port (no jax, no ``repro``), so it runs on a machine
that has a CUDA card and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch twin on the same CUDA
tensors: the SpTRSV kernels bit for bit (neither they nor the twins
contract a product and a sum into an FMA, so both round every operation
alike; rtol/atol 1e-5, as tests/test_blocked.py, is the floor), at P = 8
to 256 lanes, with 1, 2 and 4 columns per CTA and in both word planes,
the blocked kernel on the row words its twin takes, at block lengths of 3
to 128 cycles (the wrapper pads a block to whole 8-cycle chunks), and on
the band archetype's lane-compacted stream, bit for bit the stream as
staged, one ``blocked_kernel`` launch a solve; the
slice end to end against the serial forward substitution; the resident
kernel with x in a slot file (`ops.plan_slots`) at every lane width, both
planes and 1 to 4 columns per CTA, bit for bit the twin on the row stream,
and the slotted, shared and device-memory solves of one program to the same
bits, each counted where due; the solve API's
upper, transpose-pair, circuit and split workloads through both kernels
(and the resident kernel with x in device memory), bit for bit against
the same solve on the plain twins and within 1e-5 of the float64 oracles;
the hardened solve path (a clean robust solve on the expected cuda rung,
an injected fault degrading to the resident rung) and a short service
stream, bit for bit the direct solves; the scan at 2e-4 of the plain
result's largest value (f32, sums in another order; the kernel's 3xTF32
products keep ~f32 accuracy); attention at 2e-5 in f32 (the f32 kernel stays on the CUDA
cores) and 2e-2 of the largest value in bf16 (the kernel rounds P to bf16
for the PV product, as scaled_dot_product_attention does); the reduced
Zamba2 prefill on the kernels against the plain path at 1e-4.  The
families' shapes: attention at the llama-vision cross shape (Lq 1,000,
Lk 1,601, D 128), whisper's one-row decode cross-attention (Lk 1,500) and
its bidirectional encoder (1,500 x 1,500), in f32 and bf16; the exclusive
scan at RWKV6's prefill shape (BH 256, L 1,000, K = V = 64); the column
split over (cuda:0, cuda:0), bit for bit the unsharded solve; and each
family's reduced prefill on the kernels against the plain path at 1e-4,
with its launch counts; one train step of reduced smollm and granite-moe
(f32) on the card against the same step on the CPU (loss at 1e-5).
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings, strategies as st

import dataclasses

from repro_torch.configs import get_config
from repro_torch.core import api
from repro_torch.core.csr import serial_solve
from repro_torch.core.errors import PlacementInfeasibleError
from repro_torch.core.executor import _psum_slots
from repro_torch.core.program import AccelConfig
from repro_torch.core.schedule import compile_program
from repro_torch.kernels.flash_attention.kernel import (
    check_kernel_limits as attn_limits,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.ssd_scan.ops import MIN_LOG_DECAY
from repro_torch.kernels.ssd_scan.kernel import (
    check_kernel_limits as scan_limits,
    chunked_scan_cuda,
    chunked_scan_plain,
)
from repro_torch.kernels.sptrsv import kernel, ops
from repro_torch.models import RuntimeFlags, init_params, prefill

from torch_strategies import accel_config, random_triangular, row_sweep

TOL = dict(rtol=1e-5, atol=1e-5)
EXACT = dict(rtol=0, atol=0)
# each kernel's largest |kernel - twin| / max|twin| over the comparisons run
# in this process (chip_smoke.py step 35 reports it)
WORST = dict.fromkeys(("sptrsv_cuda", "sptrsv_cuda_blocked", "chunked_scan_cuda",
                       "flash_attention_cuda"), 0.0)


def _note(wrapper, got, want):
    if want.numel():
        scale = want.float().abs().max().item() or 1.0
        err = (got.float() - want.float()).abs().max().item() / scale
        WORST[wrapper.__name__] = max(WORST[wrapper.__name__], err)


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


def _check_launch(wrapper, fits, run, want, n):
    """``run()`` matches ``want`` bit for bit when the CTA's shared memory
    fits the 227 KB; otherwise it is refused before or at launch (the
    psum files and stream rings by `check_kernel_limits`, x by the card)
    and counts no launch."""
    before = wrapper.launches
    if not fits:
        with pytest.raises((ValueError, RuntimeError), match="shared memory|launch failed"):
            run()
        assert wrapper.launches == before
        return
    got = run()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    torch.testing.assert_close(got[:n], want[:n], **EXACT)
    _note(wrapper, got[:n], want[:n])


def _fits(prog, cols, x_words):
    return cols * kernel.smem_bytes_per_column(
        prog.num_cus, prog.planes, _psum_slots(prog), x_words) <= kernel.MAX_SMEM_BYTES


def _resident_case(prog, instr, values, b, configs):
    slots = _psum_slots(prog)
    want = kernel.sptrsv_plain(instr, values, b, num_slots=slots)
    for x_in_smem, cols in configs:
        _check_launch(
            kernel.sptrsv_cuda, _fits(prog, cols, b.shape[0] if x_in_smem else 0),
            lambda: kernel.sptrsv_cuda(instr, values, b, num_slots=slots,
                                       x_in_smem=x_in_smem, cols_per_cta=cols),
            want, prog.n)


def _slotted_case(prog, instr, values, b, cols_list):
    """The resident kernel with x in a slot file (`ops.plan_slots`, on the
    stream rewritten to slots) at each columns-per-CTA of ``cols_list``:
    bit for bit the plain twin on the row stream, each launch counted in
    ``.x_slotted`` and not in ``.x_in_device``."""
    p = prog.num_cus
    plan = ops.plan_slots(prog, kernel.stream_lead_chunks(p), instr.shape[0])
    words = torch.from_numpy(plan.words(instr.cpu().numpy())).to(b.device)
    sf = plan.file().to(b.device)
    slots = _psum_slots(prog)
    want = kernel.sptrsv_plain(instr, values, b, num_slots=slots)
    w = kernel.sptrsv_cuda
    for cols in cols_list:
        fits = _fits(prog, cols, kernel.slot_file_words(p, plan.size))
        before = (w.x_slotted, w.x_in_device)
        _check_launch(w, fits, lambda: w(words, values, b, num_slots=slots,
                                         cols_per_cta=cols, x_in_smem=False,
                                         slot_file=sf), want, prog.n)
        assert (w.x_slotted, w.x_in_device) == (before[0] + fits, before[1])


def _blocked_case(prog, cpb, cuda, seed, cols_list):
    plan = ops.plan_window(prog, cpb)
    assert plan.feasible
    instr, values, b = _staged(prog, cpb, plan.n_hbm, 16, seed, cuda)
    kw = dict(window=plan.window, stride=plan.stride, cycles_per_block=cpb,
              num_slots=_psum_slots(prog))
    want = kernel.sptrsv_blocked_plain(instr, values, b, **kw)
    for cols in cols_list:
        _check_launch(
            kernel.sptrsv_cuda_blocked, _fits(prog, cols, plan.x_words()),
            lambda: kernel.sptrsv_cuda_blocked(instr, values, b, cols_per_cta=cols, **kw),
            want, prog.n)


@pytest.mark.cuda
@pytest.mark.parametrize("name,planes", [("ckt_rajat04", 1), ("band_cz", 2)])
def test_resident_kernel_matches_plain(cuda, name, planes):
    prog = compile_program(api.matrix(name), planes=planes)
    instr, values, b = _staged(prog, 128, prog.n + 1, 16, 3, cuda)
    _resident_case(prog, instr, values, b,
                   ((True, 1), (True, 2), (True, 4), (False, 1), (False, 2), (False, 4)))
    _slotted_case(prog, instr, values, b, (1, 2, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("name,cpb,planes", [("band_dw2048", 64, 1), ("band_cz", 32, 2)])
def test_blocked_kernel_matches_plain(cuda, name, cpb, planes):
    prog = compile_program(api.matrix(name), planes=planes)
    _blocked_case(prog, cpb, cuda, 4, (1, 2, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("num_cus", [8, 16])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("name", ["band_cz", "hub_small"])
def test_kernels_at_fewer_than_32_lanes(cuda, num_cus, planes, name):
    """P < 32: one warp per column with the threads past P masked."""
    prog = compile_program(api.matrix(name), AccelConfig(num_cus=num_cus), planes=planes)
    assert prog.num_cus == num_cus
    instr, values, b = _staged(prog, 128, prog.n + 1, 16, num_cus, cuda)
    _resident_case(prog, instr, values, b, ((True, 1), (True, 2), (True, 4), (False, 4)))
    _slotted_case(prog, instr, values, b, (1, 4))
    # 64 cycles a block: 8 stream chunks, past the lead of 4 (blocks shorter
    # than the lead: test_blocked_kernel_at_any_block_length)
    _blocked_case(prog, 64, cuda, num_cus + planes, (1, 2, 4))


def _sweep(prog, cpb, stride):
    """(window, n_hbm) of a sweep of ``stride`` rows per block of ``cpb``
    cycles: `ops.plan_window` without its 8-row alignment, so a block may
    be shorter than one stream chunk."""
    g = -(-prog.cycles // cpb)
    lo = np.full(g * cpb, prog.n, np.int64)
    hi = np.full(g * cpb, -1, np.int64)
    lo[:prog.cycles], hi[:prog.cycles] = prog.row_lo, prog.row_hi
    lo, hi = lo.reshape(g, cpb).min(1), hi.reshape(g, cpb).max(1)
    base = np.arange(g) * stride
    live = hi >= 0
    assert (lo[live] >= base[live]).all()
    window = max(int((hi[live] - base[live]).max()) + 1, 2 * stride)
    return window, (g - 1) * stride + window


@pytest.mark.cuda
@pytest.mark.parametrize("num_cus,name,cpb", [
    (64, "band_dw2048", 12),    # padded to 16 cycles; block < the lead (wait_all)
    (64, "band_dw2048", 16),    # whole chunks, 2 < the lead of 4 (wait_all)
    (64, "band_dw2048", 24),
    (64, "band_dw2048", 100),   # padded to 104 cycles, 13 chunks a block
    (8, "hub_small", 24),       # P < 32, wait_all
    (128, "ckt_rajat04", 12),   # four lanes a thread, lead of 2 chunks (wait_all)
    (128, "band_cz", 100),
    (256, "band_cz", 16),       # eight lanes a thread, 2 chunks = the lead
    (256, "ckt_rajat04", 24),
])
@pytest.mark.parametrize("planes", [1, 2])
def test_blocked_kernel_at_any_block_length(cuda, num_cus, name, cpb, planes):
    """Blocks of any length (one that is not a whole number of 8-cycle
    stream chunks is padded with NOP cycles by the wrapper), blocks shorter
    than the stream's lead (the b prefetch is awaited), P from 8 to 256."""
    prog = compile_program(api.matrix(name), AccelConfig(num_cus=num_cus), planes=planes)
    assert prog.num_cus == num_cus
    _blocked_case(prog, cpb, cuda, cpb + planes, (1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("cpb", [3, 5])
def test_blocked_kernel_with_blocks_shorter_than_a_chunk(cuda, cpb):
    """Blocks of 3 and 5 cycles, each padded to one 8-cycle chunk (a
    sweep of one row per block, which `ops.plan_window` does not plan)."""
    prog = compile_program(api.matrix("chain_1k"))
    window, n_hbm = _sweep(prog, cpb, 1)
    instr, values, b = _staged(prog, cpb, n_hbm, 16, cpb, cuda)
    kw = dict(window=window, stride=1, cycles_per_block=cpb, num_slots=_psum_slots(prog))
    want = kernel.sptrsv_blocked_plain(instr, values, b, **kw)
    for cols in (1, 4):
        _check_launch(kernel.sptrsv_cuda_blocked, True,
                      lambda: kernel.sptrsv_cuda_blocked(instr, values, b, cols_per_cta=cols,
                                                         **kw),
                      want, prog.n)


@pytest.mark.cuda
@pytest.mark.parametrize("num_cus", [128, 256])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("name", ["band_cz", "ckt_rajat04"])
def test_resident_kernel_at_128_and_256_lanes(cuda, num_cus, planes, name):
    """Four and eight lanes a thread (v4 shared loads, 32-byte copies in
    two)."""
    prog = compile_program(api.matrix(name), AccelConfig(num_cus=num_cus), planes=planes)
    assert prog.num_cus == num_cus
    instr, values, b = _staged(prog, 128, prog.n + 1, 16, num_cus + planes, cuda)
    _resident_case(prog, instr, values, b, ((True, 1), (True, 2), (False, 1), (False, 2)))
    _slotted_case(prog, instr, values, b, (1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("cut", [1, 3, 8, 13])
def test_resident_kernel_on_a_stream_cut_off_mid_chunk(cuda, cut):
    """T not a multiple of the 8-cycle stream chunk: the chunk's missing
    cycles are zero words (NOPs)."""
    prog = compile_program(api.matrix("ckt_rajat04"))
    instr, values, b = _staged(prog, 128, prog.n + 1, 16, cut, cuda)
    t = prog.cycles - cut
    _resident_case(prog, instr[:t].contiguous(), values[:t].contiguous(), b,
                   ((True, 1), (False, 2)))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 16])
def test_compacted_blocked_launch_is_bit_identical(cuda, batch):
    """The band archetype's stream lane-compacted from 64 lanes to 32 slots
    (`ops.compact_lanes`): its launch bit for bit the staged stream's
    launch through the same wrapper and the plain twin, counted once in
    ``.compacted``; the blocked solve closure runs it, one device kernel
    named ``blocked_kernel`` a solve, to the same bits."""
    prog = api.compile(api.matrix("band_jagmesh"))
    cpb = 128
    plan = ops.plan_window(prog, cpb)
    instr, values, b = _staged(prog, cpb, plan.n_hbm, batch, 40 + batch, cuda)
    ci, cv, width = ops.compact_lanes(instr.cpu().numpy(), values.cpu().numpy())
    assert (prog.num_cus, width) == (64, 32)
    ci, cv = torch.from_numpy(ci).to(cuda), torch.from_numpy(cv).to(cuda)
    kw = dict(window=plan.window, stride=plan.stride, cycles_per_block=cpb,
              num_slots=_psum_slots(prog))
    want = kernel.sptrsv_blocked_plain(instr, values, b, **kw)
    w = kernel.sptrsv_cuda_blocked
    before = (w.launches, w.compacted)
    full, names = _device_kernels(lambda: w(instr, values, b, **kw), "blocked_kernel")
    assert (w.launches, w.compacted) == (before[0] + 1, before[1])
    assert len(names) == 1
    got, names = _device_kernels(lambda: w(ci, cv, b, program_lanes=64, **kw),
                                  "blocked_kernel")
    assert (w.launches, w.compacted) == (before[0] + 2, before[1] + 1)
    assert len(names) == 1, names
    torch.testing.assert_close(got, full, **EXACT)
    torch.testing.assert_close(got, want, **EXACT)
    _note(w, got[:prog.n], want[:prog.n])

    solver = ops.build_solver_cols(prog, batch, placement="blocked", device=cuda)
    assert solver.lanes == 32
    x, names = _device_kernels(lambda: solver(b[:prog.n]), "blocked_kernel")
    assert (w.launches, w.compacted) == (before[0] + 3, before[1] + 2)
    assert len(names) == 1, names
    torch.testing.assert_close(x, want[:prog.n], **EXACT)
    # a program with a full cycle stays as staged, and counts no compaction
    full_prog = api.compile(api.matrix("ckt_add20"))
    solver = ops.build_solver_cols(full_prog, batch, placement="blocked", device=cuda)
    assert solver.lanes == 64
    _once(w, lambda: solver(torch.zeros((full_prog.n, batch), device=cuda)))
    assert w.compacted == before[1] + 2


@pytest.mark.cuda
def test_kernel_limits_refuse_before_launching(cuda):
    prog = api.compile(api.matrix("band_cz"))
    instr, values, b = _staged(prog, 128, prog.n + 1, 32, 6, cuda)
    plan = ops.plan_window(prog, 64)
    before = (kernel.sptrsv_cuda.launches, kernel.sptrsv_cuda_blocked.launches)
    with pytest.raises(ValueError, match="cols_per_cta"):
        kernel.sptrsv_cuda(instr, values, b, num_slots=_psum_slots(prog), cols_per_cta=32)
    bb = torch.zeros((plan.n_hbm, 8), device=cuda)
    with pytest.raises(ValueError, match="cols_per_cta"):
        kernel.sptrsv_cuda_blocked(instr[:plan.num_blocks * 64].contiguous(),
                                   values[:plan.num_blocks * 64].contiguous(), bb,
                                   window=plan.window, stride=plan.stride,
                                   cycles_per_block=64, num_slots=_psum_slots(prog),
                                   cols_per_cta=9)
    assert (kernel.sptrsv_cuda.launches, kernel.sptrsv_cuda_blocked.launches) == before


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
def test_launch_with_x_in_device_memory_is_counted(cuda):
    """A resident solve whose x does not fit the shared-memory limit, nor
    its slot file, keeps x in device memory and counts its launch in
    ``.x_in_device``; at the default limit the same program's x fits and
    adds nothing there."""
    prog = api.compile(api.matrix("ckt_rajat04"))
    x_bytes = ops.state_bytes(prog, placement="resident")["x"]
    limit = min(x_bytes, _slot_file_bytes(prog)) - 1
    b = np.random.default_rng(24).standard_normal(prog.n).astype(np.float32)
    w = kernel.sptrsv_cuda
    answers = []
    for limit, x_in_smem in ((limit, False), (None, True)):
        solver = api.make_solver(prog, backend="cuda", placement="resident",
                                 smem_limit_bytes=limit)
        assert (solver.x_in_smem, solver.x_slots) == (x_in_smem, 0)
        before = (w.launches, w.x_in_device, w.x_slotted)
        answers.append(solver(b).cpu())
        torch.cuda.synchronize()
        assert (w.launches, w.x_in_device, w.x_slotted) == (
            before[0] + 1, before[1] + (not x_in_smem), before[2])
    torch.testing.assert_close(answers[0], answers[1], **EXACT)


def _slot_file_bytes(prog):
    """Shared memory of one column's warp with x in the program's slot file."""
    p = prog.num_cus
    size = ops.plan_slots(prog, kernel.stream_lead_chunks(p),
                          ops._stage_instructions(prog, 128)[0].shape[0]).size
    return kernel.smem_bytes_per_column(p, prog.planes, _psum_slots(prog),
                                        kernel.slot_file_words(p, size))


def _device_kernels(run, part):
    """``run()`` under the profiler: (its result, the names of the device
    kernels it ran whose name contains ``part``)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    cuda_dev = torch.autograd.DeviceType.CUDA
    return out, [e.name() for e in prof.profiler.kineto_results.events()
                 if e.device_type() == cuda_dev and part in e.name()]


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 5])
def test_slotted_launch_is_counted_and_bit_identical(cuda, batch):
    """A circuit whose x outgrows the limit but whose live rows fit a slot
    file: the solver keeps x in the slot file (``x_slots``), one device
    kernel named ``resident_kernel...`` a solve, counted in ``.x_slotted``
    and not in ``.x_in_device``; its answer bit for bit the shared-memory
    and the device-memory solves' and the CPU twin's."""
    prog = api.compile(api.matrix("ckt_add32"))
    slotted = _slot_file_bytes(prog)
    assert slotted < ops.state_bytes(prog, placement="resident")["total"]
    b = np.random.default_rng(25).standard_normal((prog.n, batch)).astype(np.float32)
    w = kernel.sptrsv_cuda
    answers, sizes = {}, {}
    for name, limit in (("shared", None), ("slots", slotted), ("device", slotted - 1)):
        solver = api.make_solver(prog, batch=batch, backend="cuda", smem_limit_bytes=limit)
        assert (solver.placement, solver.x_in_smem) == ("resident", name == "shared")
        sizes[name] = solver.x_slots
        assert (sizes[name] > 0) == (name == "slots")
        before = (w.launches, w.x_slotted, w.x_in_device)
        answers[name], names = _device_kernels(lambda: solver(b).cpu(), "resident_kernel")
        assert len(names) == 1, names
        assert (w.launches, w.x_slotted, w.x_in_device) == (
            before[0] + 1, before[1] + (name == "slots"), before[2] + (name == "device"))
    twin = api.make_solver(prog, batch=batch, backend="cuda", smem_limit_bytes=slotted,
                           device="cpu")
    assert twin.x_slots == sizes["slots"]
    answers["twin"] = twin(b)
    for name in ("slots", "device", "twin"):
        torch.testing.assert_close(answers[name], answers["shared"], **EXACT)


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


# the solve API's other workloads on the card: placement knobs, the kernel
# they run, and whether x sits in shared memory ("device_x": the resident
# kernel with x in device memory, forced by a 16 KB budget that neither the
# resident x nor a window fits)
WORKLOAD_KNOBS = {
    "resident": (dict(placement="resident"), kernel.sptrsv_cuda, True),
    "blocked": (dict(placement="blocked", cycles_per_block=64),
                kernel.sptrsv_cuda_blocked, True),
    "device_x": (dict(placement="auto", smem_limit_bytes=16 * 1024),
                 kernel.sptrsv_cuda, False),
}


def _workload_on_card(solve, programs, knobs, want):
    """``solve(backend="cuda", **opts)`` on the card launches its kernel
    once per program, bit for bit as on ``device="cpu"`` (the plain twins),
    and within 1e-5 of the float64 oracle ``want``."""
    opts, wrapper, x_in_smem = WORKLOAD_KNOBS[knobs]
    for prog in programs:
        solver = api.make_solver(prog, batch=want.shape[1], backend="cuda", **opts)
        assert (solver.placement, solver.x_in_smem) == (
            "blocked" if knobs == "blocked" else "resident", x_in_smem)
    before = wrapper.launches
    got = solve(backend="cuda", **opts)
    torch.cuda.synchronize()
    assert wrapper.launches == before + len(programs)
    np.testing.assert_array_equal(got, solve(backend="cuda", device="cpu", **opts))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", sorted(WORKLOAD_KNOBS))
def test_upper_on_card(cuda, knobs):
    from repro_torch.core.csr import serial_solve_upper, transpose_upper

    u = transpose_upper(api.matrix("band_dw2048"))
    cw = api.compile_upper(u)
    bmat = np.random.default_rng(20).standard_normal((u.n, 16))
    want = np.stack([serial_solve_upper(u, bmat[:, i]) for i in range(16)], 1)
    _workload_on_card(lambda **kw: cw.solve(bmat, **kw), [cw.program], knobs, want)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", sorted(WORKLOAD_KNOBS))
def test_pair_on_card(cuda, knobs):
    from repro_torch.core.csr import serial_solve_upper, transpose_upper

    mat = api.matrix("band_dw2048")
    pair = api.compile_pair(mat)
    bmat = np.random.default_rng(21).standard_normal((mat.n, 16))
    u = transpose_upper(mat)
    want = np.stack([serial_solve_upper(u, serial_solve(mat, bmat[:, i]))
                     for i in range(16)], 1)
    _workload_on_card(lambda **kw: api.solve_pair(pair, bmat, **kw),
                      [pair.forward.program, pair.backward.program], knobs, want)


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", sorted(WORKLOAD_KNOBS))
def test_circuit_on_card(cuda, knobs):
    from repro_torch.core.frontends import random_circuit

    circ = random_circuit(4096, max_fan_in=6, seed=4096, locality=256)
    cw = api.compile_circuit(circ)
    umat = np.random.default_rng(22).standard_normal((circ.n, 16))
    _workload_on_card(lambda **kw: cw.solve(umat, **kw), [cw.program], knobs,
                      circ.eval(umat))


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", sorted(WORKLOAD_KNOBS))
def test_split_on_card(cuda, knobs):
    mat = api.matrix("hub_small")
    prog, split = api.compile_split(mat, max_indegree=64)
    assert split.n_aux > 0
    bmat = np.random.default_rng(23).standard_normal((mat.n, 16))
    want = np.stack([serial_solve(mat, bmat[:, i]) for i in range(16)], 1)
    _workload_on_card(lambda **kw: api.solve_split(prog, split, bmat, **kw), [prog],
                      knobs, want)


# the hardened solve path and the service on the card: the matrix, the rung
# a clean solve answers on, its kernel, and the incidents it may carry (the
# blocked rung's typed refusal of a program with no window)
ROBUST_CASES = {
    "ckt_add20": ("cuda-blocked", kernel.sptrsv_cuda_blocked, []),
    "ckt_rajat04": ("cuda-resident", kernel.sptrsv_cuda,
                    [("cuda-blocked", "build-failed", "PlacementInfeasibleError")]),
}


def _direct(prog, stage, bmat):
    """The same columns solved directly at ``stage``'s placement."""
    solver = api.make_solver(prog, batch=bmat.shape[1], backend="cuda",
                             placement=stage[len("cuda-"):])
    return solver(bmat).cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(ROBUST_CASES))
def test_robust_solve_on_card(cuda, name):
    """A clean robust solve answers on the expected cuda rung with one launch
    of its kernel, bit for bit the direct solve's, within 1e-5 of serial."""
    stage, wrapper, allowed = ROBUST_CASES[name]
    mat = api.matrix(name)
    prog = api.compile(mat)
    bmat = np.random.default_rng(30).standard_normal((mat.n, 16))
    rs = api.robust_solver(prog, mat, backend="cuda")
    assert rs.device.type == "cuda"
    before = wrapper.launches
    x = rs(bmat)
    assert wrapper.launches == before + 1
    assert rs.last_stage == stage
    assert [(i.stage, i.kind, i.error) for i in rs.last_incidents] == allowed
    np.testing.assert_array_equal(x, _direct(prog, stage, bmat))
    want = np.stack([serial_solve(mat, bmat[:, i]) for i in range(16)], 1)
    np.testing.assert_allclose(x, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.cuda
def test_robust_solve_on_card_degrades_past_an_injected_fault(cuda):
    """An exception in the cuda-blocked closure degrades to cuda-resident,
    with an "exception" incident per attempt, to the resident solve's bits."""
    from repro_torch.core.robust import RobustSolver

    class Faulty(RobustSolver):
        def _solver_for(self, stage, batch):
            fn = super()._solver_for(stage, batch)
            if stage != "cuda-blocked":
                return fn

            def boom(b):
                raise RuntimeError("injected kernel fault")
            return boom

    mat = api.matrix("ckt_add20")
    prog = api.compile(mat)
    bmat = np.random.default_rng(31).standard_normal((mat.n, 4))
    rs = Faulty(prog, mat, backend="cuda", max_retries=1)
    before = kernel.sptrsv_cuda.launches
    x = rs(bmat)
    assert kernel.sptrsv_cuda.launches == before + 1
    assert rs.last_stage == "cuda-resident"
    assert [(i.stage, i.kind, i.attempt) for i in rs.last_incidents] == \
        [("cuda-blocked", "exception", 1), ("cuda-blocked", "exception", 2)]
    np.testing.assert_array_equal(x, _direct(prog, "cuda-resident", bmat))


@pytest.mark.cuda
def test_service_stream_on_card(cuda):
    """A short request stream through a cuda service: every completed column
    bit-identical to a direct one-column solve on the card, one kernel launch
    per flush, no incident."""
    from repro_torch.core.serve import ManualClock

    mats = {name: api.matrix(name) for name in ROBUST_CASES}
    clock = ManualClock()
    svc = api.make_service(mats, backend="cuda", clock=clock, max_batch=8,
                           max_delay=1e-3)
    rng = np.random.default_rng(32)
    wrappers = (kernel.sptrsv_cuda, kernel.sptrsv_cuda_blocked)
    before = sum(w.launches for w in wrappers)
    tickets = []
    for i in range(24):
        name = sorted(mats)[int(rng.integers(2))]
        b = rng.standard_normal((mats[name].n, int(rng.integers(1, 4))))
        tickets.append((svc.submit(name, b), name, b))
        clock.advance(float(rng.choice([1e-4, 2e-3])))
        svc.pump()
    svc.drain()
    torch.cuda.synchronize()
    assert len(svc.incidents) == 0
    assert {f.matrix_id for f in svc.stats.flushes} == set(mats)
    assert sum(w.launches for w in wrappers) - before == svc.stats.flush_count()
    for ticket, name, b in tickets:
        prog = svc.cache.get(mats[name])
        single = api.make_solver(prog, backend="cuda")
        got = ticket.result()
        for j in range(b.shape[1]):
            np.testing.assert_array_equal(got[:, j], single(b[:, j]).cpu().numpy())


def _scaled_close(got, want, frac):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= frac * want.float().abs().max().item(), err


def _scan_close(y, yp, sf, sfp):
    """The scan's output and final state within 2e-4 of the twin's largest
    value (f32, sums in another order)."""
    for got, want in ((y, yp), (sf, sfp)):
        if want.numel():
            _scaled_close(got, want, 2e-4)
        _note(chunked_scan_cuda, got, want)


def _attention_close(o, op):
    """f32 within 2e-5; bf16 within 2e-2 of the twin's largest value (P is
    rounded to bf16 for the PV product)."""
    if o.dtype == torch.float32:
        torch.testing.assert_close(o, op, rtol=2e-5, atol=2e-5)
    else:
        _scaled_close(o, op, 2e-2)
    _note(flash_attention_cuda, o, op)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,seq,kdim,vdim", [
    (3, 128, 32, 48),     # V not a multiple of the 64-column tile
    (2, 200, 64, 128),    # L not a multiple of the 64-row tile
    (16, 1000, 64, 128),  # the serve shape's widths and prompt length
])
@pytest.mark.parametrize("inclusive", [True, False])
def test_scan_kernel_matches_plain(cuda, bh, seq, kdim, vdim, inclusive):
    g = torch.Generator(device=cuda).manual_seed(seq + kdim)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    q, k, v = rnd(bh, seq, kdim), rnd(bh, seq, kdim) * 0.3, rnd(bh, seq, vdim)
    w = -torch.rand((bh, seq, kdim), generator=g, device=cuda) * 0.25
    s0 = rnd(bh, kdim, vdim) * 0.1
    before = chunked_scan_cuda.launches
    y, sf = chunked_scan_cuda(q, k, v, w, s0, inclusive=inclusive)
    torch.cuda.synchronize()
    assert chunked_scan_cuda.launches == before + 1
    yp, sfp = chunked_scan_plain(q, k, v, w, s0, inclusive=inclusive)
    _scan_close(y, yp, sf, sfp)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, d, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(d)
    for lq, lk in ((200, 200), (100, 170)):
        q, k, v = (torch.randn((6, n, d), generator=g, device=cuda).to(dtype)
                   for n in (lq, lk, lk))
        before = flash_attention_cuda.launches
        o = flash_attention_cuda(q, k, v, scale=d ** -0.5, causal=causal)
        torch.cuda.synchronize()
        assert flash_attention_cuda.launches == before + 1 and o.dtype == dtype
        op = flash_attention_plain(q, k, v, scale=d ** -0.5, causal=causal)
        _attention_close(o, op)


def _scan_inputs(cuda, bh, seq, kdim, vdim, w=None):
    g = torch.Generator(device=cuda).manual_seed(seq * 7 + kdim + vdim)
    rnd = lambda *s: torch.randn(s, generator=g, device=cuda)
    q, k, v = rnd(bh, seq, kdim), rnd(bh, seq, kdim) * 0.3, rnd(bh, seq, vdim)
    if w is None:
        w = -torch.rand((bh, seq, kdim), generator=g, device=cuda) * 0.25
    return q, k, v, w, rnd(bh, kdim, vdim) * 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("seq", [64, 63, 65, 1000])   # one tile, ragged, one row over
@pytest.mark.parametrize("kdim", [32, 64])             # K below and at the key width
@pytest.mark.parametrize("vdim", [48, 128, 200])       # V below, at and past 128
@pytest.mark.parametrize("inclusive", [True, False])
def test_scan_tf32x3_kernel_edges(cuda, seq, kdim, vdim, inclusive):
    q, k, v, w, s0 = _scan_inputs(cuda, 4, seq, kdim, vdim)
    before = chunked_scan_cuda.launches
    y, sf = chunked_scan_cuda(q, k, v, w, s0, inclusive=inclusive)
    torch.cuda.synchronize()
    assert chunked_scan_cuda.launches == before + 1
    yp, sfp = chunked_scan_plain(q, k, v, w, s0, inclusive=inclusive)
    _scan_close(y, yp, sf, sfp)


@pytest.mark.cuda
@pytest.mark.parametrize("inclusive", [True, False])
def test_scan_kernel_at_the_decay_clamp_is_finite(cuda, inclusive):
    """w at the clamp over the whole sequence: every factor reaches e^16 at
    the tile's ends, and the result stays finite and matches the twin."""
    bh, seq, kdim, vdim = 4, 1000, 64, 128
    w = torch.full((bh, seq, kdim), MIN_LOG_DECAY, device=cuda)
    q, k, v, w, s0 = _scan_inputs(cuda, bh, seq, kdim, vdim, w)
    y, sf = chunked_scan_cuda(q, k, v, w, s0, inclusive=inclusive)
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    yp, sfp = chunked_scan_plain(q, k, v, w, s0, inclusive=inclusive)
    _scan_close(y, yp, sf, sfp)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80])
@pytest.mark.parametrize("bh,lq,lk,causal", [
    (64, 1000, 1000, True),    # ragged last q and kv tile; 1,024 CTAs, several per SM
    (64, 1000, 1000, False),
    (5, 130, 70, False),       # Lq != Lk
    (5, 100, 170, False),
    (5, 130, 70, True),        # causal keeps c <= row whatever Lk
])
def test_flash_mma_kernel_edges(cuda, d, bh, lq, lk, causal):
    g = torch.Generator(device=cuda).manual_seed(lq + lk + d)
    q, k, v = (torch.randn((bh, n, d), generator=g, device=cuda).to(torch.bfloat16)
               for n in (lq, lk, lk))
    before = flash_attention_cuda.launches
    o = flash_attention_cuda(q, k, v, scale=d ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1 and o.dtype == torch.bfloat16
    _attention_close(o, flash_attention_plain(q, k, v, scale=d ** -0.5, causal=causal))


@pytest.mark.cuda
def test_flash_kernel_rejects_a_width_it_cannot_take(cuda):
    q = torch.zeros((2, 64, 40), device=cuda, dtype=torch.bfloat16)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        flash_attention_cuda(q, q, q, scale=1.0)
    assert flash_attention_cuda.launches == before


@pytest.mark.cuda
def test_reduced_zamba2_prefill_on_kernels_matches_plain(cuda):
    cfg = dataclasses.replace(get_config("zamba2-2.7b").reduced(), n_layers=6)
    model = init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 100)))
    tokens = tokens.to(cuda)
    before = (chunked_scan_cuda.launches, flash_attention_cuda.launches)
    got, _ = prefill(model, tokens, cfg, RuntimeFlags(use_kernels=True))
    assert (chunked_scan_cuda.launches - before[0],
            flash_attention_cuda.launches - before[1]) == (6, 2)
    want, _ = prefill(model, tokens, cfg, RuntimeFlags(use_kernels=False))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("bh,lq,lk,d,causal", [
    (16, 1000, 1601, 128, False),   # llama-vision cross-attention to 1,601 vision tokens
    (64, 1, 1500, 64, False),       # whisper decode: one query row over 1,500 frames
    (16, 1500, 1500, 64, False),    # whisper's bidirectional encoder
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_on_the_families_shapes(cuda, bh, lq, lk, d, causal, dtype):
    g = torch.Generator(device=cuda).manual_seed(lq + lk + d)
    q, k, v = (torch.randn((bh, n, d), generator=g, device=cuda).to(dtype)
               for n in (lq, lk, lk))
    before = flash_attention_cuda.launches
    o = flash_attention_cuda(q, k, v, scale=d ** -0.5, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1 and o.dtype == dtype
    op = flash_attention_plain(q, k, v, scale=d ** -0.5, causal=causal)
    _attention_close(o, op)


@pytest.mark.cuda
def test_scan_kernel_exclusive_at_the_rwkv6_shape(cuda):
    """RWKV6-1.6B's prefill scan: 8 requests x 32 heads, 1,000 tokens, K = V = 64."""
    q, k, v, w, s0 = _scan_inputs(cuda, 256, 1000, 64, 64)
    before = chunked_scan_cuda.launches
    y, sf = chunked_scan_cuda(q, k, v, w, s0, inclusive=False)
    torch.cuda.synchronize()
    assert chunked_scan_cuda.launches == before + 1
    yp, sfp = chunked_scan_plain(q, k, v, w, s0, inclusive=False)
    _scan_close(y, yp, sf, sfp)


@pytest.mark.cuda
@pytest.mark.parametrize("name,placement,cpb", [("band_cz", "blocked", 64),
                                                ("ckt_rajat04", "resident", 128)])
@pytest.mark.parametrize("batch", [1, 5, 16])
def test_sharded_solver_on_card_is_bit_identical(cuda, name, placement, cpb, batch):
    """Two column blocks on the one card: one launch each, the unsharded
    solve's bits at the same placement."""
    from repro_torch.core import shard

    mat = api.matrix(name)
    prog = api.compile(mat)
    b = np.random.default_rng(batch).standard_normal((mat.n, batch)).astype(np.float32)
    knobs = dict(backend="cuda", placement=placement, cycles_per_block=cpb)
    want = api.make_solver(prog, batch=batch, **knobs)(b)
    mesh = shard.batch_mesh(devices=("cuda:0", "cuda:0"))
    solver = shard.make_sharded_solver(prog, batch, mesh, **knobs)
    wrapper = kernel.sptrsv_cuda_blocked if placement == "blocked" else kernel.sptrsv_cuda
    before = wrapper.launches
    got = solver(b)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2 and solver.placement == placement
    assert got.device == torch.device("cuda", 0)
    torch.testing.assert_close(got, want, **EXACT)
    ref = np.stack([serial_solve(mat, b[:, i].astype(np.float64)) for i in range(batch)], 1)
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


FAMILY_LAUNCHES = {  # (scan, attention) per reduced prefill
    "smollm-360m": (0, 4), "granite-moe-1b-a400m": (0, 4), "arctic-480b": (0, 4),
    "rwkv6-1.6b": (4, 0), "whisper-base": (0, 2 + 4 + 4),
    "llama-3.2-vision-11b": (0, 4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FAMILY_LAUNCHES))
def test_reduced_family_prefill_on_kernels_matches_plain(cuda, arch):
    from repro_torch.models import decode_step

    cfg = get_config(arch).reduced()
    model = init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 100))).to(cuda)
    extra = {}
    if cfg.family == "vlm":
        extra["vision"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.vision_tokens, cfg.vision_dim)).astype(np.float32)).to(cuda)
    if cfg.family == "encdec":
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.enc_frames, cfg.d_model)).astype(np.float32)).to(cuda)
    before = (chunked_scan_cuda.launches, flash_attention_cuda.launches)
    got, cache = prefill(model, tokens, cfg, RuntimeFlags(use_kernels=True), extra,
                         pad_to=104)
    assert (chunked_scan_cuda.launches - before[0],
            flash_attention_cuda.launches - before[1]) == FAMILY_LAUNCHES[arch]
    want, _ = prefill(model, tokens, cfg, RuntimeFlags(use_kernels=False), extra)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    before = flash_attention_cuda.launches
    logits, _ = decode_step(model, got[:, -1].argmax(-1, keepdim=True), cache, cfg,
                            RuntimeFlags(use_kernels=True))
    assert torch.isfinite(logits).all()
    # encdec's decode reruns cross-attention through the kernel, one query row
    assert flash_attention_cuda.launches - before == (
        cfg.n_layers if cfg.family == "encdec" else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-1b-a400m"])
def test_train_step_on_card_matches_cpu(cuda, arch):
    """One train step of a reduced f32 config on the card against the same
    step on the CPU, from the same weights: loss within 1e-5 (relative),
    grad norm and learning rate alike, and no kernel launch (training runs
    the plain paths, as the reference's does)."""
    import copy

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adamw_init

    cfg = get_config(arch).reduced()
    cpu = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    gpu = copy.deepcopy(cpu).to(cuda)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 64)))
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, RuntimeFlags(), lr=3e-3, warmup=2, total=10)
    before = (chunked_scan_cuda.launches, flash_attention_cuda.launches)
    got = step(gpu, adamw_init(gpu), {k: v.to(cuda) for k, v in batch.items()})
    assert (chunked_scan_cuda.launches, flash_attention_cuda.launches) == before
    want = step(cpu, adamw_init(cpu), batch)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(want["grad_norm"]),
                               rtol=1e-4)
    assert got["lr"] == want["lr"]
    if cfg.family == "moe":
        assert float(got["aux"]) > 0


# -------------------------------------------------- the reference's random programs
CARD_EXAMPLES = settings(max_examples=40, deadline=None, derandomize=True, database=None,
                         suppress_health_check=[HealthCheck.function_scoped_fixture,
                                                HealthCheck.too_slow])


def _once(wrapper, run):
    """``run()``, which must launch ``wrapper``'s kernel exactly once."""
    before = wrapper.launches
    out = run()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


def _refused(wrapper, run, match):
    before = wrapper.launches
    with pytest.raises(ValueError, match=match):
        run()
    assert wrapper.launches == before


@pytest.mark.cuda
@CARD_EXAMPLES
@given(random_triangular(), accel_config(), st.sampled_from([1, 2]),
       st.sampled_from([1, 7, 128]), st.integers(0, 1000))
def test_random_programs_on_card(cuda, mat, cfg, planes, cpb, bseed):
    """The JAX package's property-test programs (random lower triangles
    under random configs, `torch_strategies`) compiled by the port and
    solved at B = 1, 5, 16: the resident kernel with x in shared and in
    device memory, at every columns-per-CTA the width takes (one it does
    not divide is refused), and the blocked kernel on `row_sweep`'s window,
    each bit for bit its plain twin on the same CUDA tensors and within 1e-5
    of the float64 serial solve, or refused before launching where the
    CTA's shared memory would pass 227 KB (`_check_launch`); the
    forced-blocked solver where `ops.plan_window` plans a window, its
    refusal where it does not."""
    prog = compile_program(mat, cfg, planes=planes)
    n, slots = prog.n, _psum_slots(prog)
    sweep = row_sweep(prog, cpb)
    plan = ops.plan_window(prog, cpb)
    rng = np.random.default_rng(bseed)
    for nb in (1, 5, 16):
        bmat = rng.standard_normal((n, nb)).astype(np.float32)
        want = np.stack([serial_solve(mat, bmat[:, i].astype(np.float64))
                         for i in range(nb)], 1)
        tol = dict(rtol=1e-5, atol=1e-5 * np.abs(want).max())
        cols = [c for c in range(1, kernel.max_cols_per_cta(prog.num_cus) + 1) if nb % c == 0]
        instr, values, b = _staged(prog, cpb, n + 1, nb, 0, cuda)
        b[:n] = torch.from_numpy(bmat).to(cuda)
        twin = kernel.sptrsv_plain(instr, values, b, num_slots=slots)
        np.testing.assert_allclose(twin[:n].cpu().numpy(), want, **tol)
        for x_in_smem in (True, False):
            for c in cols:
                _check_launch(
                    kernel.sptrsv_cuda, _fits(prog, c, n + 1 if x_in_smem else 0),
                    lambda: kernel.sptrsv_cuda(instr, values, b, num_slots=slots,
                                               x_in_smem=x_in_smem, cols_per_cta=c),
                    twin, n)
        _slotted_case(prog, instr, values, b, (cols[0], cols[-1]))
        if nb == 5:
            _refused(kernel.sptrsv_cuda, lambda: kernel.sptrsv_cuda(
                instr, values, b, num_slots=slots, cols_per_cta=2), "must divide")
        if sweep is not None:
            window, stride, n_hbm = sweep
            instr, values, bb = _staged(prog, cpb, n_hbm, nb, 0, cuda)
            bb.zero_()
            bb[:n] = b[:n]
            kw = dict(window=window, stride=stride, cycles_per_block=cpb, num_slots=slots)
            twin = kernel.sptrsv_blocked_plain(instr, values, bb, **kw)
            for c in (cols[0], cols[-1]):
                _check_launch(
                    kernel.sptrsv_cuda_blocked,
                    _fits(prog, c, kernel.ring_rows(window) + stride),
                    lambda: kernel.sptrsv_cuda_blocked(instr, values, bb, cols_per_cta=c,
                                                       **kw),
                    twin, n)
            np.testing.assert_allclose(twin[:n].cpu().numpy(), want, **tol)
        if not plan.feasible:
            with pytest.raises(PlacementInfeasibleError):
                ops.build_solver_cols(prog, nb, placement="blocked",
                                      cycles_per_block=cpb, device=cuda)
            continue
        solver = ops.build_solver_cols(prog, nb, placement="blocked",
                                       cycles_per_block=cpb, device=cuda)
        x = _once(kernel.sptrsv_cuda_blocked, lambda: solver(b[:n]))
        np.testing.assert_allclose(x.cpu().numpy(), want, **tol)


ATTENTION_D = {"float32": [16, 48, 80, 128, 160], "bfloat16": [16, 64, 128, 40]}


@pytest.mark.cuda
@CARD_EXAMPLES
@given(st.sampled_from([1, 63, 64, 65, 333]), st.sampled_from([1, 63, 64, 65, 333]),
       st.booleans(), st.sampled_from(sorted(ATTENTION_D)), st.data())
def test_random_attention_shapes_on_card(cuda, lq, lk, causal, dtype, data):
    """Attention at random Lq, Lk (each 1, 63, 64, 65 or 333), causal or
    not (the reference's convention, c <= row, so against the twin and not
    SDPA), f32 D 16-128 and bf16 D 16-128 at the file's tolerances; a width
    `check_kernel_limits` refuses (f32 D 160, bf16 D 40) raises ValueError
    and launches nothing."""
    d = data.draw(st.sampled_from(ATTENTION_D[dtype]))
    bh = data.draw(st.integers(1, 6))
    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(lq * 1000 + lk + d)
    q, k, v = (torch.randn((bh, n, d), generator=g, device=cuda).to(dt)
               for n in (lq, lk, lk))
    run = lambda: flash_attention_cuda(q, k, v, scale=d ** -0.5, causal=causal)
    try:
        attn_limits(bh, lq, lk, d, dt)
    except ValueError:
        _refused(flash_attention_cuda, run, "takes D")
        return
    o = _once(flash_attention_cuda, run)
    assert o.dtype == dt and o.shape == q.shape
    op = flash_attention_plain(q, k, v, scale=d ** -0.5, causal=causal)
    _attention_close(o, op)


@pytest.mark.cuda
@CARD_EXAMPLES
@given(st.sampled_from([0, 1, 63, 64, 65, 777]), st.sampled_from([4, 32, 64, 80]),
       st.sampled_from([4, 48, 200, 50]), st.booleans(), st.booleans(),
       st.integers(1, 4))
def test_random_scan_shapes_on_card(cuda, seq, kdim, vdim, inclusive, clamped, bh):
    """The scan at random L (0, 1, 63, 64, 65, 777), K (4, 32, 64) and V
    (4, 48, 200), both inclusive forms, w random or at `MIN_LOG_DECAY`
    throughout, at the file's 2e-4 of the largest value; L = 0 returns s0
    and an empty y; K 80 and V 50 are refused (ValueError, no launch)."""
    w = torch.full((bh, seq, kdim), MIN_LOG_DECAY, device=cuda) if clamped else None
    q, k, v, w, s0 = _scan_inputs(cuda, bh, seq, kdim, vdim, w)
    run = lambda: chunked_scan_cuda(q, k, v, w, s0, inclusive=inclusive)
    try:
        scan_limits(bh, seq, kdim, vdim)
    except ValueError:
        _refused(chunked_scan_cuda, run, "the kernel takes")
        return
    y, sf = _once(chunked_scan_cuda, run)
    assert y.shape == (bh, seq, vdim) and sf.shape == s0.shape
    assert torch.isfinite(y).all() and torch.isfinite(sf).all()
    yp, sfp = chunked_scan_plain(q, k, v, w, s0, inclusive=inclusive)
    if seq == 0:
        torch.testing.assert_close(sf, s0, **EXACT)
    _scan_close(y, yp, sf, sfp)
