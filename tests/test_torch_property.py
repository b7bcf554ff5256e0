"""The JAX package's random programs, held against the port on the CPU.

The reference's strategies (`tests/torch_strategies.py`, copies of
`test_sptrsv_property.py`'s and `test_packed_property.py`'s) draw random
lower triangles (n 2-90, density 0-0.5) under random `AccelConfig`s and
random packed fields.  On each: the port's compiler emits the reference's
program bit for bit in both word planes; the port's `execute_numpy` equals
the reference's and its torch executor (CPU) agrees within 1e-5 of the
largest |x|; the kernels' plain twins agree with the Pallas kernels in
interpret mode (rows [:n], the tolerance of tests/test_blocked.py), the
blocked twin on a sweep whose ring wraps where the program allows one; the
slot file's twin bit for bit the resident twin, on a plan that keeps what
the kernel relies on;
pack/decode round trips give the reference's words; random lower
triangles verify clean and get the reference's diagnostics.  Examples are
derandomized, so every run draws the same programs.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

import jax.numpy as jnp

from repro.core import api as ref_api
from repro.core.csr import TriCSR as RefTriCSR
from repro.core.executor import _psum_slots
from repro.core.executor import execute_numpy as ref_execute_numpy
from repro.core.program import AccelConfig as RefAccelConfig
from repro.core.program import decode_instructions as ref_decode
from repro.core.program import pack_instructions as ref_pack
from repro.core.schedule import compile_program as ref_compile_program
from repro.kernels.sptrsv import ops as ref_ops
from repro.kernels.sptrsv.kernel import sptrsv_pallas, sptrsv_pallas_blocked
from repro_torch.core import api
from repro_torch.core.analysis import analyze_program
from repro_torch.core.csr import from_coo
from repro_torch.core.executor import execute_numpy
from repro_torch.core.program import decode_instructions, pack_instructions
from repro_torch.core.schedule import compile_program
from repro_torch.kernels.sptrsv import kernel, ops

from test_torch_analysis import _same_diagnostics
from test_torch_compiler import assert_same_program
from test_torch_sptrsv_kernel import _staged, _t, check_slot_plan
from torch_strategies import accel_config, packed_fields, random_triangular, row_sweep

TOL = dict(rtol=1e-5, atol=1e-5)


def _derandomized(examples):
    return settings(max_examples=examples, deadline=None, derandomize=True,
                    database=None, suppress_health_check=[HealthCheck.too_slow])


def _ref(mat, cfg=None):
    """The reference's TriCSR and AccelConfig of the port's ``mat``, ``cfg``."""
    ref_mat = RefTriCSR(**{f.name: getattr(mat, f.name) for f in dataclasses.fields(mat)})
    return ref_mat, (None if cfg is None else RefAccelConfig(**dataclasses.asdict(cfg)))


@_derandomized(100)
@given(random_triangular(), accel_config(), st.sampled_from([1, 2]))
def test_compiler_matches_reference(mat, cfg, planes):
    ref_mat, ref_cfg = _ref(mat, cfg)
    assert_same_program(compile_program(mat, cfg, planes=planes),
                        ref_compile_program(ref_mat, ref_cfg, planes=planes))


@_derandomized(60)
@given(random_triangular(), accel_config(), st.sampled_from([1, 3]), st.integers(0, 1000))
def test_executors_match_reference(mat, cfg, nb, bseed):
    ref_mat, ref_cfg = _ref(mat, cfg)
    prog = compile_program(mat, cfg)
    bmat = np.random.default_rng(bseed).standard_normal((mat.n, nb))
    want = ref_execute_numpy(ref_compile_program(ref_mat, ref_cfg), bmat)
    np.testing.assert_array_equal(execute_numpy(prog, bmat), want)
    got = api.solve_batch(prog, bmat, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@_derandomized(8)
@given(random_triangular(), accel_config(), st.sampled_from([1, 2]),
       st.sampled_from([1, 7, 128]), st.integers(0, 1000))
def test_twins_match_pallas(mat, cfg, planes, cpb, bseed):
    """Both twins against both Pallas kernels (interpret mode): the resident
    one at any block length, the blocked one on `row_sweep`'s window."""
    ref_mat, ref_cfg = _ref(mat, cfg)
    prog = ref_compile_program(ref_mat, ref_cfg, planes=planes)
    slots = _psum_slots(prog)
    instr, values, b = _staged(prog, cpb, prog.n + 1, 3, bseed)
    want = np.asarray(sptrsv_pallas(jnp.asarray(instr), jnp.asarray(values),
                                    jnp.asarray(b), num_slots=slots,
                                    cycles_per_block=cpb, interpret=True))
    got = kernel.sptrsv_plain(*_t(instr, values, b), num_slots=slots).numpy()
    np.testing.assert_allclose(got[:prog.n], want[:prog.n], **TOL)
    sweep = row_sweep(prog, cpb)
    if sweep is None:
        assert not ref_ops.plan_window(prog, cpb).feasible
        return
    window, stride, n_hbm = sweep
    instr, values, b = _staged(prog, cpb, n_hbm, 3, bseed + 1)
    kw = dict(window=window, stride=stride, cycles_per_block=cpb, num_slots=slots)
    want = np.asarray(sptrsv_pallas_blocked(jnp.asarray(instr), jnp.asarray(values),
                                            jnp.asarray(b), interpret=True, **kw))
    got = kernel.sptrsv_blocked_plain(*_t(instr, values, b), **kw).numpy()
    np.testing.assert_allclose(got[:prog.n], want[:prog.n], **TOL)


@_derandomized(25)
@given(random_triangular(), accel_config(), st.sampled_from([1, 2]),
       st.sampled_from([1, 7, 128]), st.integers(0, 1000))
def test_compacted_stream_matches_the_blocked_twin(mat, cfg, planes, cpb, bseed):
    """Random programs at 64 lanes, staged and lane-compacted where their
    busiest cycle allows (`ops.compact_lanes`): the stream scatters back to
    the staged one word for word, and the blocked wrapper's CPU path on it
    answers bit for bit as the blocked twin on the staged stream."""
    prog = compile_program(mat, dataclasses.replace(cfg, num_cus=64), planes=planes)
    staged = ops._stage_instructions(prog, cpb)
    ci, cv, width = ops.compact_lanes(*staged)
    if width == prog.num_cus:
        assert ci is staged[0] and cv is staged[1]
        return
    for got, want in zip(kernel.expand_lanes(*_t(ci, cv), 64, planes=planes), staged):
        np.testing.assert_array_equal(got.numpy(), want)
    sweep = row_sweep(prog, cpb)
    if sweep is None:
        return
    window, stride, n_hbm = sweep
    b = np.zeros((n_hbm, 3), np.float32)
    b[:prog.n] = np.random.default_rng(bseed).standard_normal((prog.n, 3))
    kw = dict(window=window, stride=stride, cycles_per_block=cpb,
              num_slots=ops._psum_slots(prog))
    got = kernel.sptrsv_cuda_blocked(*_t(ci, cv, b), program_lanes=64, **kw)
    want = kernel.sptrsv_blocked_plain(*_t(*staged, b), **kw)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@_derandomized(25)
@given(random_triangular(), accel_config(), st.sampled_from([1, 2]),
       st.sampled_from([1, 7, 128]), st.integers(0, 1000))
def test_slotted_twin_matches_the_resident_twin(mat, cfg, planes, cpb, bseed):
    """Random programs staged at any block length, x in a slot file
    (`ops.plan_slots`, the lead of the program's lanes): the plan keeps
    what the kernel relies on, and the slot file's twin, on the stream
    rewritten to slots, answers bit for bit as `sptrsv_plain` on the row
    stream."""
    prog = compile_program(mat, cfg, planes=planes)
    instr, values = ops._stage_instructions(prog, cpb)
    plan = ops.plan_slots(prog, kernel.stream_lead_chunks(prog.num_cus), instr.shape[0])
    check_slot_plan(prog, plan)
    b = np.zeros((prog.n + 1, 3), np.float32)
    b[:prog.n] = np.random.default_rng(bseed).standard_normal((prog.n, 3))
    slots = ops._psum_slots(prog)
    want = kernel.sptrsv_plain(*_t(instr, values, b), num_slots=slots)
    got = kernel.sptrsv_slotted_plain(*_t(plan.words(instr), values, b), num_slots=slots,
                                      slot_file=plan.file())
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("seed,cpb", [(0, 2), (1, 7)])
def test_blocked_twin_on_a_wrapping_ring_matches_pallas(seed, cpb):
    """A random program whose sweep runs past its ring (rows reuse slots):
    the blocked twin against the Pallas blocked kernel."""
    rng = np.random.default_rng(seed)
    n = 60
    rows, cols = [], []
    for i in range(1, n):  # a band of width 3: the sweep moves with the rows
        for j in range(max(0, i - 3), i):
            rows.append(i)
            cols.append(j)
    mat = from_coo(n, rows, cols, rng.uniform(-1, 1, len(rows)),
                   rng.uniform(1.0, 2.0, n), name=f"band3_{seed}")
    ref_mat, _ = _ref(mat)
    prog = ref_compile_program(ref_mat)
    window, stride, n_hbm = row_sweep(prog, cpb)
    assert n_hbm > kernel.ring_rows(window)
    instr, values, b = _staged(prog, cpb, n_hbm, 2, seed)
    kw = dict(window=window, stride=stride, cycles_per_block=cpb,
              num_slots=_psum_slots(prog))
    want = np.asarray(sptrsv_pallas_blocked(jnp.asarray(instr), jnp.asarray(values),
                                            jnp.asarray(b), interpret=True, **kw))
    got = kernel.sptrsv_blocked_plain(*_t(instr, values, b), **kw).numpy()
    np.testing.assert_allclose(got[:prog.n], want[:prog.n], **TOL)


@_derandomized(80)
@given(packed_fields())
def test_pack_decode_matches_reference(case):
    planes, fields = case
    words = pack_instructions(*fields, planes=planes)
    want = ref_pack(*fields, planes=planes)
    assert words.dtype == want.dtype and words.shape == want.shape
    np.testing.assert_array_equal(words, want)
    for got, ref, field in zip(decode_instructions(words, planes),
                               ref_decode(want, planes), fields):
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(got, field)


@_derandomized(30)
@given(random_triangular())
def test_random_lower_tri_verifies_clean_with_reference_diagnostics(mat):
    ref_mat, _ = _ref(mat)
    prog = api.compile(mat, verify_ir=True)
    assert analyze_program(prog, lint=False).ok()
    ref_prog = ref_api.compile(ref_mat, verify_ir=True)
    assert_same_program(prog, ref_prog)
    _same_diagnostics(analyze_program(prog).diagnostics,
                      ref_api.analyze_program(ref_prog).diagnostics)
