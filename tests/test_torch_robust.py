"""The port's hardened solve path against the JAX package's.

Twins tests/test_robust.py: `verify_program` (clean on every frontend's
output; each structural invariant violated in isolation is caught with the
reference's message and diagnostic code), the exception taxonomy, the
backend-dispatch rejections, CSR validation, and the `RobustSolver` ladder
— every scenario runs in both packages on the same seeded inputs, with the
rungs renamed (`RUNG`): the incident trails, stages and messages equal,
the answers within 1e-5 of each other (the torch rung against the jax
rung, both float32) and bit-equal on the numpy and reference rungs.  The
fault-injection harnesses give the reference's result per trial.

Beyond the twins: a closure that returns a device tensor (one that refuses
``np.asarray``, as a CUDA tensor does) passes the ladder without an
incident, and a machine without CUDA raises when a solver is constructed.
All on the CPU: ``device="cpu"``, the cuda rungs on the kernels' plain
versions.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import errors as ref_errors
from repro.core import robust as ref_robust
from repro.core.csr import from_coo as ref_from_coo
from repro.core.executor import _psum_slots as ref_psum_slots
from repro.core.frontends.dagcirc import random_circuit as ref_random_circuit
from repro.core.program import decode_instructions as ref_decode
from repro.core.program import pack_instructions as ref_pack
from repro_torch.core import api, errors, robust
from repro_torch.core.csr import TriCSR, from_coo, random_rhs, serial_solve, transpose_upper
from repro_torch.core.executor import _psum_slots
from repro_torch.core.frontends.dagcirc import random_circuit
from repro_torch.core.program import (
    PS_LOAD,
    PS_STORE_RESET,
    PS_SWAP,
    decode_instructions,
    pack_instructions,
)
from repro_torch.core.robust import (
    FAULT_CLASSES,
    IR_FAULT_CLASSES,
    LADDER,
    FaultInjector,
    RobustSolver,
    relative_residual,
    run_fault_injection,
    run_ir_fault_injection,
    verify_program,
)
from repro_torch.kernels.sptrsv import ops

TOL = dict(rtol=1e-5, atol=1e-5)  # the torch and jax rungs compute in float32
CPU = dict(device="cpu")
# the JAX package's rung -> the port's
RUNG = {"pallas-blocked": "cuda-blocked", "pallas-resident": "cuda-resident",
        "jax": "torch", "numpy": "numpy", "reference": "reference"}
BACKEND = {"pallas": "cuda", "jax": "torch", "numpy": "numpy"}

# one namespace per package, so a scenario runs unchanged in both
REF = dict(api=ref_api, robust=ref_robust, decode=ref_decode, pack=ref_pack,
           psum_slots=ref_psum_slots, errors=ref_errors, rung=lambda s: s,
           backend=lambda b: b, opts={})
PORT = dict(api=api, robust=robust, decode=decode_instructions,
            pack=pack_instructions, psum_slots=_psum_slots, errors=errors,
            rung=RUNG.get, backend=BACKEND.get, opts=CPU)


def _pair(name):
    mat, ref_mat = api.matrix(name), ref_api.matrix(name)
    return {"port": (mat, api.compile(mat)), "ref": (ref_mat, ref_api.compile(ref_mat))}


@pytest.fixture(scope="module")
def band():
    return _pair("band_cz")


@pytest.fixture(scope="module")
def ckt():
    return _pair("ckt_rajat04")  # psum-heavy, blocked-infeasible


def _both(pair, fn):
    """``fn(pkg, mat, prog)`` in the port and in the reference."""
    return fn(PORT, *pair["port"]), fn(REF, *pair["ref"])


def _trail(incidents, rung=lambda s: s):
    return [(rung(i.stage), i.kind, i.error, i.attempt) for i in incidents]


def _repack(pkg, prog, op, src, ctl, slot):
    return dataclasses.replace(
        prog, instr=pkg["pack"](op, src, ctl, slot, planes=prog.planes))


# ===================================================== verify_program: clean
def test_verify_clean_on_lower(band, ckt):
    for pair in (band, ckt):
        for pkg in ("port", "ref"):
            (REF if pkg == "ref" else PORT)["robust"].verify_program(pair[pkg][1])


def test_verify_clean_on_upper_and_circuit(band):
    mat = band["port"][0]
    verify_program(api.compile_upper(transpose_upper(mat)).program)
    verify_program(api.compile_circuit(random_circuit(160, max_fan_in=5, seed=4,
                                                      locality=48)).program)
    ref_robust.verify_program(ref_api.compile_circuit(
        ref_random_circuit(160, max_fan_in=5, seed=4, locality=48)).program)


# ============================================ verify_program: each invariant
def _nonfinite_stream(pkg, prog):
    return pkg["robust"].FaultInjector(0).corrupt_stream(prog, k=2, mode="nan")


def _val_idx_oob(pkg, prog):
    bad = dataclasses.replace(prog, val_idx=prog.val_idx.copy())
    bad.val_idx[3, 0] = bad.stream.size + 7
    return bad


def _nonzero_nop_lane(pkg, prog):
    op, src, ctl, slot = pkg["decode"](prog.instr, prog.planes)
    t, p = np.argwhere(op == 0)[0]
    src = src.copy()
    src[t, p] = 1
    return _repack(pkg, prog, op, src, ctl, slot)


def _src_beyond_n(pkg, prog):
    op, src, ctl, slot = pkg["decode"](prog.instr, prog.planes)
    t, p = np.argwhere(op != 0)[0]
    src = src.copy()
    src[t, p] = prog.n + 5
    return dataclasses.replace(_repack(pkg, prog, op, src, ctl, slot),
                               row_lo=None, row_hi=None)


def _duplicate_final(pkg, prog):
    op, src, ctl, slot = pkg["decode"](prog.instr, prog.planes)
    (t0, p0), (t1, p1) = np.argwhere(op == 2)[:2]
    src = src.copy()
    src[t1, p1] = src[t0, p0]
    return dataclasses.replace(_repack(pkg, prog, op, src, ctl, slot),
                               row_lo=None, row_hi=None)


def _dependency_order(pkg, prog):
    return dataclasses.replace(
        prog, instr=prog.instr[::-1].copy(), val_idx=prog.val_idx[::-1].copy(),
        row_lo=prog.row_lo[::-1].copy(), row_hi=prog.row_hi[::-1].copy())


def _zero_final_reciprocal(pkg, prog):
    op = pkg["decode"](prog.instr, prog.planes)[0]
    t, p = np.argwhere(op == 2)[0]
    bad = dataclasses.replace(prog, stream=prog.stream.copy())
    bad.stream[prog.val_idx[t, p]] = 0.0
    return bad


def _load_before_store(pkg, prog):
    op, src, ctl, slot = pkg["decode"](prog.instr, prog.planes)
    nslots = pkg["psum_slots"](prog)
    store = (ctl == PS_STORE_RESET) | (ctl == PS_SWAP)
    for t, p in np.argwhere((op != 0) & (ctl == 0)):
        stored = set(slot[:t, p][store[:t, p]].tolist())
        s = next((s for s in range(nslots) if s not in stored), None)
        if s is not None:
            break
    ctl, slot = ctl.copy(), slot.copy()
    ctl[t, p], slot[t, p] = PS_LOAD, s
    return _repack(pkg, prog, op, src, ctl, slot)


def _slot_beyond_register_file(pkg, prog):
    return pkg["robust"].FaultInjector(1).corrupt_slots(prog, k=4)


def _stale_row_envelope(pkg, prog):
    bad = dataclasses.replace(prog, row_lo=prog.row_lo.copy())
    bad.row_lo[int(np.argmax(prog.row_hi >= 0))] += 1
    return bad


@pytest.mark.parametrize("mutate,matrix,match", [
    (_nonfinite_stream, "band", "non-finite"),
    (_val_idx_oob, "band", "bounds"),
    (_nonzero_nop_lane, "band", "NOP lane"),
    (_src_beyond_n, "band", "reads row"),
    (_duplicate_final, "band", "finalized"),
    (_dependency_order, "band", "dependency order"),
    (_zero_final_reciprocal, "band", "zero diagonal"),
    (_load_before_store, "ckt", "psum lifetime"),
    (_slot_beyond_register_file, "ckt", None),  # range or lifetime
    (_stale_row_envelope, "band", "row-envelope"),
], ids=lambda v: getattr(v, "__name__", None) if callable(v) else None)
def test_verify_rejects_like_the_reference(request, mutate, matrix, match):
    pair = request.getfixturevalue(matrix)
    errs = []
    for pkg, key in ((PORT, "port"), (REF, "ref")):
        with pytest.raises(pkg["errors"].ProgramCorruptionError, match=match) as ei:
            pkg["robust"].verify_program(mutate(pkg, pair[key][1]))
        errs.append((str(ei.value), ei.value.detail))
    assert errs[0] == errs[1]


# =========================================================== error taxonomy
@pytest.mark.parametrize("leaf,builtin", [
    ("ProgramCorruptionError", ValueError),
    ("MatrixValidationError", ValueError),
    ("NumericalHealthError", ValueError),
    ("BackendExecutionError", RuntimeError),
    ("UnknownBackendError", ValueError),
    ("BackendOptionsError", TypeError),
    ("PlacementInfeasibleError", ValueError),
])
def test_taxonomy_keeps_historical_builtin(leaf, builtin):
    err = getattr(errors, leaf)("boom", detail={"k": 1})
    assert isinstance(err, errors.RobustnessError) and isinstance(err, builtin)
    assert err.detail == {"k": 1}
    assert [c.__name__ for c in type(err).__mro__] == \
        [c.__name__ for c in getattr(ref_errors, leaf).__mro__]


def test_taxonomy_hierarchy():
    for leaf in ("UnknownBackendError", "BackendOptionsError", "PlacementInfeasibleError"):
        assert issubclass(getattr(errors, leaf), errors.BackendExecutionError)


# ============================================== backend dispatch rejections
def test_unknown_backend_rejected(band):
    mat, prog = band["port"]
    b = random_rhs(mat, seed=0)
    with pytest.raises(errors.UnknownBackendError, match="bogus"):
        api.solve_batch(prog, np.stack([b, b], 1), backend="bogus")


def test_torch_backend_rejects_cuda_options(band):
    mat, prog = band["port"]
    b = random_rhs(mat, seed=0)
    with pytest.raises(errors.BackendOptionsError, match="cycles_per_block"):
        api.solve_batch(prog, np.stack([b, b], 1), backend="torch",
                        cycles_per_block=64)


def test_infeasible_blocked_placement_rejected(ckt):
    with pytest.raises(errors.PlacementInfeasibleError, match="infeasible"):
        ops.resolve_placement(ckt["port"][1], 8, placement="blocked")


def test_robust_solver_rejects_unknown_backend(band):
    for pkg, key in ((PORT, "port"), (REF, "ref")):
        with pytest.raises(pkg["errors"].UnknownBackendError, match="bogus"):
            pkg["robust"].RobustSolver(band[key][1], band[key][0], backend="bogus")


# ========================================================== CSR validation
def _lower(from_coo_, n=6, seed=0):
    rng = np.random.default_rng(seed)
    return from_coo_(n, list(range(1, n)), [0] * (n - 1), rng.standard_normal(n - 1),
                     rng.standard_normal(n) + 3.0, name="probe")


def test_csr_zero_diagonal_named():
    msgs = []
    for fc, err in ((from_coo, errors), (ref_from_coo, ref_errors)):
        mat = _lower(fc)
        mat.values[mat.rowptr[3] - 1] = 0.0
        with pytest.raises(err.MatrixValidationError, match=r"'probe', row 2.*zero") as ei:
            mat.validate()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("rowptr,colidx,name,match", [
    ([0, 2, 3], [1, 0, 1], "sup", r"'sup'.*super-diagonal"),
    ([0, 1, 1], [0], "gap", r"'gap', row 1.*missing"),
    ([0, 1, 3], [0, 1, 0], "pos", r"'pos'.*stored last"),
    ([0, 1, 2, 5], [0, 1, 1, 0, 2], "uns", r"'uns', row 2.*unsorted"),
])
def test_csr_layout_violation_named(rowptr, colidx, name, match):
    bad = TriCSR(n=len(rowptr) - 1, rowptr=np.array(rowptr), colidx=np.array(colidx),
                 values=np.ones(len(colidx)), name=name)
    with pytest.raises(errors.MatrixValidationError, match=match):
        bad.validate()


def test_from_coo_rejects_diagonal_entry():
    with pytest.raises(errors.MatrixValidationError, match="strictly lower"):
        from_coo(3, [1, 2], [1, 0], [1.0, 1.0], np.ones(3), name="coo")


def test_csr_validation_survives_optimized_mode():
    """The structured checks are not ``assert``s: alive under python -O."""
    code = (
        "import sys; sys.path.insert(0, 'src'); sys.modules['jax'] = None\n"
        "import numpy as np\n"
        "from repro_torch.core.csr import TriCSR\n"
        "from repro_torch.core.errors import MatrixValidationError\n"
        "bad = TriCSR(n=2, rowptr=np.array([0, 1, 1]),\n"
        "             colidx=np.array([0]), values=np.ones(1), name='opt')\n"
        "try:\n"
        "    bad.validate()\n"
        "except MatrixValidationError as e:\n"
        "    assert 'opt' in str(e); print('CAUGHT')\n"
    )
    out = subprocess.run([sys.executable, "-O", "-c", code], capture_output=True,
                         text=True, cwd=os.path.join(os.path.dirname(__file__), ".."),
                         timeout=120)
    assert out.returncode == 0 and "CAUGHT" in out.stdout, out.stderr


# ======================================================= RobustSolver: happy
def test_rung_names_map_onto_the_reference_ladder():
    assert LADDER == tuple(RUNG[s] for s in ref_robust.LADDER)
    assert robust._ENTRY == {"cuda": 0, "torch": 2, "numpy": 3}
    assert robust._ENTRY == {BACKEND[k]: v for k, v in ref_robust._ENTRY.items()}


def test_robust_solve_matches_reference(band):
    b = random_rhs(band["port"][0], seed=7)
    B = np.stack([random_rhs(band["port"][0], seed=s) for s in range(3)], axis=1)

    def run(pkg, mat, prog):
        rs = pkg["api"].robust_solver(prog, mat, backend=pkg["backend"]("jax"), **pkg["opts"])
        x, X = rs(b), rs.solve(B)
        assert rs.last_incidents == [] and pkg["rung"]("jax") == rs.last_stage
        assert X.shape == (mat.n, 3) and relative_residual(mat, X, B) < 1e-5
        return np.asarray(x), np.asarray(X)

    (x, X), (rx, rX) = _both(band, run)
    assert x.dtype == rx.dtype == np.float32
    np.testing.assert_allclose(x, serial_solve(band["port"][0], b), **TOL)
    np.testing.assert_allclose(x, rx, **TOL)
    np.testing.assert_allclose(X, rX, **TOL)


def test_ladder_entry_rungs(band):
    mat, prog = band["port"]
    ref_mat, ref_prog = band["ref"]
    for backend in ("pallas", "jax", "numpy"):
        for m, rm in ((mat, ref_mat), (None, None)):
            port = RobustSolver(prog, m, backend=BACKEND[backend], **CPU).ladder
            ref = ref_robust.RobustSolver(ref_prog, rm, backend=backend).ladder
            assert port == tuple(RUNG[s] for s in ref)
    assert RobustSolver(prog, mat, backend="cuda", **CPU).ladder == LADDER


@pytest.mark.parametrize("stage", ["pallas-blocked", "pallas-resident", "jax", "numpy",
                                   "reference"])
def test_every_forced_stage_matches_the_reference(band, stage):
    """Each rung alone returns the oracle's answer in both packages, the
    cuda rungs on the kernels' plain versions against Pallas interpret."""
    b = random_rhs(band["port"][0], seed=11)
    x = RobustSolver(band["port"][1], band["port"][0], ladder=(RUNG[stage],), **CPU)
    ref_opts = {"interpret": True} if stage.startswith("pallas") else {}
    rx = ref_robust.RobustSolver(band["ref"][1], band["ref"][0], ladder=(stage,),
                                 **ref_opts)
    got, want = x(b), np.asarray(rx(b))
    assert (x.last_stage, x.last_incidents) == (RUNG[stage], [])
    np.testing.assert_allclose(got, serial_solve(band["port"][0], b), **TOL)
    if stage in ("numpy", "reference"):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


# ================================================= RobustSolver: degradation
def test_build_failure_degrades_with_incident(ckt):
    """An infeasible blocked placement degrades; the incident names it."""
    b = random_rhs(ckt["port"][0], seed=2)

    def run(pkg, mat, prog):
        rs = pkg["robust"].RobustSolver(
            prog, mat, ladder=(pkg["rung"]("pallas-blocked"), pkg["rung"]("jax")),
            **pkg["opts"])
        x = rs(b)
        (inc,) = [i for i in rs.last_incidents if i.stage == pkg["rung"]("pallas-blocked")]
        assert inc.kind == "build-failed" and "infeasible" in inc.message
        first = (rs.last_stage, _trail(rs.last_incidents))
        rs.solve(b)  # rung stays disabled: no repeated build attempt
        assert rs.last_incidents == []
        return x, first

    (x, (stage, trail)), (rx, (rstage, rtrail)) = _both(ckt, run)
    assert (stage, trail) == (RUNG[rstage], _trail_renamed(rtrail))
    assert trail == [("cuda-blocked", "build-failed", "PlacementInfeasibleError", 1)]
    np.testing.assert_allclose(x, serial_solve(ckt["port"][0], b), **TOL)
    np.testing.assert_allclose(x, np.asarray(rx), **TOL)


def _trail_renamed(trail):
    return [(RUNG.get(s, s), *rest) for s, *rest in trail]


def test_corrupt_program_degrades_to_reference(band):
    """Value-plane damage fails the residual on every program rung; the
    reference rung still returns the *correct* x, the reference's bits."""
    b = random_rhs(band["port"][0], seed=5)

    def run(pkg, mat, prog):
        bad = pkg["robust"].FaultInjector(3).corrupt_stream(prog, k=3, mode="scale")
        rs = pkg["robust"].RobustSolver(bad, mat, verify=False, ladder=tuple(
            pkg["rung"](s) for s in ("jax", "numpy", "reference")), **pkg["opts"])
        return np.asarray(rs(b)), rs.last_stage, _trail(rs.last_incidents), \
            [i.message for i in rs.last_incidents]

    (x, stage, trail, msgs), (rx, rstage, rtrail, rmsgs) = _both(band, run)
    assert stage == "reference" == rstage
    assert trail == [("torch", "residual", "", 1), ("numpy", "residual", "", 1)]
    assert trail == _trail_renamed(rtrail)
    assert msgs[1] == rmsgs[1]  # the numpy rung's residual, to the digit
    np.testing.assert_array_equal(x, rx)
    np.testing.assert_allclose(x, serial_solve(band["port"][0], b), **TOL)


def test_exhausted_ladder_raises_with_incident_trail(band):
    b = random_rhs(band["port"][0], seed=5)
    for pkg, key in ((PORT, "port"), (REF, "ref")):
        mat, prog = band[key]
        bad = pkg["robust"].FaultInjector(3).corrupt_stream(prog, k=3, mode="scale")
        rs = pkg["robust"].RobustSolver(bad, mat, verify=False, ladder=(
            pkg["rung"]("jax"), "numpy"), **pkg["opts"])
        with pytest.raises(pkg["errors"].NumericalHealthError,
                           match="all ladder stages") as ei:
            rs.solve(b)
        assert [t["kind"] for t in ei.value.detail["incidents"]] == ["residual"] * 2


def test_stage_deadline_disables_rung(band):
    b = random_rhs(band["port"][0], seed=9)

    def run(pkg, mat, prog):
        ticks = iter([0.0, 10.0, 10.0, 10.1, 20.0, 20.1])
        rs = pkg["robust"].RobustSolver(prog, mat, stage_deadline_s=1.0,
                                        clock=lambda: next(ticks),
                                        ladder=(pkg["rung"]("jax"), "numpy"), **pkg["opts"])
        x = rs(b)
        first = (rs.last_stage, [(i.kind, i.elapsed_s) for i in rs.last_incidents])
        rs.solve(b)  # the first rung now persistently disabled
        return x, first, (rs.last_stage, rs.last_incidents)

    (x, first, second), (rx, rfirst, rsecond) = _both(band, run)
    assert first == rfirst == ("numpy", [("deadline", 10.0)])
    assert second == rsecond == ("numpy", [])
    np.testing.assert_array_equal(x, rx)


def _flaky(base, fail_first):
    class Flaky(base):
        calls = 0

        def _solver_for(self, stage, batch):
            inner = super()._solver_for(stage, batch)

            def flaky(b):
                type(self).calls += 1
                if type(self).calls <= fail_first:
                    raise RuntimeError("transient lane fault")
                return inner(b)
            return flaky
    return Flaky


def test_bounded_retry_then_success(band):
    b = random_rhs(band["port"][0], seed=13)

    def run(pkg, mat, prog):
        cls = _flaky(pkg["robust"].RobustSolver, 1)
        rs = cls(prog, mat, max_retries=1, ladder=(pkg["rung"]("jax"),), **pkg["opts"])
        x = rs(b)
        return x, cls.calls, rs.last_stage, _trail(rs.last_incidents)

    (x, calls, stage, trail), (rx, rcalls, rstage, rtrail) = _both(band, run)
    assert (calls, stage, trail) == (2, "torch", [("torch", "exception", "RuntimeError", 1)])
    assert (rcalls, RUNG[rstage], _trail_renamed(rtrail)) == (calls, stage, trail)
    np.testing.assert_allclose(x, np.asarray(rx), **TOL)


def test_retries_are_bounded(band):
    b = random_rhs(band["port"][0], seed=1)
    for pkg, key in ((PORT, "port"), (REF, "ref")):
        cls = _flaky(pkg["robust"].RobustSolver, 99)
        rs = cls(band[key][1], band[key][0], max_retries=1,
                 ladder=(pkg["rung"]("jax"),), **pkg["opts"])
        with pytest.raises(pkg["errors"].BackendExecutionError) as ei:
            rs.solve(b)
        assert [t["attempt"] for t in ei.value.detail["incidents"]] == [1, 2]


# =================================================== the port's own rules
class DeviceOnly(torch.Tensor):
    """A tensor that, like one on a CUDA device, refuses ``np.asarray``."""

    def __array__(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")


def test_device_tensor_answers_cross_to_the_host(band):
    """The torch and cuda rungs return device tensors, which ``np.asarray``
    refuses; the ladder converts them explicitly instead of recording every
    device rung as failed and answering from numpy."""
    mat, prog = band["port"]

    class OnDevice(RobustSolver):
        def _solver_for(self, stage, batch):
            inner = super()._solver_for(stage, batch)
            return lambda b: torch.as_tensor(inner(b)).as_subclass(DeviceOnly)

    b = random_rhs(mat, seed=3)
    rs = OnDevice(prog, mat, backend="cuda", **CPU)
    with pytest.raises(TypeError, match="cuda"):
        np.asarray(rs._solver_for("torch", None)(b))
    x = rs(b)
    assert rs.last_stage == "cuda-blocked" and rs.last_incidents == []
    assert type(x) is np.ndarray
    np.testing.assert_array_equal(x, RobustSolver(prog, mat, ladder=("cuda-blocked",),
                                                  **CPU)(b))


def test_no_cuda_raises_at_construction(band):
    """Without a card a device rung is not a degraded answer: construction
    raises, where the reference would record the build failure and answer
    from numpy."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    mat, prog = band["port"]
    for backend in ("cuda", "torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            api.robust_solver(prog, mat, backend=backend)
    with pytest.raises(RuntimeError, match="CUDA"):
        RobustSolver(prog, mat, ladder=("numpy", "torch"))
    rs = RobustSolver(prog, mat, backend="numpy")  # no rung needs a device
    assert rs.device is None and rs.ladder == ("numpy", "reference")


# ==================================================== RobustSolver: inputs
def test_nonfinite_rhs_rejected(band):
    for pkg, key in ((PORT, "port"), (REF, "ref")):
        mat, prog = band[key]
        rs = pkg["api"].robust_solver(prog, mat, **pkg["opts"])
        bad = random_rhs(band["port"][0], seed=0)
        msgs = []
        for v in (np.nan, np.inf):
            bad[4] = v
            with pytest.raises(pkg["errors"].NumericalHealthError, match="non-finite") as ei:
                rs(bad)
            msgs.append(str(ei.value))
        assert msgs == ["right-hand side carries 1 non-finite entry (first at index (4,))"] * 2


def test_wrong_shape_and_dtype_rejected(band):
    mat, prog = band["port"]
    rs = api.robust_solver(prog, mat, **CPU)
    with pytest.raises(errors.NumericalHealthError, match=r"\[n\] or \[n, B\]"):
        rs(np.zeros(mat.n + 1))
    with pytest.raises(errors.NumericalHealthError, match="not numeric"):
        rs(np.array(["a"] * mat.n, dtype=object))


def test_construction_verifies_program(band):
    bad = FaultInjector(0).corrupt_stream(band["port"][1], k=1, mode="nan")
    with pytest.raises(errors.ProgramCorruptionError, match="non-finite"):
        RobustSolver(bad, band["port"][0], **CPU)


# ================================================ fault-injection harnesses
@pytest.mark.parametrize("matrix", ["ckt", "band"])
def test_fault_injection_matches_the_reference_per_trial(request, matrix):
    """Every fault class is detected or safely degraded — trial for trial
    as in the JAX package (the same seeds draw the same faults)."""
    pair = request.getfixturevalue(matrix)
    trials = run_fault_injection(*pair["port"], trials_per_class=2, seed=0, **CPU)
    ref = ref_robust.run_fault_injection(*pair["ref"], trials_per_class=2, seed=0)
    assert {t["fault"] for t in trials} == set(FAULT_CLASSES)
    assert not any(t["silent_wrong"] for t in trials), trials
    assert trials == [dict(t, degraded_to=RUNG.get(t["degraded_to"], "")) for t in ref]
    # structural and I/O faults are *detected*, never merely degraded
    # (band_cz has no psum traffic, so its psum_slot fault changes nothing)
    detected = ("psum_slot", "blob", "rhs_nan", "rhs_inf") if matrix == "ckt" \
        else ("blob", "rhs_nan", "rhs_inf")
    assert all(t["detected"] != "none" for t in trials if t["fault"] in detected), trials


def test_fault_injection_on_the_cuda_rungs(ckt):
    """Entered at the cuda rung (plain versions on the CPU), no silent wrong
    answer; the blocked rung's refusal of ckt_rajat04 (no window) is not
    counted as a detection, so the clean trials read as the torch entry's."""
    mat, prog = ckt["port"]
    trials = run_fault_injection(mat, prog, trials_per_class=2, seed=0, backend="cuda",
                                 **CPU)
    torch_trials = run_fault_injection(mat, prog, trials_per_class=2, seed=0, **CPU)
    assert not any(t["silent_wrong"] for t in trials)
    assert [t["detected"] for t in trials] == [t["detected"] for t in torch_trials]


@pytest.mark.parametrize("name", ["ckt_rajat04", "band_cz", "ckt_add20"])
def test_ir_fault_injection_matches_the_reference(name):
    got = run_ir_fault_injection(api.matrix(name), seed=1)
    assert got == ref_robust.run_ir_fault_injection(ref_api.matrix(name), seed=1)
    assert [r["fault"] for r in got] == list(IR_FAULT_CLASSES)
    assert all(r["caught"] for r in got if r["applicable"]), got
