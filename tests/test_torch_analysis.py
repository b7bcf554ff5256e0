"""The port's static analysis against the JAX package's.

Twins tests/test_analysis.py and tests/test_lint.py:

1. per-pass contract verifiers wired into ``compile(verify_ir=True)``:
   verified compiles of every compile entry point give the JAX package's
   programs, and a corrupted IR raises `IRValidationError` naming the same
   pass (the IR faults are the JAX package's `FaultInjector`, applied to
   the port's IRs);
2. the hazard detector: every IR fault class fires the diagnostic codes it
   fires in the JAX package, and `analyze_program` reports the same
   (code, severity, pass, cycle, cu, node, detail) list on every suite
   matrix with n <= 5k;
3. the performance linter, whose SPT205 message alone names the port's
   memories;

and the port's core sources pass the repository's lint guard.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import api as ref_api
from repro.core import matrices as ref_matrices
from repro.core.errors import IRValidationError as RefIRValidationError
from repro.core.errors import ProgramCorruptionError as RefCorruption
from repro.core.frontends.sptrsv import lower_tri as ref_lower_tri
from repro.core.robust import (
    IR_FAULT_CLASSES,
    FaultInjector,
    _copy_program,
    run_ir_fault_injection,
)
from repro_torch.core import api, matrices
from repro_torch.core.analysis import (
    CODES,
    SEV_ERROR,
    AnalysisReport,
    Diagnostic,
    analyze_program,
    contracts,
    lint_program,
    program_diagnostics,
    verify_assign,
    verify_emit,
    verify_frontend,
    verify_packed_program,
    verify_partition,
    verify_schedule,
)
from repro_torch.core.compiler import assign, elide, emit, partition, sched
from repro_torch.core.csr import from_coo, transpose_upper
from repro_torch.core.errors import IRValidationError, ProgramCorruptionError
from repro_torch.core.frontends.sptrsv import lower_tri
from repro_torch.core.program import AccelConfig
from repro_torch.core.robust import verify_program
from test_torch_compiler import SMALL, assert_same_program

REPO = Path(__file__).resolve().parent.parent
FAST_SET = ["band_cz", "ckt_rajat04", "chem_bp", "wide_c36", "hub_small"]
FULL_MATRIX = "ckt_rajat04"


def _key(d):
    return (d.code, d.severity, d.pass_name, d.cycle, d.cu, d.node, d.detail)


def _same_diagnostics(got, want):
    assert [_key(d) for d in got] == [_key(d) for d in want]


@pytest.fixture(scope="module")
def pipeline():
    """All staged IRs of FULL_MATRIX at the default config."""
    cfg = AccelConfig()
    dag = lower_tri(matrices.generate(FULL_MATRIX))
    pir = partition.run(dag)
    air = assign.run(pir, cfg)
    sir = sched.run(air, cfg)
    eir = elide.run(sir)
    prog = emit.run(eir, cfg, planes=None)
    return cfg, dag, pir, air, sir, eir, prog


# ------------------------------------------------------------ diagnostics
def test_code_registry_matches_reference():
    from repro.core.analysis import CODES as REF_CODES

    assert CODES == REF_CODES
    for code, title in CODES.items():
        assert code.startswith("SPT") and len(code) == 6, code
        assert code[3] in "123" and title


def test_diagnostic_rejects_unknown_code_and_severity():
    with pytest.raises(ValueError):
        Diagnostic(code="SPT999", severity=SEV_ERROR, message="x")
    with pytest.raises(ValueError):
        Diagnostic(code="SPT110", severity="fatal", message="x")


def test_report_render_and_json_roundtrip():
    d = Diagnostic(code="SPT110", severity=SEV_ERROR, message="row 3 never "
                   "finalized", pass_name="psum_schedule", node=3)
    rep = AnalysisReport(name="unit", meta={"n": 4}).extend([d])
    assert not rep.ok() and rep.codes() == {"SPT110"}
    text = rep.render()
    assert "SPT110" in text and "psum_schedule" in text
    back = json.loads(rep.to_json())
    assert back["name"] == "unit"
    assert back["diagnostics"][0]["code"] == "SPT110"
    assert back["diagnostics"][0]["node"] == 3


# ------------------------------------------------- clean-compile contract
@pytest.mark.parametrize("name", FAST_SET)
def test_clean_compile_verifies(name):
    prog = api.compile(matrices.generate(name), verify_ir=True)
    entries = [ps for ps in prog.stats.pass_stats if ps.name == "verify_ir"]
    assert len(entries) == 1
    assert entries[0].metrics["stages_verified"] == 6
    assert entries[0].seconds >= 0.0
    assert_same_program(prog, ref_api.compile(ref_matrices.generate(name), verify_ir=True))


@pytest.mark.parametrize("name", SMALL)
def test_verified_pair_matches_reference(name):
    """``verify_ir=True`` through `compile_pair` (the forward sweep through
    `compile`, the backward through `compile_upper`): the same programs as
    the JAX package's verified compile, and no error diagnostic."""
    pair = api.compile_pair(matrices.generate(name), verify_ir=True)
    ref_pair = ref_api.compile_pair(ref_matrices.generate(name), verify_ir=True)
    assert_same_program(pair.forward.program, ref_pair.forward.program)
    assert_same_program(pair.backward.program, ref_pair.backward.program)


def test_every_stage_verifies_clean(pipeline):
    cfg, dag, pir, air, sir, eir, prog = pipeline
    assert verify_frontend(dag) == []
    assert verify_partition(pir) == []
    assert verify_assign(air, cfg) == []
    assert verify_schedule(sir, air, cfg) == []
    assert verify_emit(eir, sir) == []
    assert verify_packed_program(prog, eir, cfg) == []


@pytest.mark.parametrize("cfg", [
    AccelConfig(num_cus=8, psum_words=4),
    AccelConfig(alloc="roundrobin"),
    AccelConfig(icr=False, psum_cache=False),
], ids=["small", "roundrobin", "no_icr_no_cache"])
def test_config_variants_verify_clean(cfg):
    from repro.core.program import AccelConfig as RefAccelConfig

    ref_cfg = RefAccelConfig(**dataclasses.asdict(cfg))
    for name in ["ckt_rajat04", "hub_small"]:
        assert_same_program(api.compile(matrices.generate(name), cfg, verify_ir=True),
                            ref_api.compile(ref_matrices.generate(name), ref_cfg,
                                            verify_ir=True))


@pytest.mark.parametrize("name", SMALL)
def test_analyze_program_matches_reference(name):
    """Every suite matrix with n <= 5k compiles verified, has no error
    diagnostic, and gets the JAX package's diagnostics, field by field."""
    prog = api.compile(matrices.generate(name), verify_ir=True)
    report = analyze_program(prog)
    assert report.errors == [], f"{name}: {report.render()}"
    want = ref_api.analyze_program(ref_api.compile(ref_matrices.generate(name)))
    _same_diagnostics(report.diagnostics, want.diagnostics)
    assert report.meta == want.meta and report.name == want.name


def test_analyze_frontend_programs_match_reference():
    """The same for the backward sweep, a circuit and a split program."""
    from repro.core import csr as ref_csr
    from repro.core.frontends.dagcirc import random_circuit as ref_random_circuit
    from repro_torch.core.frontends import random_circuit

    got = [api.compile_upper(transpose_upper(matrices.generate("ckt_c204"))).program,
           api.compile_circuit(random_circuit(800, seed=4, locality=50)).program,
           api.compile_split(matrices.generate("hub_wall"), max_indegree=48)[0]]
    want = [ref_api.compile_upper(ref_csr.transpose_upper(
                ref_matrices.generate("ckt_c204"))).program,
            ref_api.compile_circuit(ref_random_circuit(800, seed=4, locality=50)).program,
            ref_api.compile_split(ref_matrices.generate("hub_wall"), max_indegree=48)[0]]
    for g, w in zip(got, want):
        _same_diagnostics(api.analyze_program(g).diagnostics,
                          ref_api.analyze_program(w).diagnostics)


# ------------------------------------------------- IR fault injection
def _port_ir_faults(mat, seed, classes=IR_FAULT_CLASSES):
    """The JAX package's `run_ir_fault_injection` over the port's pipeline
    and contract verifiers: {fault: error codes fired, or None when the
    fault does not apply}."""
    cfg = AccelConfig()
    dag = lower_tri(mat)
    pir = partition.run(dag)
    air = assign.run(pir, cfg)
    sir = sched.run(air, cfg)
    eir = elide.run(sir)
    prog = emit.run(eir, cfg, planes=None)
    inj = FaultInjector(seed)
    fired = {}
    for fault in classes:
        diags = None
        if fault == "dag_self_edge":
            bad = inj.corrupt_dag(dag)
            diags = bad and contracts.verify_frontend(bad)
        elif fault == "partition_drop_consumer":
            bad = inj.corrupt_partition(pir)
            diags = bad and contracts.verify_partition(bad)
        elif fault == "assign_owner_swap":
            bad = inj.corrupt_assign(air)
            diags = bad and contracts.verify_assign(bad, cfg)
        elif fault.startswith("sched_"):
            bad = inj.corrupt_schedule(sir, fault[len("sched_"):])
            diags = bad and contracts.verify_schedule(bad, air, cfg)
        elif fault.startswith("emit_"):
            bad = inj.corrupt_emit(eir, fault[len("emit_"):])
            diags = bad and contracts.verify_emit(bad, sir)
        else:
            assert fault == "pack_val_idx_oob", fault
            bad = _copy_program(prog)
            bad.val_idx[0, 0] = np.int32(bad.stream.size + 7)
            diags = contracts.verify_packed_program(bad, eir, cfg)
        fired[fault] = None if bad is None else sorted(
            {d.code for d in diags if d.severity == SEV_ERROR})
    return fired


@pytest.mark.parametrize("fault", IR_FAULT_CLASSES)
def test_ir_fault_fires_expected_code(fault):
    (got,) = _port_ir_faults(matrices.generate(FULL_MATRIX), 3, (fault,)).values()
    (want,) = run_ir_fault_injection(ref_matrices.generate(FULL_MATRIX), seed=3,
                                     classes=(fault,))
    assert want["applicable"] and want["caught"]
    assert got == want["fired_codes"]
    assert want["expected_code"] in got


def test_ir_fault_injection_seed_sweep():
    mat, ref_mat = matrices.generate(FULL_MATRIX), ref_matrices.generate(FULL_MATRIX)
    for seed in range(5):
        got = _port_ir_faults(mat, seed)
        for r in run_ir_fault_injection(ref_mat, seed=seed):
            assert got[r["fault"]] == r["fired_codes"], (seed, r)
            assert r["expected_code"] in got[r["fault"]], (seed, r)


def test_verify_ir_names_frontend_on_dag_fault():
    from repro.core.compiler import ComputeDag as RefComputeDag
    from repro_torch.core.compiler import ComputeDag

    bad = FaultInjector(0).corrupt_dag(lower_tri(matrices.generate(FULL_MATRIX)))
    with pytest.raises(IRValidationError) as got:
        api.compile_dag(bad, verify_ir=True)
    assert "frontend" in str(got.value)
    assert got.value.detail["pass"] == "frontend"
    assert got.value.detail["code"] == "SPT118"
    ref_bad = FaultInjector(0).corrupt_dag(
        ref_lower_tri(ref_matrices.generate(FULL_MATRIX)))
    assert isinstance(bad, ComputeDag) and isinstance(ref_bad, RefComputeDag)
    with pytest.raises(RefIRValidationError) as want:
        ref_api.compile_dag(ref_bad, verify_ir=True)
    assert str(got.value) == str(want.value)
    assert got.value.detail == want.value.detail


def test_verify_ir_names_guilty_pass_on_schedule_fault(monkeypatch):
    """A scheduler bug (simulated by mutating its output) is blamed on
    psum_schedule — not discovered later as a generic corrupt program."""
    inj = FaultInjector(1)
    real_run = sched.run
    monkeypatch.setattr(sched, "run",
                        lambda air, cfg: inj.corrupt_schedule(real_run(air, cfg), "raw"))
    with pytest.raises(IRValidationError) as exc:
        api.compile(matrices.generate(FULL_MATRIX), verify_ir=True)
    assert exc.value.detail["pass"] == "psum_schedule"
    assert exc.value.detail["code"] in ("SPT111", "SPT117")


def test_unverified_compile_ignores_ir_faults(monkeypatch):
    """Without verify_ir the pipeline stays permissive: the same mutation
    compiles and only the packed-program checks can complain."""
    inj = FaultInjector(1)
    real_run = sched.run
    monkeypatch.setattr(sched, "run",
                        lambda air, cfg: inj.corrupt_schedule(real_run(air, cfg), "raw"))
    prog = api.compile(matrices.generate(FULL_MATRIX))
    assert prog.cycles > 0


# ------------------------------------------------- verify_program
def test_verify_program_raises_first_analyzer_error(pipeline):
    from repro.core.robust import verify_program as ref_verify_program

    *_, prog = pipeline
    bad = _copy_program(prog)
    bad.val_idx[0, 0] = np.int32(bad.stream.size + 11)
    first = next(d for d in program_diagnostics(bad) if d.severity == SEV_ERROR)
    with pytest.raises(ProgramCorruptionError) as exc:
        verify_program(bad)
    assert str(exc.value) == f"program integrity: {first.message}"
    assert exc.value.detail["code"] == first.code
    with pytest.raises(ProgramCorruptionError):
        api.verify_program(bad)
    with pytest.raises(RefCorruption) as want:
        ref_verify_program(bad)
    assert str(want.value) == str(exc.value)


def test_verify_program_clean(pipeline):
    *_, prog = pipeline
    verify_program(prog)  # must not raise
    api.verify_program(prog)
    assert program_diagnostics(prog) == []


# ------------------------------------------------------------ perf linter
def test_linter_flags_hub_imbalance():
    codes = {d.code for d in lint_program(api.compile(matrices.generate("hub_small")))}
    assert {"SPT201", "SPT206"} <= codes


def test_linter_flags_psum_pressure():
    codes = {d.code for d in lint_program(api.compile(matrices.generate(FULL_MATRIX)))}
    assert "SPT202" in codes


def test_linter_silent_on_balanced_band():
    assert lint_program(api.compile(matrices.generate("band_cz"))) == []


def test_spt205_names_the_ports_memories():
    """The one wording the port changes: with no feasible window, x stays
    resident in shared memory or device memory (the JAX package says VMEM).
    Code, severity, detail and hint are the JAX package's."""
    got = [d for d in lint_program(api.compile(matrices.generate("ckt_c204")))
           if d.code == "SPT205"]
    want = [d for d in ref_api.analyze_program(ref_api.compile(
        ref_matrices.generate("ckt_c204"))).diagnostics if d.code == "SPT205"]
    assert len(got) == len(want) == 1
    assert _key(got[0]) == _key(want[0]) and got[0].hint == want[0].hint
    assert "shared memory" in got[0].message and "device memory" in got[0].message
    assert "VMEM" not in got[0].message and "VMEM" in want[0].message


def test_analyze_program_report_shape(pipeline):
    *_, prog = pipeline
    report = api.analyze_program(prog)
    assert report.errors == []
    assert report.meta["artifact"] == "program"
    assert set(report.codes()) <= set(CODES)
    assert api.analyze_program(prog, lint=False).diagnostics == []


def test_random_lower_tri_verifies_clean():
    """Random well-formed lower-triangular systems compile with verify_ir
    and analyze with zero error diagnostics, as in the JAX package."""
    from repro.core.csr import from_coo as ref_from_coo

    for seed in range(6):
        rng = np.random.default_rng(seed)
        n = int(rng.integers(2, 48))
        rows, cols = [], []
        for i in range(1, n):
            m = rng.random(i) < 0.3
            for j in np.nonzero(m)[0]:
                rows.append(i)
                cols.append(int(j))
        coo = (n, rows, cols, rng.uniform(-1, 1, len(rows)), rng.uniform(1.0, 2.0, n))
        prog = api.compile(from_coo(*coo, name=f"rnd_an_{seed}"), verify_ir=True)
        assert analyze_program(prog, lint=False).ok()
        ref_prog = ref_api.compile(ref_from_coo(*coo, name=f"rnd_an_{seed}"),
                                   verify_ir=True)
        assert_same_program(prog, ref_prog)
        _same_diagnostics(analyze_program(prog).diagnostics,
                          ref_api.analyze_program(ref_prog).diagnostics)


# ------------------------------------------------------------ lint guard
def test_port_core_sources_lint_clean(capsys):
    """The repository's lint guard (tests/test_lint.py) over the port's
    core library."""
    sys.path.insert(0, str(REPO / "scripts"))
    import check_lint

    rc = check_lint.main([str(REPO / "src" / "repro_torch" / "core")])
    assert rc == 0, f"lint problems:\n{capsys.readouterr().out}"
