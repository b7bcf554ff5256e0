"""Static analysis over the compiler IRs and packed programs (DESIGN.md §8).

Three layers, one diagnostic vocabulary (`diagnostics.CODES`):

1. **Per-pass contract verifiers** (`contracts.py`) — one verifier per
   pipeline IR; `compile_dag(verify_ir=True)` runs them after every stage
   and raises `IRValidationError` naming the guilty pass.
2. **Schedule hazard/race detector** (`hazards.py` over `trace.py`
   views) — RAW hazards, psum-slot lifetime races, FINAL multiplicity,
   bank pressure, envelope consistency; the single implementation
   `core.robust.verify_program` now wraps.
3. **Performance linter** (`perf.py`) — SPT2xx warn/info lints over
   schedule statistics and row envelopes.

`analyze_program` is the everything entry point (structure + hazards +
lints → `AnalysisReport`).  A copy of the JAX package's ``core/analysis``
in which SPT205's message and SPT114's hint name the port's memories
(shared memory, device memory).
"""

from __future__ import annotations

from .contracts import (
    raise_on_errors,
    verify_assign,
    verify_emit,
    verify_frontend,
    verify_packed_program,
    verify_partition,
    verify_schedule,
)
from .diagnostics import (
    CODES,
    SEV_ERROR,
    SEV_INFO,
    SEV_WARN,
    AnalysisReport,
    Diagnostic,
    render_text,
)
from .hazards import packed_structure, trace_hazards
from .perf import LintConfig, lint_program
from .trace import TraceView, view_emit, view_program, view_schedule

__all__ = [
    "CODES",
    "SEV_ERROR",
    "SEV_WARN",
    "SEV_INFO",
    "Diagnostic",
    "AnalysisReport",
    "render_text",
    "TraceView",
    "view_schedule",
    "view_emit",
    "view_program",
    "packed_structure",
    "trace_hazards",
    "LintConfig",
    "lint_program",
    "verify_frontend",
    "verify_partition",
    "verify_assign",
    "verify_schedule",
    "verify_emit",
    "verify_packed_program",
    "raise_on_errors",
    "program_diagnostics",
    "analyze_program",
    "analyze_schedule",
]


def program_diagnostics(prog, cfg=None):
    """Correctness diagnostics of a packed `Program` (no perf lints).

    Structure first; hazards only when the words decode.  This is the
    exact check set `core.robust.verify_program` raises on, in the same
    order, as a list instead of a raise.
    """
    diags, decodable, values_ok = packed_structure(prog)
    if decodable:
        diags += trace_hazards(view_program(prog),
                               cfg if cfg is not None else prog.config,
                               check_values=values_ok)
    return diags


def analyze_program(prog, *, lint: bool = True,
                    lint_cfg: LintConfig | None = None) -> AnalysisReport:
    """Full static analysis of a packed `Program` → `AnalysisReport`."""
    report = AnalysisReport(
        name=prog.stats.name,
        meta={"n": prog.n, "cycles": prog.cycles, "planes": prog.planes,
              "num_cus": prog.config.num_cus, "artifact": "program"})
    report.extend(program_diagnostics(prog))
    if lint:
        report.extend(lint_program(prog, lint_cfg))
    return report


def analyze_schedule(sir, air=None, cfg=None) -> AnalysisReport:
    """Static analysis of a dense `ScheduleIR` → `AnalysisReport`."""
    report = AnalysisReport(
        name=sir.name,
        meta={"n": sir.n, "cycles": int(sir.ops.shape[0]),
              "artifact": "schedule"})
    return report.extend(verify_schedule(sir, air, cfg))
