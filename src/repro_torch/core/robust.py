"""Hardened solve path, first part: program integrity.

Ports `verify_program` of the JAX package's ``core/robust.py``: a
structural validator for compiled `Program`s.  Everything the executors
and kernels *assume* about an instruction stream is checked explicitly:
packed-field ranges, zero-word NOP lanes, value-index bounds, finite
stream values with non-zero FINAL reciprocals, psum slot capacity and slot
*lifetimes*, each solution row finalized exactly once, dependency order,
and the row-envelope metadata (``row_lo/row_hi``) re-derived from the
words it summarizes.  It is a thin wrapper over
`core.analysis.program_diagnostics`, the implementation shared with
`compile_dag(verify_ir=True)`; any violation is a `ProgramCorruptionError`.

The rest of the JAX package's module — the `RobustSolver` degradation
ladder (cuda-blocked → cuda-resident → torch → numpy → reference in the
port), its incident records and the fault-injection harnesses — comes with
the port of the hardened solve path (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

from .analysis import SEV_ERROR, program_diagnostics
from .errors import ProgramCorruptionError
from .program import Program

__all__ = ["verify_program"]


def verify_program(prog: Program) -> None:
    """Structurally validate a compiled `Program` (see module docstring).

    Raises `ProgramCorruptionError` naming the first violated invariant;
    returns None on a clean program.  Pure numpy, no executor is touched —
    safe to run on untrusted/deserialized programs before any solve.

    Thin wrapper over the shared static analyzer
    (`core.analysis.program_diagnostics`): the hazard checks run in the
    historical order and the raised message is the first error
    diagnostic's, verbatim, so callers matching on messages are
    unaffected; the diagnostic code rides along in ``detail["code"]``.
    """
    for d in program_diagnostics(prog):
        if d.severity == SEV_ERROR:
            anchors = {k: v for k, v in
                       (("cycle", d.cycle), ("cu", d.cu), ("node", d.node))
                       if v is not None}
            raise ProgramCorruptionError(
                f"program integrity: {d.message}",
                detail={**anchors, **d.detail, "code": d.code})
