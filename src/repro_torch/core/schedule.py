"""Compiler entry point for lower-triangular SpTRSV (thin wrapper).

The historical 500-line monolith that lived here is now the staged pass
pipeline in `core/compiler/` (DESIGN.md §6):

    partition → cu-assign → psum-cache schedule (+ per-cycle ICR reorder)
    → stall-elide → pack/emit

over the generic `compiler.ComputeDag` IR, with workload lowerings in
`core/frontends/` (lower-triangular here; upper-triangular, transpose and
general DAG-circuit workloads beside it).  `compile_program` keeps its
historical signature — lower a `TriCSR` through the SpTRSV frontend and
run the pipeline — and produces the identical `Program` (instruction
stream, stats, row envelopes) the monolith did; the equivalence is pinned
by `tests/test_compiler_pipeline.py` against a frozen copy of the old
compiler.
"""

from __future__ import annotations

from .compiler import (  # noqa: F401  (recompile_values re-exported)
    PSUM_OVERFLOW_SLOTS,
    compile_dag,
    recompile_values,
)
from .compiler.assign import allocate
from .csr import TriCSR
from .frontends.sptrsv import lower_tri
from .program import AccelConfig, Program

__all__ = ["compile_program", "recompile_values", "allocate_nodes",
           "PSUM_OVERFLOW_SLOTS"]


def allocate_nodes(mat: TriCSR, cfg: AccelConfig) -> list[list[int]]:
    """Node → CU allocation (historical API; see `compiler.assign`)."""
    return allocate(mat.n, mat.in_degree(), cfg)


def compile_program(mat: TriCSR, cfg: AccelConfig | None = None, *,
                    planes: int | None = None,
                    schedule: str = "paper",
                    verify_ir: bool = False) -> Program:
    """Compile ``mat`` into a packed VLIW `Program`.

    ``planes`` forces the packed-word layout (1 = single-word, 2 = the
    large-n fallback); ``None`` auto-selects via `program.packed_planes`.
    ``schedule`` picks the schedule pass — a strategy name from
    `compiler.strategies` or ``"auto"`` for per-matrix cost-model
    selection (DESIGN.md §11).  ``verify_ir=True`` runs the per-pass
    contract verifiers between pipeline stages (`core/analysis/`, raises
    `errors.IRValidationError` naming the guilty pass).  Equivalent to
    ``compiler.compile_dag(frontends.sptrsv.lower_tri(mat))``.
    """
    return compile_dag(lower_tri(mat), cfg, planes=planes,
                       schedule=schedule, verify_ir=verify_ir)
