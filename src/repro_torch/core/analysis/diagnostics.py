"""Diagnostic records and reports of the IR static analyzer (DESIGN.md §8).

Every finding of the static-analysis subsystem — a per-pass contract
violation, a schedule hazard, a performance pathology — is one
`Diagnostic`: a stable machine-readable code (``SPT1xx`` correctness,
``SPT2xx`` performance), a severity, the pipeline pass it blames, optional
cycle/CU/node anchors, the human-readable message, and a fix hint.  An
`AnalysisReport` aggregates the diagnostics of one analyzed artifact and
renders them as text or JSON (`scripts/lint_program.py` is the CLI over
both).

The code table is mirrored in DESIGN.md §8; codes are append-only — a
published code never changes meaning, so incident pipelines and tests can
key on them.
"""

from __future__ import annotations

import dataclasses
import json

__all__ = [
    "SEV_ERROR",
    "SEV_WARN",
    "SEV_INFO",
    "CODES",
    "Diagnostic",
    "AnalysisReport",
    "render_text",
]

SEV_ERROR = "error"   # correctness hazard: the artifact must not execute
SEV_WARN = "warn"     # performance pathology worth operator attention
SEV_INFO = "info"     # observation; no action required

# Stable diagnostic-code registry (append-only; table mirrored in
# DESIGN.md §8).  SPT1xx = correctness/hazard, SPT2xx = performance.
CODES: dict[str, str] = {
    # -- structural (packed Program tensors) --------------------------------
    "SPT101": "malformed instruction tensor (shape/dtype/planes)",
    "SPT102": "packed instruction field out of bit-width range",
    "SPT103": "invalid opcode or psum-control encoding",
    "SPT104": "NOP lane carries a non-zero instruction word",
    "SPT105": "active lane reads a solution row out of bounds",
    "SPT106": "value index outside the stream",
    "SPT107": "non-finite value in the stream plane",
    "SPT108": "FINAL lane carries a zero diagonal reciprocal",
    # -- schedule hazards / races ------------------------------------------
    "SPT110": "solution row not finalized exactly once",
    "SPT111": "RAW hazard: EDGE reads a row not yet finalized",
    "SPT112": "psum slot lifetime race (read-before-store / WAW overwrite)",
    "SPT113": "psum slot id beyond the register-file capacity",
    "SPT114": "row-envelope metadata inconsistent with instruction words",
    "SPT115": "bank pressure: distinct reads in one cycle exceed the banks",
    # -- cross-IR pass contracts -------------------------------------------
    "SPT116": "node executed on a CU other than its assigned owner",
    "SPT117": "schedule incomplete: edges/finals diverge from the DAG",
    "SPT118": "frontend contract violation (ComputeDag)",
    "SPT119": "partition contract violation (consumers/in-degree)",
    "SPT120": "assign contract violation (owner/task-list mismatch)",
    "SPT121": "emit contract violation (stall row survived / stale stats)",
    # -- performance lints --------------------------------------------------
    "SPT201": "CU load imbalance above threshold",
    "SPT202": "psum spill pressure (overflow slots / emergency parks)",
    "SPT203": "stall-row density above threshold",
    "SPT204": "two-plane instruction fallback doubles instruction traffic",
    "SPT205": "row envelope admits no blocked placement window",
    "SPT206": "PE utilization below threshold",
    "SPT207": "bank-conflict replay density above threshold",
    "SPT208": "scheduler strategy leaves cycles on the table vs the frontier",
    # -- serving / resilience incidents (DESIGN.md §10) ---------------------
    # `serve.SolveService.report()` renders every `robust.Incident` of the
    # serving layer through these codes, so breaker transitions, shed
    # events and degradations come out of the same machine-readable
    # Diagnostic JSON the static analyzer emits.
    "SPT301": "serving: backend execution failure during a flush",
    "SPT302": "serving: unhealthy solve output (non-finite / residual)",
    "SPT303": "serving: request deadline exceeded",
    "SPT304": "serving: circuit breaker state transition",
    "SPT305": "serving: request shed by admission control",
    "SPT306": "serving: program-cache disk tier rejected a corrupt blob",
    "SPT307": "serving: flush retried with backoff",
    "SPT308": "serving: stage exceeded the flush timeout (hang)",
    "SPT309": "serving: incident log saturated, oldest records dropped",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of the static analyzer (see module docstring)."""

    code: str               # stable "SPTnnn" registry key
    severity: str           # SEV_ERROR | SEV_WARN | SEV_INFO
    message: str            # human-readable, self-contained
    pass_name: str = ""     # pipeline stage blamed (compiler.PASS_NAMES
                            # entry, "frontend", or "program")
    cycle: int | None = None    # anchor: instruction row / hardware cycle
    cu: int | None = None       # anchor: compute-unit lane
    node: int | None = None     # anchor: DAG node / solution row
    hint: str = ""              # suggested fix / next step
    detail: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(f"unregistered diagnostic code {self.code!r}")
        if self.severity not in (SEV_ERROR, SEV_WARN, SEV_INFO):
            raise ValueError(f"unknown severity {self.severity!r}")

    @property
    def title(self) -> str:
        return CODES[self.code]

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["title"] = self.title
        return d

    def anchor(self) -> str:
        """Compact ``cycle/cu/node`` location string ("-" when unanchored)."""
        parts = [f"cycle {self.cycle}" if self.cycle is not None else None,
                 f"cu {self.cu}" if self.cu is not None else None,
                 f"node {self.node}" if self.node is not None else None]
        parts = [p for p in parts if p]
        return ", ".join(parts) if parts else "-"


@dataclasses.dataclass
class AnalysisReport:
    """All diagnostics of one analyzed artifact, plus context metadata.

    ``meta`` carries whatever the analysis entry point knows about the
    artifact (name, n, cycles, pass analyzed, thresholds used) so a JSON
    report is self-describing.
    """

    name: str
    diagnostics: list[Diagnostic] = dataclasses.field(default_factory=list)
    meta: dict = dataclasses.field(default_factory=dict)

    # -- selectors ---------------------------------------------------------
    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == SEV_ERROR]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == SEV_WARN]

    @property
    def infos(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == SEV_INFO]

    def ok(self) -> bool:
        """True when no error-severity diagnostic was found."""
        return not self.errors

    def codes(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def by_code(self) -> dict[str, list[Diagnostic]]:
        out: dict[str, list[Diagnostic]] = {}
        for d in self.diagnostics:
            out.setdefault(d.code, []).append(d)
        return out

    def extend(self, diags) -> "AnalysisReport":
        self.diagnostics.extend(diags)
        return self

    # -- renderers ---------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "meta": dict(self.meta),
            "ok": self.ok(),
            "counts": {"error": len(self.errors),
                       "warn": len(self.warnings),
                       "info": len(self.infos)},
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def render(self) -> str:
        return render_text(self)


def render_text(report: AnalysisReport) -> str:
    """Human-readable multi-line rendering of a report."""
    lines = [f"analysis: {report.name} — "
             f"{len(report.errors)} error(s), "
             f"{len(report.warnings)} warning(s), "
             f"{len(report.infos)} info(s)"]
    for k, v in sorted(report.meta.items()):
        lines.append(f"  {k}: {v}")
    for d in report.diagnostics:
        where = f" [{d.pass_name}]" if d.pass_name else ""
        lines.append(f"{d.code} {d.severity}{where} ({d.anchor()}): "
                     f"{d.message}")
        if d.hint:
            lines.append(f"    hint: {d.hint}")
    if not report.diagnostics:
        lines.append("  clean — no diagnostics")
    return "\n".join(lines)
