"""Performance linter over compiled `Program`s (DESIGN.md §8, SPT2xx).

Static pathologies the schedule statistics and row envelopes expose —
nothing here affects correctness, every diagnostic is a throughput or
footprint observation with a suggested knob:

  * SPT201 — CU load imbalance (input-edge CV, §V-B of the paper);
  * SPT202 — psum spill pressure: overflow slots in use or emergency
    double-buffer parks (`dm_escapes`);
  * SPT203 — stall-row density (elided all-NOP cycles / total cycles);
  * SPT204 — the 2-plane packed fallback doubled instruction traffic;
  * SPT205 — the row envelope admits no blocked placement window, so the
    row-blocked large-n path (x in device memory behind a shared-memory
    window) is unavailable;
  * SPT206 — PE utilization below threshold;
  * SPT207 — bank-conflict replay density (bnop share of all lanes);
  * SPT208 — the compiled scheduler strategy's predicted cycles exceed
    the best strategy on the frontier by more than ``frontier_warn``
    (requires ``stats.schedule_costs`` — recorded by ``schedule="auto"``
    compiles, or attached by `scripts/lint_program.py --frontier`).

Thresholds live in `LintConfig`; defaults are calibrated so the bundled
suite at the default `AccelConfig` stays warning-meaningful (hub-pattern
matrices legitimately warn, banded ones stay clean).
"""

from __future__ import annotations

import dataclasses

from .diagnostics import SEV_INFO, SEV_WARN, Diagnostic

__all__ = ["LintConfig", "lint_program"]


@dataclasses.dataclass(frozen=True)
class LintConfig:
    """Thresholds of the performance linter (see module docstring)."""

    load_cv_warn: float = 75.0     # SPT201: edge-CV% across CUs
    spill_info_slots: int = 0      # SPT202: overflow slots beyond config
    stall_warn: float = 0.25       # SPT203: elided stall rows / cycles
    util_warn: float = 0.10        # SPT206: exec lanes / total lanes
    conflict_warn: float = 0.05    # SPT207: bnop lanes / total lanes
    cycles_per_block: int = 128    # SPT205: blocked-placement granularity
    frontier_warn: float = 0.10    # SPT208: predicted cycles over the best
                                   # frontier strategy, as a fraction


def _diag(code, severity, message, *, hint="", **detail):
    return Diagnostic(code=code, severity=severity, message=message,
                      pass_name="program", hint=hint, detail=detail)


def lint_program(prog, lint_cfg: LintConfig | None = None):
    """Run every performance lint over a compiled `Program`.

    Returns a list of warn/info `Diagnostic`s; never errors.  Works on
    deserialized programs too — checks whose statistics did not survive
    serialization (`per_cu_edges`) are skipped silently.
    """
    lc = lint_cfg or LintConfig()
    st = prog.stats
    cfg = prog.config
    diags: list[Diagnostic] = []

    # SPT201 — CU load imbalance
    if st.per_cu_edges is not None and len(st.per_cu_edges) > 1:
        cv = st.load_balance_cv()
        if cv > lc.load_cv_warn:
            diags.append(_diag(
                "SPT201", SEV_WARN,
                f"CU input-edge load imbalance CV {cv:.1f}% exceeds "
                f"{lc.load_cv_warn:.0f}%",
                hint="try a different AccelConfig.alloc policy or more "
                     "CUs; imbalance converts directly into lnop stalls",
                cv=round(cv, 2), per_cu_edges=[int(e) for e in
                                               st.per_cu_edges]))

    # SPT202 — psum spill pressure
    from ..compiler.sched import PSUM_OVERFLOW_SLOTS

    # num_slots starts at psum_words + PSUM_OVERFLOW_SLOTS and only grows
    # past it when emergency parks demanded extra on-the-fly slots
    over = (prog.num_slots or 0) - (cfg.psum_words + PSUM_OVERFLOW_SLOTS)
    if st.dm_escapes > 0:
        diags.append(_diag(
            "SPT202", SEV_WARN,
            f"{st.dm_escapes} emergency psum park(s) escaped to the "
            f"overflow region",
            hint="raise AccelConfig.psum_words; each park round-trips a "
                 "partial sum through spill memory",
            dm_escapes=int(st.dm_escapes)))
    elif over > lc.spill_info_slots:
        diags.append(_diag(
            "SPT202", SEV_INFO,
            f"schedule grew {over} overflow slot(s) beyond the "
            f"{cfg.psum_words}-word psum register file and its "
            f"{PSUM_OVERFLOW_SLOTS} reserved overflow slots",
            hint="psum pressure is past capacity; heavier cuts of this "
                 "DAG may start parking",
            overflow_slots=int(over)))

    # SPT203 — stall-row density (dense cycles vs emitted rows)
    if st.cycles and st.emitted_cycles:
        stall = (st.cycles - st.emitted_cycles) / st.cycles
        if stall > lc.stall_warn:
            diags.append(_diag(
                "SPT203", SEV_WARN,
                f"{100 * stall:.1f}% of hardware cycles are all-NOP stall "
                f"rows (> {100 * lc.stall_warn:.0f}%)",
                hint="inspect stats.nop_breakdown(): bnop → more banks, "
                     "pnop → more psum words, dnop/lnop → DAG critical "
                     "path or assignment",
                stall_density=round(stall, 4)))

    # SPT204 — packed-plane fallback
    if prog.planes == 2:
        diags.append(_diag(
            "SPT204", SEV_INFO,
            "n exceeds the single-word src field; the 2-plane packed "
            "fallback doubles instruction-stream HBM traffic",
            planes=2))

    # SPT205 — blocked-placement feasibility
    if prog.row_lo is not None:
        from repro_torch.kernels.sptrsv.ops import plan_window

        plan = plan_window(prog, lc.cycles_per_block)
        if not plan.feasible:
            diags.append(_diag(
                "SPT205", SEV_WARN,
                f"row envelope admits no blocked placement window "
                f"({plan.reason}); large-n solves must keep the whole x "
                f"vector resident (in shared memory where it fits, else "
                f"in device memory)",
                hint="hub-free orderings (e.g. RCM pre-permutation) "
                     "restore window feasibility",
                reason=plan.reason))

    # SPT206 — PE utilization
    if st.per_cu_edges is not None and st.cycles:
        util = st.utilization()
        if util < lc.util_warn:
            diags.append(_diag(
                "SPT206", SEV_WARN,
                f"PE utilization {100 * util:.1f}% is below "
                f"{100 * lc.util_warn:.0f}%",
                hint="DAG parallelism does not feed this many CUs; fewer "
                     "CUs or a wider matrix cut may run faster per area",
                utilization=round(util, 4)))

    # SPT207 — bank-conflict replay density
    total_lanes = st.cycles * cfg.num_cus
    if total_lanes and st.bnop / total_lanes > lc.conflict_warn:
        diags.append(_diag(
            "SPT207", SEV_WARN,
            f"bank-conflict replays occupy "
            f"{100 * st.bnop / total_lanes:.1f}% of issue slots "
            f"(> {100 * lc.conflict_warn:.0f}%)",
            hint="raise AccelConfig.num_banks or enable the ICR reorder "
                 "(cfg.icr) to color conflicting reads apart",
            bnop=int(st.bnop),
            density=round(st.bnop / total_lanes, 4)))

    # SPT208 — cycles left on the scheduling-strategy frontier
    costs = getattr(st, "schedule_costs", None)
    chosen = getattr(st, "schedule", "paper")
    if costs and chosen in costs:
        mine = costs[chosen]["cycles"]
        best = min(costs, key=lambda k: costs[k]["cycles"])
        best_cycles = costs[best]["cycles"]
        if best_cycles and mine > best_cycles * (1.0 + lc.frontier_warn):
            diags.append(_diag(
                "SPT208", SEV_WARN,
                f"strategy {chosen!r} predicts {mine} cycles but "
                f"{best!r} predicts {best_cycles} "
                f"({100 * (mine / best_cycles - 1):.1f}% over, "
                f"> {100 * lc.frontier_warn:.0f}%)",
                hint=f'recompile with schedule="{best}" (or '
                     f'schedule="auto" to pick per matrix)',
                schedule=chosen, best=best,
                predicted={k: int(v["cycles"]) for k, v in costs.items()}))
    return diags
