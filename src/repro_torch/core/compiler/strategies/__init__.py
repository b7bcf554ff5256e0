"""Pluggable scheduler strategies + per-matrix auto-select (DESIGN.md §11).

The staged pipeline made the schedule pass swappable: any function
``run(air: AssignIR, cfg: AccelConfig) -> ScheduleIR`` that honours the
`analysis.contracts.verify_schedule` contract slots in between cu-assign
and stall-elide, and every downstream pass and executor runs its output
unchanged.  This package holds the strategy registry:

  * ``"paper"``    — the paper's psum-cache scheduler (`compiler.sched`),
                     the default and the baseline;
  * ``"level"``    — level-set wavefront packing (`level.py`);
  * ``"locality"`` — psum-reuse-first list scheduling (`locality.py`);
  * ``"cpath"``    — critical-path-first list scheduling (`locality.py`);
  * ``"eager"``    — consume-early list scheduling for spill-bound hub
                     DAGs (`locality.py`);
  * ``"auto"``     — compile every applicable candidate, score each dense
                     trace with the analytic cost model (`cost.py`), keep
                     the cheapest.  Ties keep registry order, so ``auto``
                     is never predicted-worse than ``paper``.

`select` implements the auto mode; `frontier_costs` exposes the whole
frontier for one workload (the SPT208 perf lint and the frontier
benchmark are built on it).
"""

from __future__ import annotations

import time

from ...program import AccelConfig
from .. import sched
from ..ir import AssignIR, ScheduleIR
from . import level, locality
from .cost import CostEstimate, predict_cycles

__all__ = [
    "STRATEGIES",
    "AUTO",
    "get",
    "candidate_names",
    "select",
    "frontier_costs",
    "CostEstimate",
    "predict_cycles",
]

AUTO = "auto"

# Registry order is the tie-break order: "paper" first means the baseline
# wins every tie, which is what makes auto never predicted-worse than it.
STRATEGIES: dict[str, object] = {
    "paper": sched.run,
    level.NAME: level.run,
    locality.NAME: locality.run,
    locality.CPATH: locality.run_cpath,
    locality.EAGER: locality.run_eager,
}


def get(name: str):
    """Resolve a strategy name to its schedule pass; raise on unknown."""
    try:
        return STRATEGIES[name]
    except KeyError:
        options = ", ".join([*STRATEGIES, AUTO])
        raise ValueError(
            f"unknown schedule strategy {name!r}; options: {options}"
        ) from None


def candidate_names(cfg: AccelConfig) -> list[str]:
    """Strategies applicable under ``cfg`` (auto's candidate set).

    The alternative strategies model the medium-granularity machine; the
    coarse dataflow keeps its single paper schedule.
    """
    if cfg.dataflow != "medium":
        return ["paper"]
    return list(STRATEGIES)


def select(air: AssignIR, cfg: AccelConfig):
    """Auto-select: run every candidate, keep the predicted-cheapest.

    Returns ``(sir, chosen, costs, seconds)`` — the winning dense trace,
    its strategy name, ``{name: cost-dict}`` over all candidates, and
    ``{name: schedule-pass seconds}`` (the winner's entry is what the
    pipeline reports as the ``psum_schedule`` pass time; the rest is
    selection overhead).
    """
    sirs: dict[str, ScheduleIR] = {}
    ests: dict[str, CostEstimate] = {}
    seconds: dict[str, float] = {}
    for name in candidate_names(cfg):
        t = time.perf_counter()
        sirs[name] = get(name)(air, cfg)
        seconds[name] = time.perf_counter() - t
        ests[name] = predict_cycles(sirs[name], cfg)
    chosen = min(ests, key=lambda k: ests[k].sort_key())
    costs = {name: est.to_dict() for name, est in ests.items()}
    return sirs[chosen], chosen, costs, seconds


def frontier_costs(dag, cfg: AccelConfig | None = None) -> dict[str, dict]:
    """Predicted cost of every applicable strategy for one workload.

    Runs the pipeline front half (partition → cu-assign) once, then each
    candidate schedule pass; returns ``{name: cost-dict}`` as stored in
    ``stats.schedule_costs`` by auto compiles.  This is what lets
    `scripts/lint_program.py --frontier` flag an explicitly chosen
    strategy that leaves cycles on the table (SPT208).
    """
    from .. import assign, partition

    cfg = cfg or AccelConfig()
    air = assign.run(partition.run(dag), cfg)
    return {name: predict_cycles(get(name)(air, cfg), cfg).to_dict()
            for name in candidate_names(cfg)}
