"""Staged compiler pipeline for SpTRSV-like compute DAGs (DESIGN.md §6).

Replaces the historical monolithic ``schedule.compile_program`` with an
explicit pass pipeline over documented IR dataclasses (`ir.py`)::

    ComputeDag → partition → cu-assign → psum-cache schedule (+ per-cycle
    ICR reorder) → stall-elide → pack/emit → Program

`compile_dag` is the generic entry point: it accepts any workload lowered
to the `ComputeDag` frontend contract (`core/frontends/`) and emits the
unchanged `Program` format every executor, the batching/sharding paths and
the packed encoding already consume.  ``schedule.compile_program`` is now
a thin TriCSR wrapper over this pipeline.

Per-pass wall-clock and metrics are recorded on
``program.stats.pass_stats`` (a list of `PassStats`) for observability;
``compile_seconds`` stays the end-to-end total.
"""

from __future__ import annotations

import time

from ..program import AccelConfig, Program
from . import assign, elide, emit, partition, sched
from .ir import (  # noqa: F401  (re-exported IR surface)
    AssignIR,
    ComputeDag,
    EmitIR,
    PartitionIR,
    PassStats,
    ScheduleIR,
)
from .sched import MAX_PSUM_SLOT, PSUM_OVERFLOW_SLOTS  # noqa: F401

__all__ = [
    "compile_dag",
    "recompile_values",
    "ComputeDag",
    "PartitionIR",
    "AssignIR",
    "ScheduleIR",
    "EmitIR",
    "PassStats",
    "PASS_NAMES",
    "PSUM_OVERFLOW_SLOTS",
    "MAX_PSUM_SLOT",
]

PASS_NAMES = ("partition", "cu_assign", "psum_schedule", "icr_reorder",
              "stall_elide", "pack_emit")


def compile_dag(dag: ComputeDag, cfg: AccelConfig | None = None, *,
                planes: int | None = None,
                schedule: str = "paper",
                verify_ir: bool = False) -> Program:
    """Compile a `ComputeDag` workload into a packed VLIW `Program`.

    ``planes`` forces the packed-word layout (1 = single-word, 2 = the
    large-n fallback); ``None`` auto-selects via `program.packed_planes`.
    The pipeline stages run in order; each records a `PassStats` entry on
    ``program.stats.pass_stats``.

    ``schedule`` picks the schedule pass (DESIGN.md §11): ``"paper"`` (the
    default psum-cache scheduler), an alternative strategy by name
    (``"level"``, ``"locality"``), or ``"auto"`` — compile every candidate
    and keep the one the analytic cost model predicts cheapest.  The
    decision lands in ``stats.schedule`` (and, for auto, the per-candidate
    predictions in ``stats.schedule_costs``); auto's selection overhead is
    a synthetic ``"strategy_select"`` entry on ``pass_stats``.

    ``verify_ir=True`` runs the per-pass contract verifiers
    (`core/analysis/contracts.py`) on every intermediate IR and raises
    `errors.IRValidationError` naming the guilty pass on the first broken
    invariant; the verifier wall-clock is appended to ``pass_stats`` as a
    synthetic ``"verify_ir"`` entry so the overhead stays observable.
    """
    cfg = cfg or AccelConfig()
    t0 = time.perf_counter()

    if verify_ir:
        from ..analysis import contracts

        t_verify = 0.0
        verified = 0

        def _check(diags_fn, stage):
            nonlocal t_verify, verified
            t = time.perf_counter()
            diags = diags_fn()
            contracts.raise_on_errors(diags, stage, dag.name)
            t_verify += time.perf_counter() - t
            verified += 1
    else:
        def _check(diags_fn, stage):
            pass

    def _timed(fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        return out, time.perf_counter() - t

    _check(lambda: contracts.verify_frontend(dag), "frontend")
    pir, t_part = _timed(partition.run, dag)
    _check(lambda: contracts.verify_partition(pir), "partition")
    air, t_assign = _timed(assign.run, pir, cfg)
    _check(lambda: contracts.verify_assign(air, cfg), "cu_assign")
    select_stats = None
    if schedule == "auto":
        from . import strategies

        t = time.perf_counter()
        sir, chosen, costs, run_seconds = strategies.select(air, cfg)
        t_select = time.perf_counter() - t
        t_sched = run_seconds[chosen]
        sir.stats.schedule_costs = costs
        select_stats = PassStats("strategy_select", t_select - t_sched, {
            "chosen": chosen,
            "candidates": list(costs),
            "predicted_cycles": {k: v["cycles"] for k, v in costs.items()},
        })
    elif schedule == "paper":
        sir, t_sched = _timed(sched.run, air, cfg)
    else:
        from . import strategies

        sir, t_sched = _timed(strategies.get(schedule), air, cfg)
    _check(lambda: contracts.verify_schedule(sir, air, cfg), "psum_schedule")
    eir, t_elide = _timed(elide.run, sir)
    _check(lambda: contracts.verify_emit(eir, sir), "stall_elide")
    prog, t_emit = _timed(emit.run, eir, cfg, planes=planes)
    _check(lambda: contracts.verify_packed_program(prog, eir, cfg),
           "pack_emit")

    # the ICR reorder runs per cycle inside the schedule pass (its outcome
    # feeds the next cycle's node state); it accumulates its own time and
    # metrics in the trace, reported here as its own stage
    t_icr = sir.icr_metrics.get("seconds", 0.0)
    icr_metrics = {k: v for k, v in sir.icr_metrics.items() if k != "seconds"}
    prog.stats.pass_stats = [
        PassStats("partition", t_part, pir.metrics),
        PassStats("cu_assign", t_assign, air.metrics),
        PassStats("psum_schedule", t_sched - t_icr, sir.metrics),
        PassStats("icr_reorder", t_icr, icr_metrics),
        PassStats("stall_elide", t_elide, eir.metrics),
        PassStats("pack_emit", t_emit, {
            "planes": prog.planes,
            "emitted_cycles": prog.cycles,
            "instr_bytes": prog.instr_bytes(),
        }),
    ]
    if select_stats is not None:
        prog.stats.pass_stats.append(select_stats)
    if verify_ir:
        prog.stats.pass_stats.append(
            PassStats("verify_ir", t_verify, {"stages_verified": verified}))
    prog.stats.compile_seconds = time.perf_counter() - t0
    return prog


def recompile_values(prog: Program, new_workload) -> Program:
    """Values-only recompilation: reuse the schedule, regather the stream.

    Factorization loops re-solve one sparsity *pattern* with fresh numeric
    values every step; the schedule (partition / cu-assign / psum-cache /
    ICR / elide — everything but the value stream) depends only on the
    pattern, so recompiling it is pure waste.  This fast path gathers a
    fresh value stream through the program's provenance plane
    (``prog.stream_src``, recorded by the schedule pass: entry >= 0 is a
    global edge index into the workload's weight array, a negative entry
    -(i+1) is node i's scale) and returns a *new* `Program` sharing every
    other tensor with ``prog``.

    ``new_workload`` is a `TriCSR` (lowered through the SpTRSV frontend —
    a pure re-slicing, no scheduling) or any `ComputeDag`.  It must have
    the same pattern as the program's source workload: same ``n``, same
    edge count.  Callers that cannot guarantee pattern equality must key
    on a structure fingerprint first (`serve.pattern_fingerprint`, as
    `serve.ProgramCache` does).

    Raises ``ValueError`` when ``prog`` carries no provenance plane (a
    pre-provenance deserialized program — take the full recompile path)
    or when the shapes disagree; the new workload's values are validated
    (finite weights, finite non-zero scale) before gathering.

    The returned program is a distinct object on purpose: executors fold
    the stream into their traces as constants and cache per program
    *identity*, so refreshing values in place would silently serve stale
    numbers from cached traces.
    """
    import dataclasses

    import numpy as np

    from ..csr import TriCSR

    if isinstance(new_workload, TriCSR):
        from ..frontends.sptrsv import lower_tri

        dag = lower_tri(new_workload)
    else:
        dag = new_workload
    ss = prog.stream_src
    if ss is None:
        raise ValueError(
            "program carries no value-provenance plane (stream_src) — "
            "compiled before values-only recompilation existed; run a "
            "full recompile instead")
    if dag.n != prog.n:
        raise ValueError(
            f"values refresh for n={prog.n} program got a workload with "
            f"n={dag.n}")
    if ss.shape != prog.stream.shape:
        raise ValueError(
            f"provenance plane has {ss.size} entries but the stream has "
            f"{prog.stream.size}")
    dag.validate()
    edge = ss >= 0
    if (edge.any() and int(ss[edge].max()) >= dag.n_edges) or \
            ((~edge).any() and int(-(ss[~edge].min() + 1)) >= dag.n):
        raise ValueError(
            f"provenance plane indexes outside the new workload "
            f"({dag.n_edges} edges, {dag.n} nodes) — pattern mismatch")
    new_stream = np.empty(ss.shape, dtype=np.float64)
    new_stream[edge] = dag.weight[ss[edge]]
    new_stream[~edge] = dag.scale[-(ss[~edge] + 1)]
    return dataclasses.replace(
        prog,
        stream=new_stream.astype(np.float32),
        stats=dataclasses.replace(prog.stats, name=dag.name),
    )
