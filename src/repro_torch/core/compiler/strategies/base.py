"""Shared machinery of the pluggable scheduler strategies (DESIGN.md §11).

Every strategy pass consumes the pipeline's `AssignIR` and produces the
standard dense `ScheduleIR` cycle trace, so the downstream passes (ICR is
already folded in per cycle, stall-elide, pack/emit), the IR contract
verifiers and all three executors run a strategy's schedule unchanged.
The pieces every strategy shares live here:

  * `Node` — per-DAG-node scheduling state (delivered inputs, remaining
    edges, value/provenance maps for the stream planes);
  * `deliver` — the end-of-cycle wavefront: consumers of newly solved
    rows wake *next* cycle (which is what makes every strategy's trace
    RAW-clean by construction) and the x_i register-file resident/spill
    model updates exactly as the paper scheduler's (`compiler.sched`);
  * `node_depths` / `node_heights` — longest-path levels from the
    sources (level-set packing order) and to the sinks (critical-path
    priority);
  * `build_schedule_ir` — assembles the trace planes, the shared
    `ScheduleStats`, and the ICR metrics into a `ScheduleIR`.

Strategies must respect the invariants `analysis.contracts.verify_schedule`
pins: every node executes wholly on its assigned CU, each edge exactly
once, FINAL strictly after all inputs finalized, one stream value appended
per executed lane, and the `stream_src` provenance plane filled so
values-only recompilation (`compiler.recompile_values`) keeps working.
"""

from __future__ import annotations

import numpy as np

from ...program import AccelConfig, ScheduleStats
from .. import icr
from ..ir import AssignIR, ScheduleIR

__all__ = [
    "Node",
    "Trace",
    "node_depths",
    "node_heights",
    "deliver",
    "build_schedule_ir",
    "max_schedule_cycles",
]


class Node:
    """Scheduling state of one DAG node (mirrors `compiler.sched._Node`)."""

    __slots__ = ("nid", "owner", "srcs", "val_of", "gidx_of", "ready",
                 "pending", "remaining", "issued", "solved")

    def __init__(self, nid: int, owner: int, srcs, weights, edge0: int = 0):
        self.nid = nid
        self.owner = owner
        self.srcs = srcs
        self.val_of = dict(zip(srcs.tolist(), weights.tolist()))
        # source node id -> global edge index into ComputeDag.weight (the
        # value-provenance map the stream_src plane is built from)
        self.gidx_of = {s: edge0 + k for k, s in enumerate(srcs.tolist())}
        self.ready: list[int] = []
        self.pending = len(srcs)
        self.remaining = len(srcs)
        self.issued = 0          # ops executed so far (0 -> next op RESETs)
        self.solved = False


def make_nodes(air: AssignIR) -> list[Node]:
    dag = air.part.dag
    owner = air.owner
    return [Node(i, int(owner[i]), *dag.node(i), edge0=int(dag.ptr[i]))
            for i in range(dag.n)]


def node_depths(dag) -> np.ndarray:
    """Longest-path level from the sources (level-set membership)."""
    depth = np.zeros(dag.n, dtype=np.int64)
    ptr, src = dag.ptr, dag.src
    for i in range(dag.n):
        lo, hi = int(ptr[i]), int(ptr[i + 1])
        if hi > lo:
            depth[i] = int(depth[src[lo:hi]].max()) + 1
    return depth


def node_heights(consumers, n: int) -> np.ndarray:
    """Longest-path distance to a sink (critical-path priority)."""
    height = np.zeros(n, dtype=np.int64)
    for j in range(n - 1, -1, -1):
        cons = consumers[j]
        if cons:
            height[j] = int(height[cons].max() if isinstance(cons, np.ndarray)
                            else max(height[i] for i in cons)) + 1
    return height


def deliver(newly_solved, nodes, consumers, cus, cfg: AccelConfig,
            stats: ScheduleStats, on_runnable=None) -> int:
    """End-of-cycle delivery of newly finalized rows (next-cycle visible).

    Updates consumer ready/pending state and the per-CU x_i register-file
    resident/spill model exactly as the paper scheduler does (the spill
    set feeds `icr.assign_sources`' reload stalls).  ``on_runnable(node)``
    fires when a consumer's last input arrives (strategies enqueue it);
    returns the number of rows delivered.
    """
    for nd in newly_solved:
        j = nd.nid
        per_cu_uses: dict[int, int] = {}
        for i in consumers[j]:
            cons = nodes[i]
            cons.ready.append(j)
            cons.pending -= 1
            per_cu_uses[cons.owner] = per_cu_uses.get(cons.owner, 0) + 1
            if cons.pending == 0 and on_runnable is not None:
                on_runnable(cons)
        for cu_i, uses in per_cu_uses.items():
            cu = cus[cu_i]
            if len(cu.resident) < cfg.xi_words:
                cu.resident[j] = cu.resident.get(j, 0) + uses
            else:
                cu.spilled.add(j)
                stats.spilled_values += 1
    return len(newly_solved)


def max_schedule_cycles(dag) -> int:
    """Divergence guard shared with the paper scheduler."""
    return 8 * dag.nnz + 64 * dag.n + 4096


class Trace:
    """Accumulates the dense per-cycle instruction planes + value stream."""

    def __init__(self, p: int):
        self.p = p
        self.ops: list[np.ndarray] = []
        self.val: list[np.ndarray] = []
        self.src: list[np.ndarray] = []
        self.ctl: list[np.ndarray] = []
        self.slot: list[np.ndarray] = []
        self.stream: list[float] = []
        self.stream_src: list[int] = []

    def new_row(self):
        return (np.zeros(self.p, dtype=np.uint8),
                np.zeros(self.p, dtype=np.int32),
                np.zeros(self.p, dtype=np.int32),
                np.zeros(self.p, dtype=np.uint8),
                np.zeros(self.p, dtype=np.uint8))

    def push(self, op_row, val_row, src_row, ctl_row, slot_row) -> None:
        self.ops.append(op_row)
        self.val.append(val_row)
        self.src.append(src_row)
        self.ctl.append(ctl_row)
        self.slot.append(slot_row)


def build_schedule_ir(strategy: str, air: AssignIR, cfg: AccelConfig,
                      trace: Trace, stats: ScheduleStats, cus,
                      bank_state: icr.BankSpillState, icr_seconds: float,
                      num_slots: int, extra_metrics: dict | None = None,
                      ) -> ScheduleIR:
    """Assemble the standard dense `ScheduleIR` from a strategy's trace."""
    dag = air.part.dag
    stats.cycles = len(trace.ops)
    stats.per_cu_edges = np.array([cu.edge_count for cu in cus])
    stats.schedule = strategy
    metrics = {
        "strategy": strategy,
        "hardware_cycles": stats.cycles,
        "exec_edges": stats.exec_edges,
        "exec_finals": stats.exec_finals,
        "dm_escapes": stats.dm_escapes,
        "psum_slots_used": num_slots,
        "spilled_values": stats.spilled_values,
        **(extra_metrics or {}),
    }
    icr_metrics = dict(bank_state.metrics(stats, cfg),
                       seconds=round(icr_seconds, 6))
    return ScheduleIR(
        name=dag.name, n=dag.n,
        ops=np.stack(trace.ops), val_idx=np.stack(trace.val),
        src=np.stack(trace.src), ctl=np.stack(trace.ctl),
        slot=np.stack(trace.slot),
        stream=np.array(trace.stream, dtype=np.float64),
        num_slots=num_slots, stats=stats, metrics=metrics,
        icr_metrics=icr_metrics,
        stream_src=np.array(trace.stream_src, dtype=np.int64),
    )
