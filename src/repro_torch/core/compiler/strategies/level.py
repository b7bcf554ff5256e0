"""Level-set schedule pass: `AssignIR` → dense `ScheduleIR` (DESIGN.md §11).

The sync-free / level-set line of SpTRSV work (Li et al., arXiv
1710.04985) schedules each dependency *level* of the DAG as one parallel
wavefront.  This pass transplants that idea onto the synchronized VLIW
machine: a node becomes runnable only once **all** of its inputs have
been delivered (not merely one, as the paper's psum-cache scheduler
allows), and each CU drains its runnable set in ascending level order,
packing every level greedily across the CUs that own its nodes.

Because a node starts with its inputs complete, it runs to completion —
edges then FINAL — without ever parking a partial sum: every node uses
``PS_RESET`` on its first op and ``PS_KEEP`` after, the slot plane stays
zero, and there are no psum spills by construction.  The price is lost
overlap: a CU idles (``dnop``) whenever none of its nodes is fully
delivered yet, which is exactly where the paper's medium-granularity
dataflow wins on deep, narrow DAGs.  On wide shallow DAGs the two are
close to tied and this pass's zero spill traffic can win the frontier.

Per-cycle edge picks still run through the ICR reorder + bank/spill
models (`icr.assign_sources`) so bank conflicts and x_i reload stalls
are accounted identically to the paper scheduler.
"""

from __future__ import annotations

import heapq
import time

from ...program import OP_EDGE, OP_FINAL, PS_KEEP, PS_RESET, AccelConfig, ScheduleStats
from .. import icr
from ..ir import AssignIR, ScheduleIR
from . import base

__all__ = ["run", "NAME"]

NAME = "level"


class _CU:
    """Per-CU state: a level-ordered runnable heap + the x_i file model."""

    __slots__ = ("cid", "heap", "current", "resident", "spilled",
                 "done_count", "edge_count", "total")

    def __init__(self, cid: int, total: int):
        self.cid = cid
        self.heap: list[tuple[int, int, int]] = []  # (level, pos, nid)
        self.current: base.Node | None = None
        self.resident: dict[int, int] = {}
        self.spilled: set[int] = set()
        self.done_count = 0
        self.edge_count = 0
        self.total = total


def run(air: AssignIR, cfg: AccelConfig) -> ScheduleIR:
    """Schedule the assigned DAG level by level; return the dense trace."""
    dag = air.part.dag
    n, p = dag.n, cfg.num_cus
    scale = dag.scale
    consumers = air.part.consumers

    nodes = base.make_nodes(air)
    depth = base.node_depths(dag)
    pos_of = [{nid: k for k, nid in enumerate(air.task_lists[c])}
              for c in range(p)]
    cus = [_CU(c, len(air.task_lists[c])) for c in range(p)]

    def enqueue(nd: base.Node) -> None:
        heapq.heappush(cus[nd.owner].heap,
                       (int(depth[nd.nid]), pos_of[nd.owner][nd.nid], nd.nid))

    for nd in nodes:          # sources are runnable immediately
        if nd.pending == 0:
            enqueue(nd)

    trace = base.Trace(p)
    stats = ScheduleStats(name=dag.name, n=n, nnz=dag.nnz, cycles=0,
                          exec_edges=0, exec_finals=0)
    bank_state = icr.BankSpillState(cfg)
    icr_seconds = 0.0

    solved_total = 0
    cycle = 0
    max_cycles = base.max_schedule_cycles(dag)

    while solved_total < n:
        if cycle > max_cycles:
            raise RuntimeError(
                f"level-set scheduler did not converge on {dag.name}")
        op_row, val_row, src_row, ctl_row, slot_row = trace.new_row()

        # phase 1: each CU continues its node, else peeks its level heap.
        # The pick is only *committed* (heap pop / current switch) when the
        # op actually lands — a bank/spill demotion replays next cycle.
        chosen: list[tuple[str, base.Node, int, int] | None] = [None] * p
        nop_kind: list[str | None] = [None] * p
        for cu in cus:
            c = cu.cid
            if cu.done_count == cu.total:
                nop_kind[c] = "l"
                continue
            cur = cu.current
            if cur is not None and not cur.solved:
                nd = cur
            elif cu.heap:
                nd = nodes[cu.heap[0][2]]
            else:
                nop_kind[c] = "d"  # nothing delivered-complete yet
                continue
            kind = "edge" if nd.ready else "final"
            ctl = PS_RESET if nd.issued == 0 else PS_KEEP
            chosen[c] = (kind, nd, ctl, 0)

        # phase 2: ICR reorder + bank/spill filtering (shared with paper)
        t_icr = time.perf_counter()
        assigned_src = icr.assign_sources(bank_state, cfg, stats, chosen,
                                          nop_kind, cus)
        icr_seconds += time.perf_counter() - t_icr

        # phase 3: execute surviving lanes
        newly_solved: list[base.Node] = []
        for c in range(p):
            if chosen[c] is None:
                k = nop_kind[c]
                if k == "b":
                    stats.bnop += 1
                elif k == "s":
                    stats.snop += 1
                elif k == "l":
                    stats.lnop += 1
                else:
                    stats.dnop += 1
                continue
            kind, nd, ctl, slot = chosen[c]
            cu = cus[c]
            if cu.current is not nd:
                heapq.heappop(cu.heap)
                cu.current = nd
            nd.issued += 1
            ctl_row[c] = ctl
            slot_row[c] = slot

            if kind == "edge":
                s = assigned_src[c]
                nd.ready.remove(s)
                nd.remaining -= 1
                cu.edge_count += 1
                if s in cu.resident:
                    cu.resident[s] -= 1
                    if cu.resident[s] <= 0:
                        del cu.resident[s]  # release after last use
                op_row[c] = OP_EDGE
                val_row[c] = len(trace.stream)
                trace.stream.append(float(nd.val_of[s]))
                trace.stream_src.append(nd.gidx_of[s])
                src_row[c] = s
                stats.exec_edges += 1
            else:
                op_row[c] = OP_FINAL
                val_row[c] = len(trace.stream)
                trace.stream.append(float(scale[nd.nid]))
                trace.stream_src.append(-(nd.nid + 1))
                src_row[c] = nd.nid
                nd.solved = True
                cu.done_count += 1
                newly_solved.append(nd)
                stats.exec_finals += 1

        solved_total += base.deliver(newly_solved, nodes, consumers, cus,
                                     cfg, stats, on_runnable=enqueue)
        trace.push(op_row, val_row, src_row, ctl_row, slot_row)
        cycle += 1

    levels = int(depth.max()) + 1 if n else 0
    return base.build_schedule_ir(
        NAME, air, cfg, trace, stats, cus, bank_state, icr_seconds,
        num_slots=1, extra_metrics={"dataflow": cfg.dataflow,
                                    "levels": levels})
