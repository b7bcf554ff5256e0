"""Locality-first list schedule passes: `AssignIR` → dense `ScheduleIR`.

A family of list schedulers in the block-bounded style of polyphony's
compiler (SNIPPETS.md Snippets 1–2) and the partition-based parallel
scheduling of Böhnlein et al. (arXiv 2503.05408), re-targeted at the
paper's VLIW machine.  They keep the paper scheduler's full partial-sum
caching mechanics — SWAP / LOAD / STORE_RESET slot transitions, the
Fig. 7 capacity rules, the emergency overflow park — and change only the
*pick order*, a lookahead priority function instead of the paper's fixed
"resume first cached > continue > start next in program order".  Three
points on the frontier are registered (`strategies.STRATEGIES`):

  * ``"locality"`` — **continue** the current node while it has work
    (the psum feedback path is free: staying put costs no ctl traffic
    and no slot pressure), then resume the parked node with the greatest
    critical-path height, then start in program order.  Wins on
    psum-capacity-bound circuit DAGs, where the paper's resume-first
    order swaps partial sums in and out of slots it is short on.
  * ``"cpath"``   — resume the deepest-critical-path parked node *before*
    continuing, then start in program order.  Pure critical-path list
    scheduling; wins where finishing parked nodes early unblocks the
    longest chains.
  * ``"eager"``   — like ``"locality"`` but starts the node with the
    most immediately issuable edges instead of program order.  A
    consume-early heuristic: draining delivered values before new ones
    arrive keeps the x_i register file from thrashing, which wins on
    spill-bound hub DAGs (the ``hub_wall`` stressor) at the price of
    delaying program-order finals everywhere else.

No single pick order dominates — that is the point of the strategy
frontier; `schedule="auto"` arbitrates per matrix by predicted cycles.

Per-cycle edge picks run through the same ICR reorder + bank/spill
models (`icr.assign_sources`) as every other strategy.
"""

from __future__ import annotations

import time

from ...program import (
    OP_EDGE,
    OP_FINAL,
    PS_KEEP,
    PS_LOAD,
    PS_RESET,
    PS_STORE_RESET,
    PS_SWAP,
    AccelConfig,
    ScheduleStats,
)
from .. import icr
from ..ir import AssignIR, ScheduleIR
from ..sched import _CU, _Node
from . import base

__all__ = ["run", "run_cpath", "run_eager", "NAME", "CPATH", "EAGER"]

NAME = "locality"
CPATH = "cpath"
EAGER = "eager"


def run(air: AssignIR, cfg: AccelConfig) -> ScheduleIR:
    """Psum-reuse-first list schedule (``"locality"``; module docstring)."""
    return _run(air, cfg, name=NAME, continue_first=True, start_key="pos")


def run_cpath(air: AssignIR, cfg: AccelConfig) -> ScheduleIR:
    """Critical-path-first list schedule (``"cpath"``; module docstring)."""
    return _run(air, cfg, name=CPATH, continue_first=False, start_key="pos")


def run_eager(air: AssignIR, cfg: AccelConfig) -> ScheduleIR:
    """Consume-early list schedule (``"eager"``; module docstring)."""
    return _run(air, cfg, name=EAGER, continue_first=True, start_key="ready")


def _run(air: AssignIR, cfg: AccelConfig, *, name: str, continue_first: bool,
         start_key: str) -> ScheduleIR:
    """The shared list-scheduler machine behind the three presets."""
    if cfg.dataflow != "medium":
        raise ValueError(
            f"schedule={name!r} requires dataflow='medium', "
            f"got {cfg.dataflow!r} (use schedule='paper')")
    dag = air.part.dag
    n, p = dag.n, cfg.num_cus
    scale = dag.scale
    owner = air.owner
    consumers = air.part.consumers
    height = base.node_heights(consumers, n)

    nodes = [_Node(i, int(owner[i]), *dag.node(i), edge0=int(dag.ptr[i]))
             for i in range(n)]
    cus = [_CU(c, dag.name, air.task_lists[c], cfg.psum_words)
           for c in range(p)]
    startable: list[dict[int, int]] = [dict() for _ in range(p)]  # pos -> nid
    for nd in nodes:
        if nd.pending == 0:
            c = nd.owner
            startable[c][cus[c].pos_of[nd.nid]] = nd.nid

    if start_key == "ready":
        def best_start(c: int) -> _Node:
            # consume-early lookahead: most issuable edges, program order
            # breaking ties (sources have no edges, so -pos decides them)
            pos = max(startable[c],
                      key=lambda p_: (len(nodes[startable[c][p_]].ready), -p_))
            return nodes[startable[c][pos]]
    else:
        def best_start(c: int) -> _Node:
            return nodes[startable[c][min(startable[c])]]  # program order

    trace = base.Trace(p)
    stats = ScheduleStats(name=dag.name, n=n, nnz=dag.nnz, cycles=0,
                          exec_edges=0, exec_finals=0)
    bank_state = icr.BankSpillState(cfg)
    icr_seconds = 0.0

    solved_total = 0
    cycle = 0
    stall_streak = 0
    max_cycles = base.max_schedule_cycles(dag)

    while solved_total < n:
        if cycle > max_cycles:
            raise RuntimeError(
                f"{name} scheduler did not converge on {dag.name}")
        op_row, val_row, src_row, ctl_row, slot_row = trace.new_row()

        # ---------------------------------------------- phase 1: node choice
        chosen: list[tuple[str, _Node, int, int] | None] = [None] * p
        nop_kind: list[str | None] = [None] * p

        for cu in cus:
            c = cu.cid
            if cu.all_done():
                nop_kind[c] = "l"
                continue
            cur = cu.current
            cur_live = cur is not None and not cur.solved

            picked: tuple[str, _Node] | None = None
            if continue_first and cur_live and cur.has_work():
                picked = ("continue", cur)       # psum feedback stays hot
            if picked is None:
                resumable = [nd for nd in cu.cached if nd.has_work()]
                if resumable:                    # deepest critical path first
                    picked = ("resume",
                              max(resumable, key=lambda nd: height[nd.nid]))
            if picked is None and cur_live and cur.has_work():
                picked = ("continue", cur)
            if picked is None and startable[c] and (cfg.psum_cache
                                                    or not cur_live):
                picked = ("start", best_start(c))
            if picked is None:
                # deadlock escape, identical to the paper scheduler's
                if stall_streak >= 2 and cur_live and startable[c]:
                    nd = best_start(c)
                    stats.dm_escapes += 1
                    kind = "edge" if nd.ready else "final"
                    chosen[c] = (kind, nd, PS_STORE_RESET, cu.peek_over_slot())
                    continue
                nop_kind[c] = "d"
                continue

            mode, nd = picked
            if mode == "resume":
                if cur_live:
                    ctrl, slot = PS_SWAP, nd.slot  # read-before-write swap
                else:
                    ctrl, slot = PS_LOAD, nd.slot
            elif mode == "continue":
                ctrl, slot = PS_KEEP, 0
            else:  # start
                if cur_live:
                    cu.advance_head()
                    first_new = (cu.head < len(cu.tasks)
                                 and cu.tasks[cu.head] == nd.nid)
                    need = 1 if first_new else 2  # Fig. 7 capacity rule
                    if len(cu.free_slots) < need:
                        if stall_streak >= 2:
                            ctrl, slot = PS_STORE_RESET, cu.peek_over_slot()
                            stats.dm_escapes += 1
                            kind = "edge" if nd.ready else "final"
                            chosen[c] = (kind, nd, ctrl, slot)
                            continue
                        nop_kind[c] = "p"
                        continue
                    ctrl, slot = PS_STORE_RESET, cu.free_slots[0]
                else:
                    ctrl, slot = PS_RESET, 0
            kind = "edge" if nd.ready else "final"
            chosen[c] = (kind, nd, ctrl, slot)

        # ------------------------------- phase 2: ICR reorder + bank/spill
        t_icr = time.perf_counter()
        assigned_src = icr.assign_sources(bank_state, cfg, stats, chosen,
                                          nop_kind, cus)
        icr_seconds += time.perf_counter() - t_icr

        # ---------------------------------------------- phase 3: execute
        newly_solved: list[_Node] = []
        executed = 0
        for c in range(p):
            if chosen[c] is None:
                k = nop_kind[c]
                if k == "b":
                    stats.bnop += 1
                elif k == "p":
                    stats.pnop += 1
                elif k == "s":
                    stats.snop += 1
                elif k == "l":
                    stats.lnop += 1
                else:
                    stats.dnop += 1
                continue
            executed += 1
            kind, nd, ctrl, slot = chosen[c]
            cu = cus[c]
            cur = cu.current

            if ctrl == PS_SWAP:
                cur.slot = nd.slot
                cu.cached[cu.cached.index(nd)] = cur
                nd.slot = -1
            elif ctrl == PS_LOAD:
                cu.release_slot(nd.slot, cfg.psum_words)
                cu.cached.remove(nd)
                nd.slot = -1
            elif ctrl == PS_STORE_RESET:
                if slot < cfg.psum_words:
                    cu.free_slots.remove(slot)
                elif slot in cu.free_over:
                    cu.free_over.remove(slot)
                else:
                    assert slot == cu.next_over
                    cu.next_over += 1
                cur.slot = slot
                cu.cached.append(cur)

            if not nd.started:
                nd.started = True
                pos = cu.pos_of[nd.nid]
                cu.started_mask[pos] = True
                startable[c].pop(pos, None)
                cu.advance_head()
            cu.current = nd

            ctl_row[c] = ctrl
            slot_row[c] = slot

            if kind == "edge":
                s = assigned_src[c]
                nd.ready.remove(s)
                nd.remaining -= 1
                cu.edge_count += 1
                if s in cu.resident:
                    cu.resident[s] -= 1
                    if cu.resident[s] <= 0:
                        del cu.resident[s]  # release after last use (R_vs)
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
                src_row[c] = nd.nid  # FINAL writes x[src]
                nd.solved = True
                cu.done_count += 1
                newly_solved.append(nd)
                stats.exec_finals += 1

        stall_streak = 0 if executed else stall_streak + 1

        # deliver newly solved values — consumable from the NEXT cycle
        for nd in newly_solved:
            solved_total += 1
            j = nd.nid
            per_cu_uses: dict[int, int] = {}
            for i in consumers[j]:
                cons = nodes[i]
                cons.ready.append(j)
                cons.pending -= 1
                cu_i = cons.owner
                per_cu_uses[cu_i] = per_cu_uses.get(cu_i, 0) + 1
                if not cons.started:
                    startable[cu_i][cus[cu_i].pos_of[i]] = i
            for cu_i, uses in per_cu_uses.items():
                cu = cus[cu_i]
                if len(cu.resident) < cfg.xi_words:
                    cu.resident[j] = cu.resident.get(j, 0) + uses
                else:
                    cu.spilled.add(j)
                    stats.spilled_values += 1

        trace.push(op_row, val_row, src_row, ctl_row, slot_row)
        cycle += 1

    num_slots = max(cu.next_over for cu in cus)
    return base.build_schedule_ir(
        name, air, cfg, trace, stats, cus, bank_state, icr_seconds,
        num_slots=num_slots, extra_metrics={"dataflow": cfg.dataflow})
