"""Psum-cache schedule pass: `AssignIR` → dense `ScheduleIR` cycle trace.

This is the cycle-accurate heart of the compiler: it simulates the
synchronized VLIW machine cycle by cycle, applying the medium-granularity
dataflow (§IV-A, node = allocation unit / edge = scheduling unit) and the
partial-sum caching mechanism (§IV-B) with the deadlock-avoiding capacity
rules of Fig. 7.  Each cycle's edge picks are filtered through the ICR
reorder + bank/spill models (`icr.py`) — a per-cycle sub-stage, since its
outcome feeds the next cycle's node state.

The produced trace is *dense*: one row per hardware cycle, all-NOP stall
rows included — eliding them is the next pass's job (`elide.py`), and the
schedule length is the hardware cycle count (the paper's compiler "can
fully predict the behavior of the hardware", §III-B).

Deviations from the paper (DESIGN.md §5): online least-used-first-fit bank
assignment; windowed ICR; emergency psum overflow parks on detected global
stalls (counted as ``dm_escapes``).
"""

from __future__ import annotations

import time

import numpy as np

from ..program import (
    MAX_SLOT,
    OP_EDGE,
    OP_FINAL,
    PS_KEEP,
    PS_LOAD,
    PS_RESET,
    PS_STORE_RESET,
    PS_SWAP,
    SLOT_BITS,
    AccelConfig,
    ScheduleStats,
)
from . import icr
from .ir import AssignIR, ScheduleIR

__all__ = ["run", "PSUM_OVERFLOW_SLOTS", "MAX_PSUM_SLOT"]

PSUM_OVERFLOW_SLOTS = 4  # emergency data-memory-modelled psum spill slots

# Overflow slots grow on demand but every slot id must fit the packed
# instruction word's slot field (core/program.py: SLOT_BITS wide).
MAX_PSUM_SLOT = MAX_SLOT


class _Node:
    __slots__ = (
        "nid", "owner", "srcs", "val_of", "gidx_of", "ready", "pending",
        "remaining", "started", "solved", "slot",
    )

    def __init__(self, nid: int, owner: int, srcs, weights, edge0: int = 0):
        self.nid = nid
        self.owner = owner
        self.srcs = srcs
        self.val_of = dict(zip(srcs.tolist(), weights.tolist()))
        # source node id -> global edge index into ComputeDag.weight: the
        # value-provenance map the stream_src plane (values-only
        # recompilation, `compiler.recompile_values`) is built from
        self.gidx_of = {s: edge0 + k for k, s in enumerate(srcs.tolist())}
        self.ready: list[int] = []
        self.pending = len(srcs)
        self.remaining = len(srcs)
        self.started = False
        self.solved = False
        self.slot = -1

    def has_work(self) -> bool:
        return bool(self.ready) or (self.remaining == 0 and not self.solved)


class _CU:
    __slots__ = (
        "cid", "name", "tasks", "pos_of", "head", "started_mask", "current",
        "cached", "free_slots", "free_over", "next_over", "resident",
        "spilled", "done_count", "edge_count",
    )

    def __init__(self, cid: int, name: str, tasks: list[int], psum_words: int):
        self.cid = cid
        self.name = name
        self.tasks = tasks
        self.pos_of = {nd: k for k, nd in enumerate(tasks)}
        self.head = 0
        self.started_mask = np.zeros(len(tasks), dtype=bool)
        self.current: _Node | None = None
        self.cached: list[_Node] = []
        self.free_slots = list(range(psum_words))
        self.free_over = list(range(psum_words, psum_words + PSUM_OVERFLOW_SLOTS))
        self.next_over = psum_words + PSUM_OVERFLOW_SLOTS  # grows on demand
        self.resident: dict[int, int] = {}
        self.spilled: set[int] = set()
        self.done_count = 0
        self.edge_count = 0

    def peek_over_slot(self) -> int:
        """Next overflow slot (modelled data-memory psum spill).

        Grows on demand up to the capacity of the packed instruction word's
        ``slot`` field (`program.SLOT_BITS` ⇒ slot ids 0..`MAX_PSUM_SLOT`,
        overflow included).
        """
        if self.free_over:
            return self.free_over[0]
        if self.next_over > MAX_PSUM_SLOT:
            raise RuntimeError(
                f"psum overflow slots exhausted compiling {self.name!r} on "
                f"CU {self.cid}: slot id {self.next_over} does not fit the "
                f"{SLOT_BITS}-bit packed slot field (max {MAX_PSUM_SLOT}); "
                f"raise AccelConfig.psum_words or split heavy nodes "
                f"(core.transform.split_heavy_nodes)")
        return self.next_over

    def advance_head(self) -> None:
        while self.head < len(self.tasks) and self.started_mask[self.head]:
            self.head += 1

    def release_slot(self, slot: int, psum_words: int) -> None:
        if slot < psum_words:
            self.free_slots.append(slot)
        else:
            self.free_over.append(slot)

    def all_done(self) -> bool:
        return self.done_count == len(self.tasks)


def run(air: AssignIR, cfg: AccelConfig) -> ScheduleIR:
    """Simulate the machine over the assigned DAG; return the dense trace."""
    if cfg.dataflow not in ("medium", "coarse"):
        raise ValueError(f"unknown dataflow {cfg.dataflow!r}")
    dag = air.part.dag
    n, p = dag.n, cfg.num_cus
    scale = dag.scale
    task_lists = air.task_lists
    owner = air.owner
    consumers = air.part.consumers

    nodes: list[_Node] = []
    for i in range(n):
        srcs, weights = dag.node(i)
        nodes.append(_Node(i, int(owner[i]), srcs, weights,
                           edge0=int(dag.ptr[i])))

    cus = [_CU(c, dag.name, task_lists[c], cfg.psum_words) for c in range(p)]
    startable: list[dict[int, int]] = [dict() for _ in range(p)]  # pos -> nid
    for nd in nodes:
        if nd.pending == 0:
            c = nd.owner
            startable[c][cus[c].pos_of[nd.nid]] = nd.nid

    ops_t, val_t, src_t, pct_t, psl_t = [], [], [], [], []
    stream: list[float] = []
    # value provenance, parallel to `stream`: entry >= 0 is a global edge
    # index into dag.weight, entry < 0 encodes node id -(i+1) whose scale
    # was streamed (the values-only recompile path reads this plane)
    stream_src: list[int] = []
    stats = ScheduleStats(name=dag.name, n=n, nnz=dag.nnz, cycles=0,
                          exec_edges=0, exec_finals=0)

    bank_state = icr.BankSpillState(cfg)
    icr_seconds = 0.0

    solved_total = 0
    cycle = 0
    stall_streak = 0
    max_cycles = 8 * dag.nnz + 64 * n + 4096

    while solved_total < n:
        if cycle > max_cycles:
            raise RuntimeError(f"scheduler did not converge on {dag.name}")
        op_row = np.zeros(p, dtype=np.uint8)
        val_row = np.zeros(p, dtype=np.int32)
        src_row = np.zeros(p, dtype=np.int32)
        pct_row = np.zeros(p, dtype=np.uint8)
        psl_row = np.zeros(p, dtype=np.uint8)

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

            if cfg.dataflow == "coarse":
                cu.advance_head()
                if cur_live and cur.has_work():
                    kind = "edge" if cur.ready else "final"
                    chosen[c] = (kind, cur, PS_KEEP, 0)
                elif not cur_live and cu.head < len(cu.tasks):
                    nd = nodes[cu.tasks[cu.head]]
                    if nd.pending == 0:
                        kind = "edge" if nd.ready else "final"
                        chosen[c] = (kind, nd, PS_RESET, 0)
                    else:
                        nop_kind[c] = "d"
                else:
                    nop_kind[c] = "d"
                continue

            picked: tuple[str, _Node] | None = None
            for nd in cu.cached:  # cached nodes have absolute priority
                if nd.has_work():
                    picked = ("resume", nd)
                    break
            if picked is None and cur_live and cur.has_work():
                picked = ("continue", cur)
            if picked is None and startable[c] and (cfg.psum_cache or not cur_live):
                pos = min(startable[c])
                picked = ("start", nodes[startable[c][pos]])
            if picked is None:
                # deadlock escape (also required with psum_cache=False: a
                # blocked current node can circularly wait on unstarted
                # nodes — see module docstring)
                if stall_streak >= 2 and cur_live and startable[c]:
                    pos = min(startable[c])
                    nd = nodes[startable[c][pos]]
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
                    need = 1 if first_new else 2
                    if len(cu.free_slots) < need:
                        if stall_streak >= 2:
                            # emergency psum overflow park (DESIGN.md §5)
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

            pct_row[c] = ctrl
            psl_row[c] = slot

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
                val_row[c] = len(stream)
                stream.append(float(nd.val_of[s]))
                stream_src.append(nd.gidx_of[s])
                src_row[c] = s
                stats.exec_edges += 1
            else:
                op_row[c] = OP_FINAL
                val_row[c] = len(stream)
                stream.append(float(scale[nd.nid]))
                stream_src.append(-(nd.nid + 1))
                src_row[c] = nd.nid  # FINAL writes x[src]: out_idx is derived
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

        # dense trace: stall rows (executed == 0) are kept here — the
        # stall-elide pass drops them from the emitted stream
        ops_t.append(op_row)
        val_t.append(val_row)
        src_t.append(src_row)
        pct_t.append(pct_row)
        psl_t.append(psl_row)
        cycle += 1

    stats.cycles = cycle
    stats.per_cu_edges = np.array([cu.edge_count for cu in cus])
    num_slots = max(cu.next_over for cu in cus)

    metrics = {
        "dataflow": cfg.dataflow,
        "hardware_cycles": cycle,
        "exec_edges": stats.exec_edges,
        "exec_finals": stats.exec_finals,
        "dm_escapes": stats.dm_escapes,
        "psum_slots_used": num_slots,
        "spilled_values": stats.spilled_values,
    }
    icr_metrics = dict(bank_state.metrics(stats, cfg),
                       seconds=round(icr_seconds, 6))
    return ScheduleIR(
        name=dag.name, n=n,
        ops=np.stack(ops_t), val_idx=np.stack(val_t), src=np.stack(src_t),
        ctl=np.stack(pct_t), slot=np.stack(psl_t),
        stream=np.array(stream, dtype=np.float64),
        num_slots=num_slots, stats=stats, metrics=metrics,
        icr_metrics=icr_metrics,
        stream_src=np.array(stream_src, dtype=np.int64),
    )
