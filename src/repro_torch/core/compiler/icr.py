"""ICR-reorder pass: per-cycle intra-node edge computation reordering.

Implements §IV-C of the paper (Algorithm 2, exact: max-count category,
tie → min initial R-value) plus the two register-file models the chosen
sources are filtered through:

  * the online banked-read model — one distinct address per bank per
    cycle; identical addresses broadcast for free via the crossbar
    (bank assignment is online least-used first-fit, DESIGN.md §5);
  * the x_i register-file spill-reload model (§III-B live-range/spill).

This pass runs *per cycle*, interleaved with the psum-cache schedule
(`sched.py`): which edge each CU executes this cycle feeds back into the
next cycle's node state, so ICR cannot be a whole-program reordering.
The pipeline still reports it as its own stage — `BankSpillState` carries
the cross-cycle state and accumulates the pass metrics (constraints,
conflicts, broadcast reuse) into the shared `ScheduleStats`.
"""

from __future__ import annotations

import heapq
from collections import Counter

import numpy as np

from ..program import AccelConfig, ScheduleStats

__all__ = ["BankSpillState", "icr_assign", "assign_sources"]


def icr_assign(edge_cus, cands):
    """Algorithm 2 of the paper, exact, via a lazy max-heap.

    Returns {cu: src}.  Categories = distinct source nodes; repeatedly pick
    the category with the most remaining edges (tie -> smallest initial
    R-value, then smallest id), assign it to every CU that has it, remove
    those CUs, and recount.
    """
    cnt: Counter = Counter()
    cu_of_src: dict[int, list[int]] = {}
    for c in edge_cus:
        for s in cands[c]:
            cnt[s] += 1
            cu_of_src.setdefault(s, []).append(c)
    r_value = dict(cnt)
    heap = [(-v, r_value[s], s) for s, v in cnt.items()]
    heapq.heapify(heap)
    assigned: dict[int, int] = {}
    unassigned = set(edge_cus)
    while unassigned and heap:
        negv, _, s = heapq.heappop(heap)
        if cnt.get(s, 0) != -negv:
            continue  # stale entry
        for c in cu_of_src[s]:
            if c in unassigned:
                assigned[c] = s
                unassigned.discard(c)
                for s2 in cands[c]:
                    v = cnt.get(s2, 0)
                    if v > 0:
                        cnt[s2] = v - 1
                        if v > 1:
                            heapq.heappush(heap, (-(v - 1), r_value[s2], s2))
                        else:
                            del cnt[s2]
    return assigned


class BankSpillState:
    """Cross-cycle state of the ICR pass: bank map + per-pass counters."""

    __slots__ = ("bank_of", "bank_load", "bank_free_order")

    def __init__(self, cfg: AccelConfig):
        self.bank_of: dict[int, int] = {}
        self.bank_load = np.zeros(cfg.num_banks, dtype=np.int64)
        self.bank_free_order = list(range(cfg.num_banks))

    def metrics(self, stats: ScheduleStats, cfg: AccelConfig) -> dict:
        return {
            "icr": cfg.icr,
            "icr_window": cfg.icr_window,
            "distinct_reads": stats.distinct_reads,
            "reuse_events": stats.reuse_events,
            "constraints": stats.constraints,
            "conflicts": stats.conflicts,
            "banks_used": len(set(self.bank_of.values())),
            "spill_reload_stalls": stats.snop,
        }


def assign_sources(state: BankSpillState, cfg: AccelConfig,
                   stats: ScheduleStats, chosen, nop_kind, cus) -> dict:
    """One cycle of ICR + bank/spill filtering.

    ``chosen[c]`` is the psum-schedule pass's pick for CU ``c`` (or None);
    edge picks get a source assigned here.  CUs losing their pick to a
    bank conflict or a spill reload are demoted to NOPs in place (their
    ``chosen`` entry cleared, ``nop_kind`` set) — the replay happens next
    cycle.  Returns {cu: src} for the surviving edge lanes.
    """
    p = len(chosen)
    edge_cus = [c for c in range(p) if chosen[c] and chosen[c][0] == "edge"]
    assigned_src: dict[int, int] = {}
    if not edge_cus:
        return assigned_src
    w = cfg.icr_window
    cands = {c: chosen[c][1].ready[:w] for c in edge_cus}
    if cfg.icr:
        assigned_src = icr_assign(edge_cus, cands)
    else:
        for c in edge_cus:  # traditional ascending-source-id pick
            assigned_src[c] = min(chosen[c][1].ready)

    group = Counter(assigned_src.values())
    stats.distinct_reads += len(group)
    stats.reuse_events += sum(v - 1 for v in group.values())
    k = len(group)
    stats.constraints += k * (k - 1) // 2

    # banked-read model: one distinct address per bank per cycle;
    # identical addresses broadcast for free via the crossbar.
    used_banks: dict[int, int] = {}
    for s in sorted(group, key=lambda s_: (-group[s_], s_)):
        if s not in state.bank_of:
            free = [b for b in state.bank_free_order if b not in used_banks]
            pool = free if free else state.bank_free_order
            b = min(pool, key=lambda b_: (state.bank_load[b_], b_))
            state.bank_of[s] = b
            state.bank_load[b] += 1
        b = state.bank_of[s]
        if b in used_banks and used_banks[b] != s:
            for c in [c_ for c_, ss in assigned_src.items() if ss == s]:
                del assigned_src[c]
                chosen[c] = None
                nop_kind[c] = "b"
                stats.conflicts += 1
        else:
            used_banks[b] = s

    # x_i register-file spill-reload model
    for c in list(assigned_src):
        s = assigned_src[c]
        cu = cus[c]
        if s in cu.spilled:
            cu.spilled.discard(s)
            if len(cu.resident) >= cfg.xi_words:
                evict = min(cu.resident, key=cu.resident.get)
                cu.spilled.add(evict)
                del cu.resident[evict]
            cu.resident[s] = 1
            del assigned_src[c]
            chosen[c] = None
            nop_kind[c] = "s"
    return assigned_src
