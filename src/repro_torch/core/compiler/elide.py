"""Stall-elide pass: dense `ScheduleIR` → emitted `EmitIR`.

Cycles in which no lane executes (bank-conflict replay, global psum
stalls) count as hardware time (``stats.cycles``) but carry no
information — an all-NOP row changes no state, so streaming it would be
pure instruction HBM traffic.  This pass drops them from the emitted
stream (``stats.emitted_cycles`` = rows kept) and computes each emitted
row's touched-solution-row envelope ``[row_lo, row_hi]`` (EDGE lanes read
x[src]; FINAL lanes read b[src] and write x[src]) — the metadata the
row-blocked Pallas placement plans its sliding VMEM window from
(DESIGN.md §1).
"""

from __future__ import annotations

import numpy as np

from .ir import EmitIR, ScheduleIR

__all__ = ["run"]


def run(sir: ScheduleIR) -> EmitIR:
    active = sir.ops != 0                       # [C, P]
    keep = active.any(axis=1)                   # a lane executed this cycle
    ops = sir.ops[keep]
    src = sir.src[keep]
    act = active[keep]
    n = sir.n
    row_lo = np.where(act, src, n).min(axis=1).astype(np.int32)
    row_hi = np.where(act, src, -1).max(axis=1).astype(np.int32)

    stats = sir.stats
    stats.emitted_cycles = int(keep.sum())
    metrics = {
        "hardware_cycles": int(keep.size),
        "emitted_cycles": stats.emitted_cycles,
        "stall_rows_elided": int(keep.size) - stats.emitted_cycles,
    }
    return EmitIR(
        name=sir.name, n=n,
        ops=ops, val_idx=sir.val_idx[keep], src=src,
        ctl=sir.ctl[keep], slot=sir.slot[keep],
        row_lo=row_lo, row_hi=row_hi,
        stream=sir.stream, num_slots=sir.num_slots,
        stats=stats, metrics=metrics,
        stream_src=sir.stream_src,
    )
