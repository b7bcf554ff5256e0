"""Schedule hazard/race detector — the single implementation (DESIGN.md §8).

Every check the executors' correctness rests on, run statically over a
`TraceView` (dense `ScheduleIR`, elided `EmitIR`, or packed `Program` —
`trace.py` adapts all three):

  * SPT105 — an active lane reads a solution row ``>= n``;
  * SPT113 — a slot-using lane addresses beyond the psum register file;
  * SPT110 — a solution row finalized zero or multiple times;
  * SPT111 — RAW hazard: an EDGE reads ``x[src]`` in a cycle not strictly
    after the FINAL that writes it;
  * SPT108 — a FINAL lane streams a zero diagonal reciprocal;
  * SPT112 — psum slot lifetime races per CU: a LOAD/SWAP reading a slot
    no earlier STORE/SWAP filled (use-before-def), and a STORE_RESET
    overwriting a slot still live (WAW);
  * SPT114 — ``row_lo/row_hi`` envelope metadata that does not re-derive
    from the instruction words it summarizes;
  * SPT115 — more distinct x-reads in one cycle than the banked
    interconnect has banks (requires an `AccelConfig`).

`packed_structure` validates what must hold before a packed `Program` can
even be decoded (tensor shapes, field bit-widths, encodings, zero NOP
words, stream/val_idx sanity).  `core.robust.verify_program` is a thin
wrapper over these two functions — diagnostic messages are the historical
`ProgramCorruptionError` messages verbatim, so callers that match on them
keep working.
"""

from __future__ import annotations

import numpy as np

from ..program import (
    OP_EDGE,
    OP_FINAL,
    OP_NOP,
    PS_LOAD,
    PS_STORE_RESET,
    PS_SWAP,
    Program,
    decode_instructions,
    validate_fields,
)
from .diagnostics import SEV_ERROR, Diagnostic
from .trace import TraceView

__all__ = ["packed_structure", "trace_hazards", "envelope_diags"]


def _err(code: str, message: str, *, pass_name: str = "program",
         cycle=None, cu=None, node=None, hint: str = "", **detail):
    return Diagnostic(code=code, severity=SEV_ERROR, message=message,
                      pass_name=pass_name, cycle=cycle, cu=cu, node=node,
                      hint=hint, detail=detail)


# ---------------------------------------------------------------------------
# packed-tensor structure (Program only)
# ---------------------------------------------------------------------------
def packed_structure(prog: Program):
    """Validate the packed tensors of a `Program` ahead of decoding.

    Returns ``(diagnostics, decodable, values_ok)``: ``decodable`` is False
    when the instruction words cannot be trusted enough to run the hazard
    detector over them; ``values_ok`` is False when value-dependent checks
    (the zero-reciprocal scan) must be skipped because ``val_idx`` points
    outside the stream.
    """
    diags: list[Diagnostic] = []
    instr = np.asarray(prog.instr)
    if instr.ndim != 3 or instr.dtype != np.int32:
        diags.append(_err("SPT101", f"instr must be [T, planes, P] int32, "
                          f"got {instr.shape} {instr.dtype}",
                          hint="recompile; do not execute"))
        return diags, False, False
    t, planes, p = instr.shape
    if planes not in (1, 2):
        diags.append(_err("SPT101", f"planes must be 1 or 2, got {planes}"))
        return diags, False, False
    vidx = np.asarray(prog.val_idx)
    if vidx.shape != (t, p):
        diags.append(_err("SPT101", f"val_idx shape {vidx.shape} != instr "
                          f"rows {(t, p)}"))
        return diags, False, False
    stream = np.asarray(prog.stream)
    if stream.ndim != 1:
        diags.append(_err("SPT101", f"stream must be 1-D, got shape "
                          f"{stream.shape}"))
        return diags, False, False

    values_ok = True
    if not np.isfinite(stream).all():
        bad = int(np.count_nonzero(~np.isfinite(stream)))
        diags.append(_err("SPT107", f"stream carries {bad} non-finite "
                          f"value(s)", non_finite=bad,
                          hint="value plane corrupt: re-fetch or recompile"))
    if vidx.size and (vidx.min() < 0 or vidx.max() >= stream.size):
        diags.append(_err("SPT106", f"val_idx out of stream bounds "
                          f"[0, {stream.size})",
                          lo=int(vidx.min()), hi=int(vidx.max())))
        values_ok = False

    op, src, ctl, slot = decode_instructions(instr, planes)
    try:
        validate_fields(op, src, ctl, slot, planes)
    except ValueError as e:
        diags.append(_err("SPT102", f"packed field range: {e}"))
        return diags, False, values_ok
    if int(op.max(initial=0)) > OP_FINAL:
        diags.append(_err("SPT103", f"invalid opcode {int(op.max())} "
                          f"(beyond OP_FINAL)"))
        return diags, False, values_ok
    if int(ctl.max(initial=0)) > PS_SWAP:
        diags.append(_err("SPT103", f"invalid psum control {int(ctl.max())} "
                          f"(beyond PS_SWAP)"))
        return diags, False, values_ok

    # NOP lanes are all-zero words by construction (pad rows, elided
    # lanes); a non-zero NOP word means bits were flipped into fields the
    # executor still applies (the psum control runs on every lane).
    nop_nonzero = (op == OP_NOP) & (instr != 0).any(axis=1)
    if nop_nonzero.any():
        tt, pp = np.argwhere(nop_nonzero)[0]
        diags.append(_err("SPT104", f"NOP lane carries a non-zero word at "
                          f"cycle {tt}, cu {pp}",
                          cycle=int(tt), cu=int(pp)))
    return diags, True, values_ok


# ---------------------------------------------------------------------------
# hazard detector (any TraceView)
# ---------------------------------------------------------------------------
def trace_hazards(v: TraceView, cfg=None, *,
                  check_values: bool = True) -> list[Diagnostic]:
    """Run every schedule hazard check over ``v``; returns diagnostics.

    Checks run in the canonical order (module docstring) and each reports
    its first instance with a count in ``detail`` — `robust.verify_program`
    raises the first error, the linter shows them all.  ``cfg`` (an
    `AccelConfig`) enables the bank-pressure check; ``check_values=False``
    skips the stream-value scan (caller already reported bad indices).
    """
    diags: list[Diagnostic] = []
    blame = dict(pass_name=v.origin)
    op, src, ctl, slot = v.op, v.src, v.ctl, v.slot
    t, p = op.shape
    n = v.n
    active = op != OP_NOP

    # SPT105 — solution-row bounds
    src_ok = True
    if active.any() and int(src[active].max()) >= n:
        src_ok = False
        diags.append(_err("SPT105", f"active lane reads row >= n={n}",
                          row=int(src[active].max()), **blame))

    # SPT113 — psum register-file capacity
    uses_slot = (ctl == PS_LOAD) | (ctl == PS_STORE_RESET) | (ctl == PS_SWAP)
    if uses_slot.any() and int(slot[uses_slot].max()) >= v.num_slots:
        diags.append(_err("SPT113", f"psum slot "
                          f"{int(slot[uses_slot].max())} >= register file "
                          f"size {v.num_slots}", num_slots=v.num_slots,
                          hint="raise AccelConfig.psum_words or split "
                               "heavy nodes", **blame))

    # SPT110 — every solution row finalized exactly once
    is_final = op == OP_FINAL
    finals = src[is_final]
    hi = max(n, (int(finals.max()) + 1) if finals.size else n)
    counts = np.bincount(finals, minlength=hi) if finals.size else \
        np.zeros(hi, dtype=np.int64)
    if finals.size != n or (counts[:n] != 1).any():
        row = int(np.argmax(counts[:n] != 1))
        diags.append(_err("SPT110", f"row {row} finalized "
                          f"{int(counts[row])} times (every row must be "
                          f"finalized exactly once)", node=row, row=row,
                          **blame))

    # SPT111 — RAW hazard: EDGE at cycle t reads x[src] => src FINAL'd at
    # some cycle < t
    cyc = np.broadcast_to(np.arange(t)[:, None], (t, p))
    final_cycle = np.full(hi, t, dtype=np.int64)
    final_cycle[finals] = cyc[is_final]
    edges = op == OP_EDGE
    if edges.any():
        viol = final_cycle[src[edges]] >= cyc[edges]
        if viol.any():
            k = int(np.argmax(viol))
            row = int(src[edges][k])
            diags.append(_err(
                "SPT111",
                f"dependency order: an EDGE reads x[{row}] at cycle "
                f"{int(cyc[edges][k])} but row {row} is finalized at cycle "
                f"{int(final_cycle[row])}",
                cycle=int(cyc[edges][k]), node=row, row=row,
                count=int(viol.sum()), **blame))

    # SPT108 — FINAL stream values are diagonal reciprocals; zero divides out
    if check_values and is_final.any():
        vi = v.val_idx[is_final]
        if vi.size == 0 or (vi.min() >= 0 and vi.max() < v.stream.size):
            fvals = v.stream[vi]
            if (fvals == 0).any():
                diags.append(_err("SPT108", "FINAL lane carries a zero "
                                  "diagonal reciprocal",
                                  count=int((fvals == 0).sum()), **blame))

    # SPT112 — psum slot lifetimes, per CU: LOAD/SWAP read a live slot;
    # STORE/SWAP fill it; LOAD consumes it; STORE over a live slot is a
    # WAW race.  Vectorized liveness replay over the sparse psum events
    # (per-(cu, slot) prefix sums); the python event loop only runs to
    # attribute violations once the fast path found one.
    ev_t, ev_p = np.nonzero(ctl)
    if ev_t.size and _psum_lifetime_broken(ctl, slot, ev_t, ev_p):
        diags += _psum_lifetime_diags(ctl, slot, ev_t, ev_p, blame)

    # SPT114 — row-envelope metadata re-derived from the words it summarizes
    if src_ok:
        diags += envelope_diags(v, blame)

    # SPT115 — banked-read pressure: every distinct x-read address in a
    # cycle needs its own bank; more distinct reads than banks cannot issue
    if cfg is not None and edges.any():
        read = np.where(edges, src, -1)
        read.sort(axis=1)
        distinct = (np.diff(read, axis=1) > 0).sum(axis=1) + (read[:, -1] >= 0)
        over = distinct > cfg.num_banks
        if over.any():
            tt = int(np.argmax(over))
            diags.append(_err("SPT115", f"cycle {tt} reads "
                              f"{int(distinct[tt])} distinct x rows but the "
                              f"interconnect has {cfg.num_banks} banks",
                              cycle=tt, count=int(over.sum()),
                              hint="the ICR/bank model cannot issue this "
                                   "row; reschedule", **blame))
    return diags


def envelope_diags(v: TraceView, blame: dict | None = None) -> list:
    """SPT114 — ``row_lo/row_hi`` must re-derive from the instruction words.

    Split out of `trace_hazards` so the per-pass verifiers can run just
    this check on a trace whose planes are already proven identical to a
    verified upstream IR (the envelope metadata is the only field such a
    trace adds).  Callers must have established ``src < n`` first.
    """
    if v.row_lo is None or v.row_hi is None:
        return []
    blame = blame if blame is not None else dict(pass_name=v.origin)
    active = v.op != OP_NOP
    lo = np.where(active, v.src, v.n).min(axis=1).astype(np.int32)
    hi_env = np.where(active, v.src, -1).max(axis=1).astype(np.int32)
    if np.array_equal(lo, v.row_lo) and np.array_equal(hi_env, v.row_hi):
        return []
    bad = int(np.argmax((lo != v.row_lo) | (hi_env != v.row_hi)))
    return [_err("SPT114", f"row-envelope metadata inconsistent with the "
                 f"instruction words at cycle {bad}", cycle=bad,
                 hint="window planning would misplace the shared-memory window; "
                      "recompile", **blame)]


def _psum_lifetime_broken(ctl, slot, ev_t, ev_p) -> bool:
    """Vectorized liveness replay; True when any SPT112 race exists.

    Events are grouped by (cu, slot) in time order; ``delta`` (+1 STORE,
    -1 LOAD, 0 SWAP/RESET) prefix-summed within each group gives the
    post-event liveness, and every op pins what that liveness must be:
    a STORE must land on a free slot (post == 1), a LOAD must consume a
    live one (post == 0), a SWAP must read-and-refill a live one
    (post == 1).  RESET never touches the slot.
    """
    ev_c = ctl[ev_t, ev_p]
    ev_s = slot[ev_t, ev_p].astype(np.int64)
    order = np.lexsort((ev_t, ev_s, ev_p))  # (cu, slot) groups, time asc
    c = ev_c[order]
    key = ev_p[order].astype(np.int64) * (int(ev_s.max()) + 1) + ev_s[order]
    new_grp = np.empty(len(order), dtype=bool)
    new_grp[0] = True
    new_grp[1:] = key[1:] != key[:-1]
    delta = np.where(c == PS_STORE_RESET, 1,
                     np.where(c == PS_LOAD, -1, 0))
    cs = np.cumsum(delta)
    start = np.maximum.accumulate(np.where(new_grp, np.arange(len(order)), 0))
    post = cs - (cs - delta)[start]  # liveness after each event, per group
    viol = (((c == PS_STORE_RESET) & (post != 1))
            | ((c == PS_LOAD) & (post != 0))
            | ((c == PS_SWAP) & (post != 1)))
    return bool(viol.any())


def _psum_lifetime_diags(ctl, slot, ev_t, ev_p, blame) -> list:
    """Exact event replay attributing SPT112 races (legacy report order:
    per CU in cycle order, first instance of each race reported)."""
    diags = []
    order = np.lexsort((ev_t, ev_p))
    live: set[tuple[int, int]] = set()
    for k in order:
        c = int(ctl[ev_t[k], ev_p[k]])
        s = int(slot[ev_t[k], ev_p[k]])
        pp, tt = int(ev_p[k]), int(ev_t[k])
        key = (pp, s)
        if c in (PS_LOAD, PS_SWAP) and key not in live:
            diags.append(_err("SPT112", f"psum lifetime: cu {pp} reads "
                              f"slot {s} at cycle {tt} before any store",
                              cycle=tt, cu=pp, slot=s, **blame))
            live.add(key)  # treat as defined: report each race once
            continue
        if c == PS_STORE_RESET and key in live:
            diags.append(_err("SPT112", f"psum lifetime: cu {pp} stores "
                              f"slot {s} at cycle {tt} overwriting a live "
                              f"partial sum (WAW)",
                              cycle=tt, cu=pp, slot=s, **blame))
        if c in (PS_STORE_RESET, PS_SWAP):
            live.add(key)
        elif c == PS_LOAD:
            live.discard(key)
    return diags
