"""Uniform cycle-trace view over `ScheduleIR`, `EmitIR`, and `Program`.

The hazard detector (`hazards.py`) works on decoded per-field planes; the
three artifacts that carry an instruction trace store them differently
(dense dataclass fields, elided dataclass fields, packed int32 words).
`TraceView` is the adapter: one frozen bundle of ``[T, P]`` field planes
plus the stream/metadata every check needs, tagged with the pipeline pass
(`origin`) a violation should blame.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..program import Program, decode_instructions

__all__ = ["TraceView", "view_schedule", "view_emit", "view_program"]


@dataclasses.dataclass(frozen=True)
class TraceView:
    """Decoded instruction trace + metadata, independent of its container."""

    origin: str            # pipeline pass blamed: "psum_schedule" |
                           # "stall_elide" | "program"
    name: str
    n: int
    op: np.ndarray         # [T, P] opcodes
    src: np.ndarray        # [T, P] solution-row index
    ctl: np.ndarray        # [T, P] psum control
    slot: np.ndarray       # [T, P] psum slot
    val_idx: np.ndarray    # [T, P] index into `stream`
    stream: np.ndarray     # [S]
    num_slots: int         # executor psum register-file size
    row_lo: np.ndarray | None = None   # [T] per-row envelopes (emitted only)
    row_hi: np.ndarray | None = None
    dense: bool = False    # True when stall rows are present (ScheduleIR)

    @property
    def cycles(self) -> int:
        return int(self.op.shape[0])

    @property
    def num_cus(self) -> int:
        return int(self.op.shape[1])


def view_schedule(sir) -> TraceView:
    """Dense `ScheduleIR` trace (stall rows included)."""
    return TraceView(
        origin="psum_schedule", name=sir.name, n=sir.n,
        op=np.asarray(sir.ops), src=np.asarray(sir.src),
        ctl=np.asarray(sir.ctl), slot=np.asarray(sir.slot),
        val_idx=np.asarray(sir.val_idx), stream=np.asarray(sir.stream),
        num_slots=sir.num_slots, dense=True,
    )


def view_emit(eir) -> TraceView:
    """Elided `EmitIR` trace (row envelopes attached)."""
    return TraceView(
        origin="stall_elide", name=eir.name, n=eir.n,
        op=np.asarray(eir.ops), src=np.asarray(eir.src),
        ctl=np.asarray(eir.ctl), slot=np.asarray(eir.slot),
        val_idx=np.asarray(eir.val_idx), stream=np.asarray(eir.stream),
        num_slots=eir.num_slots,
        row_lo=np.asarray(eir.row_lo), row_hi=np.asarray(eir.row_hi),
    )


def view_program(prog: Program) -> TraceView:
    """Packed `Program` decoded back into field planes.

    Assumes the packed structure already validated (`hazards.
    packed_structure`); the executor psum register-file size mirrors
    `executor._psum_slots` (config words + overflow, grown to what the
    compiler actually used).
    """
    from ..compiler.sched import PSUM_OVERFLOW_SLOTS

    op, src, ctl, slot = decode_instructions(prog.instr, prog.planes)
    nslots = max(prog.config.psum_words + PSUM_OVERFLOW_SLOTS,
                 prog.num_slots or 0)
    return TraceView(
        origin="program", name=prog.stats.name, n=prog.n,
        op=np.asarray(op), src=np.asarray(src), ctl=np.asarray(ctl),
        slot=np.asarray(slot), val_idx=np.asarray(prog.val_idx),
        stream=np.asarray(prog.stream), num_slots=nslots,
        row_lo=prog.row_lo, row_hi=prog.row_hi,
    )
