"""Pack/emit pass: `EmitIR` → packed `Program`.

Packs the per-field instruction planes into the canonical single-word
int32 encoding (``src | op | ctl | slot`` — `program.pack_instructions`,
with the automatic two-plane fallback for n > 2^SRC_BITS) and assembles
the final `Program`.  Every downstream consumer — the numpy / `lax.scan`
executors, both Pallas placements, batching, sharding — sees only this
format, which is what lets every frontend workload run on them unchanged.
"""

from __future__ import annotations

import numpy as np

from ..program import AccelConfig, Program, pack_instructions, packed_planes
from .ir import EmitIR

__all__ = ["run"]


def run(eir: EmitIR, cfg: AccelConfig, planes: int | None = None) -> Program:
    instr = pack_instructions(
        eir.ops, eir.src, eir.ctl, eir.slot,
        planes=planes if planes is not None else packed_planes(eir.n),
    )
    return Program(
        num_slots=eir.num_slots,
        config=cfg,
        n=eir.n,
        instr=instr,
        val_idx=eir.val_idx,
        stream=np.array(eir.stream, dtype=np.float32),
        stats=eir.stats,
        row_lo=eir.row_lo,
        row_hi=eir.row_hi,
        stream_src=eir.stream_src,
    )
