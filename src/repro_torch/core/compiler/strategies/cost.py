"""Analytic cost model over dense schedule traces (DESIGN.md §11).

The auto-select mode compares candidate schedules *before* emission, so
the model reads only what a dense `ScheduleIR` already states exactly:

  * ``cycles`` — the trace length IS the hardware cycle count (the
    compiler "fully predicts the behavior of the hardware", paper
    §III-B), so the prediction equals the emitted program's
    ``stats.cycles`` by construction;
  * ``stall_rows`` — all-NOP rows: hardware time that emits nothing;
  * ``psum_spills`` — STORE_RESET parks landing beyond the psum register
    file (the overflow region is modelled data memory: each park
    round-trips a partial sum through spill traffic);
  * ``planes`` — the packed-word layout the program will emit with; the
    two-plane large-n fallback doubles instruction HBM bytes per lane.

`CostEstimate.sort_key` is the auto-select ordering: predicted cycles
weighted by instruction bytes per lane-cycle (``4 * planes + 4``, see
`Program.instr_bytes_per_lane_cycle`), then spills, then stall rows.
All candidates of one matrix share ``n`` (hence ``planes``), so the
primary term reduces to plain predicted cycles — the weight only matters
when comparing across packings.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ...program import PS_STORE_RESET, AccelConfig, packed_planes
from ..ir import ScheduleIR

__all__ = ["CostEstimate", "predict_cycles"]


@dataclasses.dataclass(frozen=True)
class CostEstimate:
    """Predicted cost of one candidate schedule (see module docstring)."""

    strategy: str
    cycles: int        # == emitted stats.cycles, exactly
    stall_rows: int    # all-NOP rows inside those cycles
    psum_spills: int   # STORE_RESET parks into the overflow region
    planes: int        # packed-word layout the emission will choose

    def sort_key(self) -> tuple:
        """Auto-select ordering: lower is better, ties keep registry order."""
        return (self.cycles * (4 * self.planes + 4),
                self.psum_spills, self.stall_rows)

    def to_dict(self) -> dict:
        return {"cycles": self.cycles, "stall_rows": self.stall_rows,
                "psum_spills": self.psum_spills, "planes": self.planes}


def predict_cycles(sir: ScheduleIR,
                   cfg: AccelConfig | None = None) -> CostEstimate:
    """Predict the emitted program's cost from a dense schedule trace.

    The prediction is exact for ``cycles`` (the dense trace row count is
    the hardware cycle count the emitted ``stats.cycles`` reports) —
    pinned by `tests/test_strategies.py` — and exact for the spill/stall
    structure the trace already encodes.
    """
    cfg = cfg or AccelConfig()
    active = np.asarray(sir.ops) != 0
    spills = (active & (np.asarray(sir.ctl) == PS_STORE_RESET)
              & (np.asarray(sir.slot) >= cfg.psum_words))
    return CostEstimate(
        strategy=str(getattr(sir.stats, "schedule", "paper")),
        cycles=int(sir.ops.shape[0]),
        stall_rows=int((~active.any(axis=1)).sum()),
        psum_spills=int(spills.sum()),
        planes=packed_planes(sir.n),
    )
