"""Compiler-side wrapper: run a compiled `Program` through the Hopper kernels.

Ports `repro/kernels/sptrsv/ops.py`.  Two placements of the solve state:

  * ``resident`` — every CTA holds the whole padded x vector of its RHS
    columns (`kernel.sptrsv_cuda`), in shared memory where it fits, else in
    device memory;
  * ``blocked``  — every CTA holds a ring of x rows (the power of two at
    or above ``window``) in shared memory that slides ``stride`` rows per
    cycle block over x and b in device memory, and a staging area for the
    ``stride`` rows of b that enter at the next boundary
    (`kernel.sptrsv_cuda_blocked`).  Shared memory is then bounded by the
    window, not by n.

What a CTA holds is sized per column tile (``cols_per_cta`` RHS columns per
CTA, one warp per column: its x rows, psum register file and instruction
stream ring) against ``smem_limit_bytes`` of shared memory, by default the
227 KB a Hopper CTA can use.  Solvers take `COLS_PER_CTA` = 1: the
columns' warps never wait on each other, so more columns per CTA only
share an SM's issue slots (2 and 4 measured no faster on the H100), and
one column per CTA spreads a batch over the most SMs.  ``placement="auto"``
keeps the resident placement while its x fits in shared memory, goes
blocked beyond that when the program's row envelope admits a window
(`plan_window`) that fits, and otherwise stays resident with x in device
memory.

Staging does what the hardware's stream memory does: values are gathered
per instruction word so the kernels stream them positionally, NOP lanes'
values are zeroed, and the packed words (``Program.instr``, ``[T, planes,
P]`` int32) are padded to the cycle-block multiple.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.errors import PlacementInfeasibleError
from repro_torch.core.executor import _psum_slots, as_batch
from repro_torch.core.program import SRC_BITS, Program, decode_instructions
from repro_torch.kernels.common import resolve_device
from repro_torch.spans import span

from .kernel import (
    MAX_SMEM_BYTES,
    ring_rows,
    smem_bytes_per_column,
    sptrsv_cuda,
    sptrsv_cuda_blocked,
)

__all__ = [
    "solve",
    "plan_window",
    "resolve_placement",
    "build_solver_cols",
    "instr_buffer_bytes",
    "state_bytes",
    "WindowPlan",
    "DEFAULT_SMEM_BYTES",
    "COLS_PER_CTA",
]

# shared memory a Hopper CTA can use (dynamic, after opting in): 227 KB
DEFAULT_SMEM_BYTES = MAX_SMEM_BYTES
COLS_PER_CTA = 1  # RHS columns per CTA of the solvers (module docstring)

_ROW_ALIGN = 8  # window/stride row granularity (as in the JAX package)


@dataclasses.dataclass(frozen=True)
class WindowPlan:
    """A feasible sliding-window placement for the blocked kernel.

    Cycle block g executes against x/b rows ``[g*stride, g*stride +
    window)``; ``n_hbm`` is the padded device-memory row count covering the
    full window sweep.  ``feasible=False`` carries a human-readable
    ``reason`` (the auto path then takes the resident placement).
    """

    feasible: bool
    stride: int = 0
    window: int = 0
    n_hbm: int = 0
    num_blocks: int = 0
    reason: str = ""

    def x_words(self) -> int:
        """x words of one column in shared memory: the ring of
        `kernel.ring_rows` rows and the staging area of ``stride`` rows of
        b."""
        return ring_rows(self.window) + self.stride

    def state_bytes(self, nb: int) -> int:
        """Shared-memory bytes of the x rows of one CTA holding ``nb``
        columns (`x_words` each)."""
        return self.x_words() * nb * 4


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def plan_window(
    prog: Program,
    cycles_per_block: int = 128,
    min_window: int | None = None,
) -> WindowPlan:
    """Derive a (stride, window) pair from the program's row-range metadata.

    The compiler records, per cycle, the min/max solution row any active
    lane touches (`Program.row_lo/row_hi`).  Reducing those over each cycle
    block gives the block's touched-row envelope ``[lo_g, hi_g]``; the
    window for block g is placed at base ``g * stride``, so feasibility
    requires ``g*stride <= lo_g`` and ``hi_g < g*stride + window`` for all
    g.  The stride is maximized (smallest window), then the window sized to
    the worst block — both rounded to the f32 sublane granularity.

    Programs whose row envelope does not advance monotonically enough
    (e.g. circuit matrices with hub columns read across the whole DAG)
    yield ``feasible=False``; such DAGs genuinely need the whole x vector
    live and must use the resident placement.
    """
    if prog.row_lo is None or prog.row_hi is None:
        return WindowPlan(False, reason="program has no row-range metadata "
                                        "(recompile with this version)")
    t = prog.cycles
    g = -(-t // cycles_per_block)
    lo = np.full(g * cycles_per_block, prog.n, dtype=np.int64)
    hi = np.full(g * cycles_per_block, -1, dtype=np.int64)
    lo[:t] = prog.row_lo
    hi[:t] = prog.row_hi
    lo = lo.reshape(g, cycles_per_block).min(axis=1)
    hi = hi.reshape(g, cycles_per_block).max(axis=1)
    nonempty = hi >= 0

    stride = prog.n
    for gi in range(1, g):
        if nonempty[gi]:
            stride = min(stride, int(lo[gi]) // gi)
    stride -= stride % _ROW_ALIGN
    if g > 1 and stride <= 0:
        return WindowPlan(False, reason="row envelope not monotone: an "
                                        "early row stays live across the "
                                        "whole schedule")
    if g == 1:
        stride = _ROW_ALIGN  # unused by a single-block sweep, but traced

    w_req = 0
    for gi in range(g):
        if nonempty[gi]:
            w_req = max(w_req, int(hi[gi]) - gi * stride + 1)
    window = max(w_req, 2 * stride, min_window or 0, 2 * _ROW_ALIGN)
    window = _round_up(window, _ROW_ALIGN)
    n_hbm = (g - 1) * stride + window
    return WindowPlan(True, stride=stride, window=window, n_hbm=n_hbm,
                      num_blocks=g)


def instr_buffer_bytes(prog: Program) -> int:
    """Instruction bytes one column's warp holds in shared memory.

    The stream ring: `kernel.stream_ring_cycles` cycles of the packed words
    and the value of every lane, the lanes padded to a multiple of 32:
    ``R * 32 * lanes_per_thread * (4 * planes + 4)`` with R =
    `kernel.stream_ring_cycles`.
    """
    return smem_bytes_per_column(prog.num_cus, prog.planes, num_slots=0)


def state_bytes(prog: Program, cols_per_cta: int = COLS_PER_CTA, *, placement: str,
                plan: WindowPlan | None = None) -> dict:
    """Shared memory of one CTA holding ``cols_per_cta`` RHS columns.

    Returns ``{"x": ..., "rf": ..., "stream": ..., "total": ...}`` bytes:
    the x rows (the whole padded vector for ``"resident"``; the ring and
    the b staging area for ``"blocked"``, which needs the `WindowPlan`),
    the psum register file and the instruction stream ring
    (`instr_buffer_bytes`), each for all the CTA's columns.
    """
    if placement == "blocked":
        if plan is None or not plan.feasible:
            raise ValueError("blocked accounting needs a feasible WindowPlan")
        x = plan.state_bytes(cols_per_cta)
    elif placement == "resident":
        x = (prog.n + 1) * cols_per_cta * 4
    else:
        raise ValueError(f"unknown placement {placement!r}")
    stream = instr_buffer_bytes(prog) * cols_per_cta
    rf = smem_bytes_per_column(prog.num_cus, prog.planes, _psum_slots(prog)) \
        * cols_per_cta - stream
    return {"x": x, "rf": rf, "stream": stream, "total": x + rf + stream}


def resolve_placement(
    prog: Program,
    nb: int,
    *,
    placement: str = "auto",
    smem_limit_bytes: int | None = None,
    cycles_per_block: int = 128,
    x_block_rows: int | None = None,
    cols_per_cta: int = COLS_PER_CTA,
) -> tuple[str, WindowPlan | None]:
    """Pick ``("resident", None)`` or ``("blocked", plan)`` for a solve.

    ``placement`` forces a regime; ``"blocked"`` raises
    `PlacementInfeasibleError` when the program's row envelope admits no
    window or the window does not fit ``smem_limit_bytes`` (``None`` ->
    `DEFAULT_SMEM_BYTES`) per CTA.  ``"auto"`` stays resident while the
    resident state of one CTA fits, and goes blocked only when a window
    exists and fits.  ``nb`` RHS columns are split into CTAs of
    ``cols_per_cta`` columns.  ``x_block_rows`` floors the planned window
    (the planner still enlarges it to whatever the schedule requires).
    """
    if smem_limit_bytes is None:
        smem_limit_bytes = DEFAULT_SMEM_BYTES
    if cols_per_cta < 1 or nb % cols_per_cta:
        raise ValueError(f"cols_per_cta={cols_per_cta} must divide the "
                         f"{nb} RHS columns")
    if placement == "resident":
        return "resident", None
    if placement not in ("auto", "blocked"):
        raise ValueError(f"unknown placement {placement!r}")
    plan = plan_window(prog, cycles_per_block, min_window=x_block_rows)
    fits = plan.feasible and state_bytes(
        prog, cols_per_cta, placement="blocked", plan=plan,
    )["total"] <= smem_limit_bytes
    if placement == "blocked":
        if not fits:
            reason = plan.reason or (
                f"a window of {plan.window} rows x {cols_per_cta} columns "
                f"does not fit {smem_limit_bytes} bytes of shared memory")
            raise PlacementInfeasibleError(
                f"row-blocked placement infeasible: {reason}",
                detail={"reason": reason})
        return "blocked", plan
    resident = state_bytes(prog, cols_per_cta, placement="resident")["total"]
    if resident <= smem_limit_bytes or not fits:
        return "resident", None
    return "blocked", plan


def _pad_to(arr: np.ndarray, t_pad: int, fill=0) -> np.ndarray:
    t = arr.shape[0]
    if t == t_pad:
        return arr
    out = np.full((t_pad,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[:t] = arr
    return out


def _stage_instructions(prog: Program, cycles_per_block: int):
    """Pad the packed instruction words and pre-gather the stream values.

    The program already carries the packed ``[T, planes, P]`` words — the
    pack happens once at compile time; staging only pads to the cycle-block
    multiple (pad rows are the all-NOP word 0) and gathers the f32 values
    per instruction slot so the kernel streams them positionally.
    """
    t = prog.cycles
    t_pad = _round_up(t, cycles_per_block)
    values = prog.stream[prog.val_idx]          # [T, P] pre-gathered
    # transient decode for the NOP mask (don't touch the prog.opcode
    # property: it would pin all four decoded planes on the Program)
    op = decode_instructions(prog.instr, prog.planes)[0]
    values = values * (op != 0)                 # NOP lanes -> 0.0
    instr = _pad_to(prog.instr, t_pad)          # [T_pad, planes, P]
    return instr, _pad_to(values.astype(np.float32), t_pad)


def _check_stream(instr: np.ndarray, n_slots: int, n_rows: int,
                  plan: WindowPlan | None, cycles_per_block: int) -> None:
    """Check the staged words against what the kernels may touch.

    The kernels load the psum slot and the x row of every word, NOP and
    padding words included (row 0 and slot 0), and index shared memory with
    them unchecked (the slot as the word's bits from the slot field up), so
    a word with bits past its packed fields, a slot past the psum register
    file, a row past x, or an active word outside its block's window is
    refused here, once per staging.
    """
    planes = instr.shape[1]
    upper = instr[:, 0] >> SRC_BITS if planes == 1 else instr[:, 1]
    if (instr[:, 0] < 0).any() or (upper >> 13).any():
        raise ValueError("instruction words carry bits past their packed fields")
    op, src, _, slot = decode_instructions(instr, planes)
    if (slot >= n_slots).any():
        raise ValueError(f"instruction stream addresses a psum slot beyond "
                         f"the {n_slots} the register file holds")
    if (src >= n_rows).any():
        raise ValueError("instruction stream names a row past the x rows")
    if plan is None:
        return
    block = np.arange(instr.shape[0])[:, None] // cycles_per_block
    lo = block * plan.stride
    hi = lo + plan.window
    if ((src < lo) | (src >= hi))[op != 0].any():
        raise ValueError("instruction stream touches a row outside the x "
                         "rows its cycle may address")


def build_solver_cols(
    prog: Program,
    width: int,
    *,
    cycles_per_block: int = 128,
    placement: str = "auto",
    smem_limit_bytes: int | None = None,
    x_block_rows: int | None = None,
    device=None,
):
    """Build a ``solve(b[n, width]) -> x[n, width]`` closure on ``device``.

    Stages the instruction tensors once (device-resident across calls),
    resolves the memory placement, and returns a closure for the
    per-(program, knobs, device) executor cache
    (`executor.make_cuda_executor`).  The chosen regime is exposed as
    ``closure.placement`` / ``closure.plan`` / ``closure.x_in_smem``.
    """
    dev = resolve_device(device)
    if smem_limit_bytes is None:
        smem_limit_bytes = DEFAULT_SMEM_BYTES
    mode, plan = resolve_placement(
        prog, width, placement=placement, smem_limit_bytes=smem_limit_bytes,
        cycles_per_block=cycles_per_block, x_block_rows=x_block_rows,
    )
    instr_np, values_np = _stage_instructions(prog, cycles_per_block)
    n = prog.n
    n_slots = _psum_slots(prog)
    n_rows = (n + 1) if mode == "resident" else plan.n_hbm
    _check_stream(instr_np, n_slots, n_rows, plan, cycles_per_block)
    instr = torch.from_numpy(instr_np).to(dev)
    values = torch.from_numpy(values_np).to(dev)
    x_in_smem = mode == "blocked" or state_bytes(
        prog, placement="resident")["total"] <= smem_limit_bytes

    def solve_cols(bmat: torch.Tensor) -> torch.Tensor:
        with span("sptrsv.rhs_stage"):
            bp = torch.zeros((n_rows, width), dtype=torch.float32, device=dev)
            bp[:n] = bmat
        with span("sptrsv.launch"):
            if mode == "resident":
                x = sptrsv_cuda(instr, values, bp, num_slots=n_slots,
                                x_in_smem=x_in_smem, cols_per_cta=COLS_PER_CTA)
            else:
                x = sptrsv_cuda_blocked(
                    instr, values, bp, window=plan.window, stride=plan.stride,
                    cycles_per_block=cycles_per_block, num_slots=n_slots,
                    cols_per_cta=COLS_PER_CTA)
        return x[:n]

    solve_cols.placement = mode
    solve_cols.plan = plan
    solve_cols.x_in_smem = x_in_smem
    solve_cols.staged = (instr, values)
    return solve_cols


def solve(
    prog: Program,
    b: np.ndarray,
    *,
    cycles_per_block: int = 128,
    placement: str = "auto",
    smem_limit_bytes: int | None = None,
    x_block_rows: int | None = None,
    device=None,
) -> np.ndarray:
    """Solve Lx=b by executing `prog` in the Hopper kernels.

    ``b`` may be ``[n]`` (single RHS) or ``[n, B]`` (batched multi-RHS);
    the result has the matching shape.  The batch axis is padded to a
    lane-friendly width (`executor.pad_batch`) and the solver is cached per
    (program, padded width, placement knobs, device).  ``device=None`` is
    the CUDA device; ``device="cpu"`` runs the kernels' plain versions.
    """
    from repro_torch.core.executor import make_cuda_executor

    bmat, single = as_batch(b)
    solver = make_cuda_executor(
        prog, batch=bmat.shape[1], cycles_per_block=cycles_per_block,
        placement=placement, smem_limit_bytes=smem_limit_bytes,
        x_block_rows=x_block_rows, device=device,
    )
    x = solver(bmat).cpu().numpy()
    return x[:, 0] if single else x
