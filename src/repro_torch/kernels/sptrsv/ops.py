"""Compiler-side wrapper: run a compiled `Program` through the Hopper kernels.

Ports `repro/kernels/sptrsv/ops.py`.  Two placements of the solve state:

  * ``resident`` — every CTA holds the whole padded x vector of its RHS
    columns (`kernel.sptrsv_cuda`), in shared memory where it fits; else
    the rows live at once, in a file of shared-memory slots that rows take
    and give back as the stream runs (`plan_slots`); else in device memory;
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
(`plan_window`) that fits, and otherwise stays resident: with x in a slot
file where the slots fit, else with x in device memory.

Staging does what the hardware's stream memory does: values are gathered
per instruction word so the kernels stream them positionally, NOP lanes'
values are zeroed, and the packed words (``Program.instr``, ``[T, planes,
P]`` int32) are padded to the cycle-block multiple.  For the blocked kernel
the stream is then lane-compacted where its busiest cycle leaves lanes
idle (`compact_lanes`): the warp runs fewer words a thread each cycle.
"""

from __future__ import annotations

import dataclasses
import heapq

import numpy as np
import torch

from repro_torch.core.errors import PlacementInfeasibleError
from repro_torch.core.executor import _psum_slots, as_batch
from repro_torch.core.program import OP_EDGE, OP_FINAL, SRC_BITS, Program, decode_instructions
from repro_torch.kernels.common import resolve_device
from repro_torch.spans import span

from .kernel import (
    COMPACT_WIDTHS,
    LANE_SHIFT,
    MAX_SMEM_BYTES,
    SLOT_FLUSH_LAG,
    SLOT_LIST,
    STREAM_CHUNK,
    SlotFile,
    ring_rows,
    slot_file_words,
    smem_bytes_per_column,
    sptrsv_cuda,
    sptrsv_cuda_blocked,
    stream_lead_chunks,
)

__all__ = [
    "solve",
    "plan_window",
    "resolve_placement",
    "build_solver_cols",
    "compact_lanes",
    "plan_slots",
    "instr_buffer_bytes",
    "state_bytes",
    "WindowPlan",
    "SlotPlan",
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


def compact_lanes(instr: np.ndarray, values: np.ndarray):
    """``(instr, values, width)``: the staged stream lane-compacted where
    that narrows what a warp runs, else unchanged with ``width`` = P.

    A word is live when its op or its psum control is not 0; every other
    word changes nothing.  W is the smallest of `kernel.COMPACT_WIDTHS`
    that holds the busiest cycle's live words, and the stream is compacted
    only when W < P: each cycle's live words, in lane order, take its first
    slots, as two planes (the row; the upper field with the word's lane
    from `kernel.LANE_SHIFT`), their values with them; the other slots are
    zero words.  `kernel.expand_lanes` gives back the stream.
    """
    t, planes, p = instr.shape
    if planes == 1:
        src, upper = instr[:, 0] & ((1 << SRC_BITS) - 1), instr[:, 0] >> SRC_BITS
    else:
        src, upper = instr[:, 0], instr[:, 1]
    live = (upper & 0x1F) != 0          # op or psum control
    counts = live.sum(axis=1)
    width = next((w for w in COMPACT_WIDTHS if w >= counts.max(initial=0)), p)
    if width >= p:
        return instr, values, p
    flat = np.flatnonzero(live)         # live words, cycle by cycle in lane order
    cyc, lane = np.divmod(flat, p)
    pos = np.arange(flat.size) - (np.cumsum(counts) - counts)[cyc]
    at = cyc * 2 * width + pos          # flat index of plane 0 in [T, 2, W]
    out = np.zeros(t * 2 * width, np.int32)
    out[at] = src.ravel()[flat]
    out[at + width] = upper.ravel()[flat] | (lane << LANE_SHIFT)
    vals = np.zeros(t * width, np.float32)
    vals[cyc * width + pos] = values.ravel()[flat]
    return out.reshape(t, 2, width), vals.reshape(t, width), width


@dataclasses.dataclass(frozen=True)
class SlotPlan:
    """Where each row of x lives in a resident solve's slot file
    (`plan_slots`).

    Chunks are `kernel.STREAM_CHUNK` cycles of the staged stream.  Row r's
    b is copied into slot ``slot[r]`` at the top of chunk ``refill[r]``
    (-1: before the first), its FINAL runs in chunk ``final[r]``, its x is
    written out at the top of chunk ``flush[r]`` (``chunks``: after the
    last), and it holds the slot through chunk ``release[r]``: the later of
    its last read and the chunk before its flush.  A slot is refilled only
    at a chunk after its last occupant's release, and each chunk's refill
    and flush lists hold at most ``32 * kernel.SLOT_LIST`` rows.
    """

    size: int
    chunks: int
    lead: int
    slot: np.ndarray
    refill: np.ndarray
    final: np.ndarray
    flush: np.ndarray
    release: np.ndarray

    def words(self, instr: np.ndarray) -> np.ndarray:
        """``instr`` (staged, ``[T, planes, P]``) with every EDGE and FINAL
        word naming its row's slot, and every other word slot 0."""
        op, src, _, _ = decode_instructions(instr, instr.shape[1])
        named = (op == OP_EDGE) | (op == OP_FINAL)
        slot = np.where(named, self.slot[np.where(named, src, 0)], 0).astype(np.int32)
        out = instr.copy()
        if instr.shape[1] == 1:
            out[:, 0] = (instr[:, 0] & ~np.int32((1 << SRC_BITS) - 1)) | slot
        else:
            out[:, 0] = slot
        return out

    def file(self) -> SlotFile:
        """The kernel's refill and flush lists (`kernel.SlotFile`, CPU
        tensors)."""
        cap = 32 * SLOT_LIST
        flat = np.zeros((self.chunks, 2, cap, 2), np.int32)
        flat[..., 1] = -1
        for k, when in enumerate((self.refill, self.flush)):
            rows = np.flatnonzero((when >= 0) & (when < self.chunks))
            rows = rows[np.argsort(when[rows], kind="stable")]
            chunk = when[rows]
            pos = np.arange(rows.size) - np.searchsorted(chunk, chunk)
            flat[chunk, k, pos] = np.stack([self.slot[rows], rows], 1)
        # entry e of a list to thread e % 32, its (e // 32)-th
        lists = flat.reshape(self.chunks, 2, SLOT_LIST, 32, 2).transpose(0, 1, 3, 2, 4)

        def pairs(rows):
            return torch.from_numpy(np.stack([self.slot[rows], rows], 1).astype(np.int32))

        return SlotFile(self.size, torch.from_numpy(np.ascontiguousarray(lists)),
                        pairs(np.flatnonzero(self.refill < 0)),
                        pairs(np.flatnonzero(self.flush >= self.chunks)))


def _served(arrivals: np.ndarray, cap: int) -> np.ndarray:
    """Rows a queue serves at each step, at most ``cap`` a step, first come
    first served, of ``arrivals[i]`` rows arriving at step i."""
    served = np.zeros_like(arrivals)
    queued = 0
    for i, a in enumerate(arrivals.tolist()):
        queued += a
        served[i] = min(cap, queued)
        queued -= served[i]
    return served


def plan_slots(prog: Program, lead: int, cycles: int | None = None) -> SlotPlan | None:
    """The slot file of a resident solve (`SlotPlan`), or ``None`` where a
    row of the program has no FINAL, or two, or is read before its FINAL.

    A row takes a slot from the copy of its b to its last read.  ``lead``
    is the chunks a copy takes to land (`kernel.stream_lead_chunks` of the
    program's lanes), so row r's b is copied at the top of chunk ``final -
    lead`` at the latest; where that chunk's refill list is full it is
    copied earlier, the latest-needed rows first (before the first chunk
    where none is left).  Its x is written out at the top of the chunk
    after its FINAL's (`kernel.SLOT_FLUSH_LAG`), or later where that
    chunk's flush list is full, the rows whose slot waits only on the flush
    first (after the last chunk where none is left).  The rows are then
    coloured, in order of refill, into the slots that earlier rows released
    before it, the one released last first, else a new one.  ``cycles`` is
    the staged stream's length (default the program's).
    """
    n, t = prog.n, prog.cycles
    chunks = -(-(cycles or t) // STREAM_CHUNK)
    cap = 32 * SLOT_LIST
    op, src, _, _ = decode_instructions(prog.instr, prog.planes)
    cyc = np.broadcast_to(np.arange(t)[:, None], op.shape)
    fin, edge = op == OP_FINAL, op == OP_EDGE
    if np.bincount(src[fin], minlength=n).tolist() != [1] * n:
        return None
    final_t = np.empty(n, np.int64)
    final_t[src[fin]] = cyc[fin]
    if (cyc[edge] <= final_t[src[edge]]).any():
        return None
    last_t = final_t.copy()
    np.maximum.at(last_t, src[edge], cyc[edge])
    final, last = final_t // STREAM_CHUNK, last_t // STREAM_CHUNK

    # refills, from the last chunk back: a row is due at final - lead
    due = final - lead
    by_due = np.argsort(-due, kind="stable")
    served = _served(np.bincount(due[due >= 0], minlength=chunks)[::-1], cap)
    refill = np.full(n, -1, np.int64)
    refill[by_due[:served.sum()]] = np.repeat(np.arange(chunks - 1, -1, -1), served)

    # flushes: rows final in chunk c arrive at c + SLOT_FLUSH_LAG
    by_final = np.lexsort((last, final))
    arrivals = np.bincount(final + SLOT_FLUSH_LAG, minlength=chunks + SLOT_FLUSH_LAG)[:chunks]
    served = _served(arrivals, cap)
    flush = np.full(n, chunks, np.int64)
    flush[by_final[:served.sum()]] = np.repeat(np.arange(chunks), served)
    release = np.maximum(last, flush - 1)

    # colour the intervals [refill, release] in order of refill
    slot = np.empty(n, np.int64)
    busy, free, size = [], [], 0
    rel = release.tolist()
    for r, a in zip(np.argsort(refill, kind="stable").tolist(), np.sort(refill).tolist()):
        while busy and busy[0][0] < a:
            free.append(heapq.heappop(busy)[1])
        if free:
            s = free.pop()
        else:
            s, size = size, size + 1
        slot[r] = s
        heapq.heappush(busy, (rel[r], s))
    return SlotPlan(size=size, chunks=chunks, lead=lead, slot=slot, refill=refill,
                    final=final, flush=flush, release=release)


def _check_stream(instr: np.ndarray, n_slots: int, n_rows: int,
                  plan: WindowPlan | None, cycles_per_block: int,
                  lanes: int | None = None) -> None:
    """Check the staged words against what the kernels may touch.

    The kernels load the psum slot and the x row of every word, NOP and
    padding words included (row 0 and slot 0), and index shared memory with
    them unchecked (the slot as the word's bits from the slot field up), so
    a word with bits past its packed fields, a slot past the psum register
    file, a row past x, or an active word outside its block's window is
    refused here, once per staging.  ``lanes`` marks a lane-compacted
    stream (`compact_lanes`) over that many lanes: its words also index the
    lanes' state by the lane they carry, so a lane past ``lanes``, or one
    that two live words of a cycle carry (they would race on its feedback),
    is refused too.
    """
    planes = instr.shape[1]
    upper = instr[:, 0] >> SRC_BITS if planes == 1 else instr[:, 1]
    if lanes is not None:
        lane = upper >> LANE_SHIFT
        upper = upper & ((1 << LANE_SHIFT) - 1)
        if ((lane < 0) | (lane >= lanes)).any():
            raise ValueError(f"a compacted word carries a lane past the {lanes} lanes")
        live = (upper & 0x1F) != 0
        keyed = np.sort(np.where(live, lane, lanes + np.arange(instr.shape[2])), axis=1)
        if (keyed[:, 1:] == keyed[:, :-1]).any():
            raise ValueError("two live words of a cycle carry the same lane")
        instr = np.stack([instr[:, 0], upper], axis=1)
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


def _check_slot_lists(sf: SlotFile, n_rows: int) -> None:
    """The kernel indexes its slots and b and x with the slot file's
    entries unchecked: refuse a used entry whose slot is past the file or
    whose row is past x, once per staging."""
    for pairs in (sf.lists.reshape(-1, 2), sf.prologue, sf.tail):
        used = pairs[pairs[:, 1] >= 0]
        if ((used[:, 0] < 0) | (used[:, 0] >= sf.size) | (used[:, 1] >= n_rows)).any():
            raise ValueError(f"a slot file entry names a slot past its {sf.size} "
                             f"or a row past the {n_rows} x rows")


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
    ``closure.placement`` / ``closure.plan`` / ``closure.x_in_smem``, the
    slot file of a resident x that does not fit shared memory whole as
    ``closure.slot_file`` (`plan_slots`, where its slots fit
    ``smem_limit_bytes``; else ``None``, x in device memory) and its slots
    as ``closure.x_slots`` (0 without one), and the slots a cycle of the
    staged stream as ``closure.lanes``: W where the blocked kernel runs it
    lane-compacted (`compact_lanes`, where that still fits
    ``smem_limit_bytes``), else P.
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
    p = prog.num_cus
    lanes = None  # P, where the blocked kernel runs the stream lane-compacted
    if mode == "blocked":
        ci, cv, slots_w = compact_lanes(instr_np, values_np)
        if slots_w < p and COLS_PER_CTA * smem_bytes_per_column(
                slots_w, 2, n_slots, plan.x_words(), lanes=p) <= smem_limit_bytes:
            instr_np, values_np, lanes = ci, cv, p
    x_in_smem = mode == "blocked" or state_bytes(
        prog, placement="resident")["total"] <= smem_limit_bytes
    slots = None  # where the resident kernel keeps x in a slot file
    if not x_in_smem:
        slots = plan_slots(prog, stream_lead_chunks(p), instr_np.shape[0])
        if slots is not None and COLS_PER_CTA * smem_bytes_per_column(
                p, prog.planes, n_slots, slot_file_words(p, slots.size)) <= smem_limit_bytes:
            instr_np = slots.words(instr_np)
        else:
            slots = None
    _check_stream(instr_np, n_slots, n_rows if slots is None else slots.size, plan,
                  cycles_per_block, lanes)
    instr = torch.from_numpy(instr_np).to(dev)
    values = torch.from_numpy(values_np).to(dev)
    slot_file = None
    if slots is not None:
        slot_file = slots.file()
        _check_slot_lists(slot_file, n_rows)
        slot_file = slot_file.to(dev)

    def solve_cols(bmat: torch.Tensor) -> torch.Tensor:
        with span("sptrsv.rhs_stage"):
            bp = torch.zeros((n_rows, width), dtype=torch.float32, device=dev)
            bp[:n] = bmat
        with span("sptrsv.launch"):
            if mode == "resident":
                x = sptrsv_cuda(instr, values, bp, num_slots=n_slots,
                                x_in_smem=x_in_smem, cols_per_cta=COLS_PER_CTA,
                                slot_file=slot_file)
            else:
                x = sptrsv_cuda_blocked(
                    instr, values, bp, window=plan.window, stride=plan.stride,
                    cycles_per_block=cycles_per_block, num_slots=n_slots,
                    cols_per_cta=COLS_PER_CTA, program_lanes=p)
        return x[:n]

    solve_cols.placement = mode
    solve_cols.plan = plan
    solve_cols.x_in_smem = x_in_smem
    solve_cols.x_slots = 0 if slots is None else slots.size
    solve_cols.slot_file = slot_file
    solve_cols.lanes = instr.shape[2]
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
