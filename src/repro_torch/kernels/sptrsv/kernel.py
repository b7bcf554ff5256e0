"""Hopper kernels executing a compiled SpTRSV VLIW stream, and their plain twins.

Ports `repro/kernels/sptrsv/kernel.py`.  Two kernels, written by hand in
CUDA C++ for ``sm_90a`` (`csrc/sptrsv.cu`, whose head note gives the
design), each beside a plain PyTorch version of the same algorithm:

  * `sptrsv_cuda` replaces ``sptrsv_pallas``: the whole padded x vector per
    CTA, in shared memory where it fits; else the rows live at once in a
    file of shared-memory slots (a `SlotFile`, planned by
    `ops.plan_slots`), each row copied in from b before its FINAL and
    written out to x once final; else x in device memory.
    Plain versions: `sptrsv_plain`, and `sptrsv_slotted_plain` for the
    slot file.
  * `sptrsv_cuda_blocked` replaces ``sptrsv_pallas_blocked``: a ring of
    ``window`` x rows in shared memory that advances ``stride`` rows per
    cycle block, with retired rows flushed to device memory.
    Plain version: `sptrsv_blocked_plain` (the same window sweep).  It also
    runs lane-compacted streams (`ops.compact_lanes`): each cycle's live
    words packed into fewer slots, each carrying its lane; the plain path
    scatters them back to their lanes first (`expand_lanes`).

What bounds them on an H100: the cycle-serial dependency chain, (emitted
cycles) x (latency of one cycle); the bytes and flops of a solve are far
below it (see the source note).  One warp runs one RHS column: thread t
owns ``lanes_per_thread(P)`` adjacent lanes, a cycle ends in a
``__syncwarp()``, and a CTA holds ``cols_per_cta`` independent warps.
`check_kernel_limits` states what a launch may ask for.

Both kernels keep b off the chain by seeding x with b: a FINAL lane reads
b[src] from its own, not yet final, row.  The plain versions do the same,
so kernel and twin round identically.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises.  Each wrapper counts its kernel
launches in ``<wrapper>.launches`` (`sptrsv_cuda` those with a slot file
in ``.x_slotted`` and those with x in device memory in ``.x_in_device``,
and `sptrsv_cuda_blocked` those of a compacted stream in
``.compacted``).  The CUDA library is built on first use
(`build`, through `common.build_library`) with ``nvcc`` into ``build/`` at
the repository root and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from pathlib import Path

import torch

from repro_torch.core.program import (
    OP_EDGE,
    OP_FINAL,
    PS_LOAD,
    PS_RESET,
    PS_STORE_RESET,
    PS_SWAP,
    SRC_BITS,
    decode_instructions,
)
from repro_torch.kernels.common import build_library

__all__ = [
    "SlotFile",
    "build",
    "check_kernel_limits",
    "expand_lanes",
    "lanes_per_thread",
    "max_cols_per_cta",
    "ring_rows",
    "slot_file_words",
    "smem_bytes_per_column",
    "stream_lead_chunks",
    "stream_ring_cycles",
    "sptrsv_cuda",
    "sptrsv_cuda_blocked",
    "sptrsv_plain",
    "sptrsv_blocked_plain",
    "sptrsv_slotted_plain",
    "COMPACT_WIDTHS",
    "LANE_SHIFT",
    "MAX_LANES",
    "MAX_SMEM_BYTES",
    "SLOT_FLUSH_LAG",
    "SLOT_LIST",
    "STREAM_CHUNK",
]

SOURCE = Path(__file__).resolve().parent / "csrc" / "sptrsv.cu"
MAX_LANES = 256         # P: eight lanes per thread of one warp
MAX_SLOTS = 256         # the packed word's 8-bit slot field
MAX_SMEM_BYTES = 232448  # shared memory a Hopper CTA can use (227 KB)
STREAM_CHUNK = 8        # csrc/sptrsv.cu CHUNK: cycles per cp.async group
_ALIGN = 16             # bytes: the stream's cp.async copies
COMPACT_WIDTHS = (32, 64, 128)  # slots a cycle of a lane-compacted stream
LANE_SHIFT = 13         # csrc/sptrsv.cu: a compacted word's lane, above the upper field
_UPPER_MASK = (1 << LANE_SHIFT) - 1
SLOT_LIST = 4           # csrc/sptrsv.cu SLOT_LIST: a thread's entries of a chunk's list
SLOT_FLUSH_LAG = 1      # csrc/sptrsv.cu SlotFile: chunk tops from a FINAL's chunk to its flush
_SLOT_CHUNK_WORDS = 2 * 32 * SLOT_LIST * 2  # a chunk's two lists of (slot, row) pairs


# ---------------------------------------------------------------------------
# the kernels' shape rules (csrc/sptrsv.cu `Lanes`, `Layout`), pure
# ---------------------------------------------------------------------------
def lanes_per_thread(p: int) -> int:
    """Lanes each thread of a column's warp owns: 1, 2, 4, 8 for P up to
    32, 64, 128, 256."""
    return next((k for k in (1, 2, 4) if p <= 32 * k), 8)


def max_cols_per_cta(p: int) -> int:
    """Columns (warps) a CTA may hold: 8 up to 64 lanes, 4 at 128, 2 at
    256, so that a thread may use 255 registers (the cycle loop keeps three
    cycles of decoded lanes in flight)."""
    return min(8, 16 // lanes_per_thread(p))


def stream_lead_chunks(p: int) -> int:
    """LEAD, the chunks of `STREAM_CHUNK` cycles the kernels' copies run
    ahead of use (one cp.async group a chunk): 4 up to 64 lanes, 2 above.
    A copy issued at the top of chunk c has landed, for every thread of
    the warp, from chunk c + LEAD on."""
    return 4 if lanes_per_thread(p) <= 2 else 2


def stream_ring_cycles(p: int) -> int:
    """Cycles of instruction words the per-warp stream ring holds: LEAD + 1
    chunks of `STREAM_CHUNK` (`stream_lead_chunks`)."""
    return (stream_lead_chunks(p) + 1) * STREAM_CHUNK


def slot_file_words(p: int, size: int) -> int:
    """x words of one column's warp that keeps x in a slot file of ``size``
    slots: the ring of the refill and flush lists (LEAD + 1 chunks of
    `SLOT_LIST` (slot, row) pairs a thread and list) and the slots, padded
    to 16 bytes (csrc/sptrsv.cu `SlotFile`)."""
    return (stream_lead_chunks(p) + 1) * _SLOT_CHUNK_WORDS + -(-size // 4) * 4


def ring_rows(window: int) -> int:
    """x rows of the blocked kernel's ring: the power of two >= ``window``,
    so a row's slot is ``row & (ring_rows - 1)``."""
    return 1 << max(0, int(window) - 1).bit_length()


def smem_bytes_per_column(p: int, planes: int, num_slots: int, x_words: int = 0,
                          lanes: int | None = None) -> int:
    """Shared memory of one column's warp: the psum register file
    ``[num_slots][32 * lanes]``, the stream ring ``[ring cycles][planes +
    1][32 * lanes]`` and ``x_words`` x rows.  For a stream of ``p`` slots
    compacted from a program of ``lanes`` lanes (csrc/sptrsv.cu
    `CompactLayout`), the psum file is ``[num_slots][lanes]``, beside the
    feedback of each lane and a zero word, padded to 16 bytes."""
    row = 32 * lanes_per_thread(p)
    ring = stream_ring_cycles(p) * (planes + 1) * row
    if lanes is None:
        return 4 * (num_slots * row + ring + x_words)
    return 4 * (-(-(num_slots * lanes + lanes + 1) // 4) * 4 + ring + x_words)


def check_kernel_limits(p: int, planes: int, num_slots: int, cols_per_cta: int,
                        cycles_per_block: int | None = None,
                        lanes: int | None = None) -> None:
    """Raise ``ValueError`` for a launch the CUDA kernels cannot take.

    Pure (no device, no library): the CUDA branch of each wrapper calls it
    before it launches.  1 <= P <= `MAX_LANES`, and P a multiple of its
    lanes per thread (any P up to 32, even P up to 64, ...: the stream's
    copies are 4 x lanes bytes); planes 1 or 2; 1 <= num_slots <= 256;
    1 <= cols_per_cta <= `max_cols_per_cta` (8 warps at most); the psum
    register files and stream rings of the CTA's columns within
    `MAX_SMEM_BYTES`; for the blocked kernel, cycles_per_block >= 1, of any
    length (`sptrsv_cuda_blocked` pads a block to whole stream chunks).
    ``lanes`` (the blocked kernel only) names a lane-compacted stream of
    ``p`` slots over a program of ``lanes`` > ``p`` lanes: two planes, ``p``
    one of `COMPACT_WIDTHS`, ``lanes`` <= `MAX_LANES`.  The x rows a CTA
    keeps in shared memory are the placement's budget (`ops.state_bytes`):
    a launch whose x does not fit is refused by the card and raises
    ``RuntimeError``.
    """
    if not 1 <= p <= MAX_LANES or p % lanes_per_thread(p):
        raise ValueError(f"the kernels take 1 <= P <= {MAX_LANES} lanes, above 32 a "
                         f"multiple of the lanes per thread (2, 4, 8); got P={p}")
    if planes not in (1, 2):
        raise ValueError(f"the kernels take 1 or 2 word planes, got {planes}")
    if not 1 <= num_slots <= MAX_SLOTS:
        raise ValueError(f"num_slots must be in [1, {MAX_SLOTS}], got {num_slots}")
    if not 1 <= cols_per_cta <= max_cols_per_cta(p):
        raise ValueError(f"cols_per_cta={cols_per_cta}: a CTA holds 1 to "
                         f"{max_cols_per_cta(p)} columns at P={p}")
    if lanes is not None and not (planes == 2 and p in COMPACT_WIDTHS
                                  and p < lanes <= MAX_LANES):
        raise ValueError(f"a lane-compacted stream has 2 planes of {COMPACT_WIDTHS} "
                         f"slots over more lanes, up to {MAX_LANES}; got {planes} "
                         f"planes of {p} slots over {lanes} lanes")
    need = cols_per_cta * smem_bytes_per_column(p, planes, num_slots, lanes=lanes)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"{cols_per_cta} columns need {need} bytes of shared memory for "
                         f"their psum files and stream rings, over {MAX_SMEM_BYTES}")
    if cycles_per_block is not None and cycles_per_block < 1:
        raise ValueError(f"the blocked kernel takes cycles_per_block >= 1, "
                         f"got {cycles_per_block}")


@dataclasses.dataclass(frozen=True)
class SlotFile:
    """A resident solve's x kept in ``size`` shared-memory slots, one a row
    from the copy of its b until its last read (`ops.plan_slots`); the
    stream's words name slots, not rows.

    ``lists`` is int32 ``[chunks, 2, 32, SLOT_LIST, 2]``, one chunk for
    every `STREAM_CHUNK` cycles of the stream: at the top of chunk c its
    flush list (list 1) writes x of each row from its slot, and then its
    refill list (list 0) starts the copy of each row's b into its slot,
    which a FINAL may read from chunk c + `stream_lead_chunks` on.  Entry
    e of a list lies at ``[c, list, e % 32, e // 32]``, a (slot, row)
    pair, row -1 where unused.  ``prologue`` (refills before chunk 0) and
    ``tail`` (flushes after the last chunk) are int32 ``[k, 2]`` pairs.
    """

    size: int
    lists: torch.Tensor
    prologue: torch.Tensor
    tail: torch.Tensor

    def to(self, device) -> SlotFile:
        return dataclasses.replace(self, lists=self.lists.to(device),
                                   prologue=self.prologue.to(device),
                                   tail=self.tail.to(device))


_LIB: ctypes.CDLL | None = None
_P, _I = ctypes.c_void_p, ctypes.c_int


def build() -> ctypes.CDLL:
    """Build (once per source version, `common.build_library`) and load the
    kernels' library; `common.BUILD_LOGS` keeps the compiler's output."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library("sptrsv", SOURCE)))
    lib.sptrsv_error_string.argtypes = [_I]
    lib.sptrsv_error_string.restype = ctypes.c_char_p
    lib.sptrsv_resident.argtypes = [_P] * 4 + [_I] * 8 + [_P]
    lib.sptrsv_resident.restype = _I
    lib.sptrsv_resident_slotted.argtypes = [_P] * 4 + [_I] * 8 + [_P, _P, _I, _P, _I, _P]
    lib.sptrsv_resident_slotted.restype = _I
    lib.sptrsv_blocked.argtypes = [_P] * 4 + [_I] * 11 + [_P]
    lib.sptrsv_blocked.restype = _I
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# input checks shared by both wrappers
# ---------------------------------------------------------------------------
def _check_inputs(instr, values, b, num_slots: int) -> None:
    if instr.dtype != torch.int32 or instr.dim() != 3 or instr.shape[1] not in (1, 2):
        raise ValueError(f"instr must be int32 [T, planes in (1, 2), P], got "
                         f"{instr.dtype} {tuple(instr.shape)}")
    t, _, p = instr.shape
    if values.dtype != torch.float32 or tuple(values.shape) != (t, p):
        raise ValueError(f"values must be float32 {(t, p)}, got "
                         f"{values.dtype} {tuple(values.shape)}")
    if b.dtype != torch.float32 or b.dim() != 2:
        raise ValueError(f"b must be float32 [rows, B], got {b.dtype} "
                         f"{tuple(b.shape)}")
    if not all(a.is_contiguous() for a in (instr, values, b)):
        raise ValueError("instr, values and b must be contiguous")
    if not instr.device == values.device == b.device:
        raise ValueError(f"instr, values and b must share a device, got "
                         f"{instr.device}, {values.device}, {b.device}")
    if not 1 <= num_slots <= MAX_SLOTS:
        raise ValueError(f"num_slots must be in [1, {MAX_SLOTS}], got {num_slots}")


def _check_cuda(instr, values, b, num_slots: int, cols_per_cta: int,
                cycles_per_block: int | None = None, lanes: int | None = None) -> None:
    if b.device.type != "cuda":
        raise ValueError(f"the SpTRSV kernels run on CUDA or CPU tensors, "
                         f"got {b.device}")
    _, planes, p = instr.shape
    check_kernel_limits(p, planes, num_slots, cols_per_cta, cycles_per_block, lanes)
    if b.shape[1] % cols_per_cta:
        raise ValueError(f"cols_per_cta={cols_per_cta} must divide the "
                         f"{b.shape[1]} RHS columns")
    if instr.data_ptr() % _ALIGN or values.data_ptr() % _ALIGN:
        raise ValueError(f"instr and values must start on a {_ALIGN}-byte boundary")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.sptrsv_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------
def _decode(instr):
    """Whole-stream decode into long ``[T, P]`` (op, src, ctl, slot)."""
    return [f.long() for f in decode_instructions(instr, instr.shape[1])]


def _exec_cycle(op, idx, ct, sl, v, xw, fb, rf, lanes, dummy):
    """One cycle over all lanes and columns; returns the new feedback.

    ``xw`` holds x rows where final and b rows where not yet final;
    ``idx`` is each lane's row of ``xw``, ``dummy`` a spare row of ``xw``
    that absorbs the scatter of non-FINAL lanes unchanged.  ``rf`` and
    ``xw`` are updated in place.
    """
    ct = ct[:, None]
    v = v[:, None]
    slot_val = rf[lanes, sl]
    pv = torch.where(ct == PS_RESET, 0.0, fb)
    pv = torch.where(ct == PS_LOAD, slot_val, pv)
    store = (ct == PS_STORE_RESET) | (ct == PS_SWAP)
    rf[lanes, sl] = torch.where(store, fb, slot_val)
    pv = torch.where(ct == PS_STORE_RESET, 0.0, pv)
    pv = torch.where(ct == PS_SWAP, slot_val, pv)
    xs = xw[idx]
    pv = torch.where((op == OP_EDGE)[:, None], pv + v * xs, pv)
    fin = op == OP_FINAL
    widx = torch.where(fin, idx, dummy)
    xw[widx] = torch.where(fin[:, None], (xs - pv) * v, xw[dummy])
    return pv


def sptrsv_plain(instr, values, b, *, num_slots: int):
    """Plain PyTorch version of `sptrsv_cuda` (any device).

    ``b`` is ``[n + 1, B]``; its last row is the padding row the scatter of
    non-FINAL lanes lands on.  Returns ``x`` of the same shape.
    """
    _check_inputs(instr, values, b, num_slots)
    p = instr.shape[2]
    op, src, ct, sl = _decode(instr)
    x = b.clone()
    fb = b.new_zeros(p, b.shape[1])
    rf = b.new_zeros(p, num_slots, b.shape[1])
    lanes = torch.arange(p, device=b.device)
    dummy = b.shape[0] - 1
    for t in range(instr.shape[0]):
        fb = _exec_cycle(op[t], src[t], ct[t], sl[t], values[t], x, fb, rf,
                         lanes, dummy)
    return x


def _pairs(a):
    """The used (slot, row) pairs of ``a`` (``[..., 2]``) as two long
    tensors, in entry order."""
    a = a.reshape(-1, 2).long()
    a = a[a[:, 1] >= 0]
    return a[:, 0], a[:, 1]


def sptrsv_slotted_plain(instr, values, b, *, num_slots: int, slot_file: SlotFile):
    """Plain PyTorch version of `sptrsv_cuda` with a slot file (any device).

    ``instr`` is the stream whose words name slots of ``slot_file``; ``b``
    and the result are ``[n + 1, B]`` as for `sptrsv_plain`.  Runs the
    kernel's schedule chunk by chunk, as late as the kernel allows: at the
    top of chunk c its flush list reads x from the slots, refills issued
    `stream_lead_chunks` tops before land, and the slots of its refill list
    turn NaN (their occupants leave; the copy may land from now on).  A row
    read before its b has landed, or after its slot was given to another
    row, reads NaN, and x starts out NaN, so a plan that flushes a row too
    early, or never, shows in the result.
    """
    _check_inputs(instr, values, b, num_slots)
    t_pad, _, p = instr.shape
    op, src, ct, sl = _decode(instr)
    lead = stream_lead_chunks(p)
    chunks = -(-t_pad // STREAM_CHUNK)
    if slot_file.lists.shape[0] != chunks:
        raise ValueError(f"the slot file's lists cover {slot_file.lists.shape[0]} "
                         f"chunks, the stream {chunks}")
    lists = slot_file.lists.to(b.device)
    xs = b.new_full((slot_file.size + 1, b.shape[1]), float("nan"))
    xs[-1] = 0.0  # the dummy slot that absorbs the scatter of non-FINAL lanes
    x = torch.full_like(b, float("nan"))
    x[-1] = b[-1]
    slots, rows = _pairs(slot_file.prologue.to(b.device))
    xs[slots] = b[rows]
    landing = {}
    fb = b.new_zeros(p, b.shape[1])
    rf = b.new_zeros(p, num_slots, b.shape[1])
    lanes = torch.arange(p, device=b.device)
    for c in range(chunks):
        slots, rows = _pairs(lists[c, 1])
        x[rows] = xs[slots]
        if c in landing:
            slots, rows = landing.pop(c)
            xs[slots] = b[rows]
        slots, rows = _pairs(lists[c, 0])
        xs[slots] = float("nan")
        landing[c + lead] = slots, rows
        for t in range(c * STREAM_CHUNK, min(t_pad, (c + 1) * STREAM_CHUNK)):
            fb = _exec_cycle(op[t], src[t], ct[t], sl[t], values[t], xs, fb, rf,
                             lanes, slot_file.size)
    slots, rows = _pairs(slot_file.tail.to(b.device))
    x[rows] = xs[slots]
    return x


def sptrsv_blocked_plain(instr, values, b, *, window: int, stride: int,
                         cycles_per_block: int, num_slots: int):
    """Plain PyTorch version of `sptrsv_cuda_blocked` (any device).

    The same window sweep over the same ring: row r lives in ring slot
    ``r & (ring_rows(window) - 1)``; at each block boundary the ``stride``
    oldest rows retire to ``x``, and then the rows entering the window take
    their slots with b.
    """
    _check_inputs(instr, values, b, num_slots)
    _check_sweep(instr, b, window, stride, cycles_per_block)
    t_pad, _, p = instr.shape
    op, src, ct, sl = _decode(instr)
    rows_in_ring = ring_rows(window)
    mask = rows_in_ring - 1
    slot = src & mask
    x = torch.empty_like(b)
    ring = b.new_zeros(rows_in_ring + 1, b.shape[1])  # last row: the dummy
    ring[:window] = b[:window]
    fb = b.new_zeros(p, b.shape[1])
    rf = b.new_zeros(p, num_slots, b.shape[1])
    lanes = torch.arange(p, device=b.device)
    for g in range(t_pad // cycles_per_block):
        if g > 0:
            rows = torch.arange((g - 1) * stride, g * stride, device=b.device)
            x[rows] = ring[rows & mask]
            ring[(rows + window) & mask] = b[rows + window]
        for t in range(g * cycles_per_block, (g + 1) * cycles_per_block):
            fb = _exec_cycle(op[t], slot[t], ct[t], sl[t], values[t], ring, fb,
                             rf, lanes, rows_in_ring)
    last = (t_pad // cycles_per_block - 1) * stride
    rows = torch.arange(last, last + window, device=b.device)
    x[rows] = ring[rows & mask]
    return x


def expand_lanes(instr, values, lanes: int, planes: int = 2):
    """``(instr, values)`` of a lane-compacted stream scattered back to its
    ``lanes`` lanes: each live word (op or psum control not 0) to the lane
    it carries, every other lane the zero word (a NOP of row 0, slot 0)
    with value 0.  ``instr`` is ``[T, 2, W]`` (`ops.compact_lanes`: the row;
    the upper field with the lane from `LANE_SHIFT`), ``values`` ``[T,
    W]``; the result is ``[T, planes, lanes]`` (``planes=1`` packs each
    word into one, every row then below ``2**SRC_BITS``)."""
    t, _, w = instr.shape
    upper = instr[:, 1]
    live = (upper & 0x1F) != 0
    cyc = torch.arange(t, device=instr.device)[:, None].expand(t, w)[live]
    lane = (upper >> LANE_SHIFT)[live].long()
    src, rest = instr[:, 0][live], (upper & _UPPER_MASK)[live]
    out = instr.new_zeros((t, planes, lanes))
    if planes == 1:
        out[cyc, 0, lane] = src | (rest << SRC_BITS)
    else:
        out[cyc, 0, lane] = src
        out[cyc, 1, lane] = rest
    vals = values.new_zeros((t, lanes))
    vals[cyc, lane] = values[live]
    return out, vals


def _check_sweep(instr, b, window, stride, cycles_per_block) -> None:
    t_pad = instr.shape[0]
    if cycles_per_block < 1 or t_pad % cycles_per_block:
        raise ValueError(f"{t_pad} cycles are not a multiple of "
                         f"cycles_per_block={cycles_per_block}")
    if stride < 1 or window < 2 * stride:
        raise ValueError(f"need stride >= 1 and window >= 2*stride, got "
                         f"window={window}, stride={stride}")
    n_hbm = (t_pad // cycles_per_block - 1) * stride + window
    if b.shape[0] != n_hbm:
        raise ValueError(f"b rows {b.shape[0]} != window sweep {n_hbm}")


def _pad_blocks(instr, values, cycles_per_block: int):
    """``(instr, values, cycles)``: each cycle block of the stream padded at
    its end with NOP cycles to ``cycles``, a multiple of `STREAM_CHUNK`.  A
    NOP cycle (all-zero words and values) keeps every lane's feedback and
    psum slots and writes no row, so the solve and its rounding are
    unchanged."""
    t, planes, p = instr.shape
    nb = t // cycles_per_block
    cycles = -(-cycles_per_block // STREAM_CHUNK) * STREAM_CHUNK
    wi = instr.new_zeros((nb, cycles, planes, p))
    wi[:, :cycles_per_block] = instr.view(nb, cycles_per_block, planes, p)
    wv = values.new_zeros((nb, cycles, p))
    wv[:, :cycles_per_block] = values.view(nb, cycles_per_block, p)
    return wi.view(nb * cycles, planes, p), wv.view(nb * cycles, p), cycles


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------
def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def sptrsv_cuda(instr, values, b, *, num_slots: int, x_in_smem: bool = True,
                cols_per_cta: int = 1, slot_file: SlotFile | None = None):
    """Resident solve: ``b[n + 1, B] -> x[n + 1, B]`` (replaces ``sptrsv_pallas``).

    One warp per column, ``cols_per_cta`` columns per CTA.  With a
    ``slot_file`` (`ops.plan_slots`, on the device of ``b``; it takes
    ``x_in_smem=False``, as the whole x is not in shared memory) the words
    name its slots, each column's warp keeps them in shared memory
    (`slot_file_words`), and the launch is counted in ``.x_slotted``.
    Without one, ``x_in_smem`` keeps each column's x in shared memory (the
    caller checks that ``n + 1`` rows per column fit beside the psum file
    and stream ring, see `ops.state_bytes`); otherwise x stays in device
    memory, and the launch is counted in ``.x_in_device``.  Every word
    must name a row of ``b`` (a slot of the file) and one of ``num_slots``
    psum slots, NOP words included (the kernel loads both for every lane),
    as `sptrsv_plain` also requires, and carry no bit past its packed
    fields (`ops._check_stream` checks staged streams).  CPU tensors go to
    `sptrsv_plain`, or `sptrsv_slotted_plain` with a slot file.
    """
    _check_inputs(instr, values, b, num_slots)
    slotted = slot_file is not None
    if slotted and x_in_smem:
        raise ValueError("a slot file keeps only the live rows of x in shared "
                         "memory: pass x_in_smem=False with it")
    if b.device.type == "cpu":
        if slotted:
            return sptrsv_slotted_plain(instr, values, b, num_slots=num_slots,
                                        slot_file=slot_file)
        return sptrsv_plain(instr, values, b, num_slots=num_slots)
    _check_cuda(instr, values, b, num_slots, cols_per_cta)
    lib = build()
    t, planes, p = instr.shape
    x = torch.empty_like(b)
    with torch.cuda.device(b.device):
        if slotted:
            _check_slot_file(slot_file, t, b)
            pro, tail = slot_file.prologue, slot_file.tail
            rc = lib.sptrsv_resident_slotted(
                instr.data_ptr(), values.data_ptr(), b.data_ptr(), x.data_ptr(),
                t, planes, p, b.shape[0], b.shape[1], num_slots, cols_per_cta,
                slot_file.size, slot_file.lists.data_ptr(), pro.data_ptr(), pro.shape[0],
                tail.data_ptr(), tail.shape[0], _stream())
        else:
            rc = lib.sptrsv_resident(
                instr.data_ptr(), values.data_ptr(), b.data_ptr(), x.data_ptr(),
                t, planes, p, b.shape[0], b.shape[1], num_slots, cols_per_cta,
                int(bool(x_in_smem)), _stream())
    _raise_on(lib, rc, "sptrsv_resident")
    sptrsv_cuda.launches += 1
    sptrsv_cuda.x_slotted += slotted
    sptrsv_cuda.x_in_device += not (x_in_smem or slotted)
    return x


def _check_slot_file(sf: SlotFile, t: int, b) -> None:
    """The slot file's tensors as the kernel takes them: int32, contiguous,
    on ``b``'s device, lists 16-byte aligned over the stream's chunks."""
    chunks = -(-t // STREAM_CHUNK)
    if tuple(sf.lists.shape) != (chunks, 2, 32, SLOT_LIST, 2):
        raise ValueError(f"slot file lists {tuple(sf.lists.shape)}, not "
                         f"{(chunks, 2, 32, SLOT_LIST, 2)} for {t} cycles")
    for a in (sf.lists, sf.prologue, sf.tail):
        if a.dtype != torch.int32 or not a.is_contiguous() or a.device != b.device:
            raise ValueError("the slot file's lists must be contiguous int32 on the "
                             "device of b")
    if sf.lists.data_ptr() % _ALIGN:
        raise ValueError(f"the slot file's lists must start on a {_ALIGN}-byte boundary")
    if sf.size < 1:
        raise ValueError(f"a slot file holds at least one slot, got {sf.size}")


def sptrsv_cuda_blocked(instr, values, b, *, window: int, stride: int,
                        cycles_per_block: int, num_slots: int,
                        cols_per_cta: int = 1, program_lanes: int | None = None):
    """Row-blocked solve: ``b[n_hbm, B] -> x[n_hbm, B]`` (replaces
    ``sptrsv_pallas_blocked``).

    ``n_hbm = (T / cycles_per_block - 1) * stride + window``; the caller
    has checked that cycle block g touches only rows ``[g*stride,
    g*stride + window)`` (`ops.plan_window`).  The words carry row indices,
    as for `sptrsv_blocked_plain` and the TPU kernel: the kernel keeps row
    r in ring slot ``r & (ring_rows(window) - 1)`` and masks each word's
    src field itself.  ``cycles_per_block`` may be any positive divisor of
    T: the kernel starts a block only at a `STREAM_CHUNK`, so a block of
    another length is padded with NOP cycles first (`_pad_blocks`, one
    copy of the stream on the card).  ``program_lanes``, the program's P,
    marks a stream of fewer slots as lane-compacted (`ops.compact_lanes`);
    its launches are counted in ``.compacted`` too.  One warp per column,
    ``cols_per_cta`` columns per CTA.  CPU tensors go to
    `sptrsv_blocked_plain`, a compacted stream through `expand_lanes`.
    """
    _check_inputs(instr, values, b, num_slots)
    _check_sweep(instr, b, window, stride, cycles_per_block)
    t, planes, p = instr.shape
    lanes = program_lanes if program_lanes not in (None, p) else None
    if b.device.type == "cpu":
        if lanes is not None:
            instr, values = expand_lanes(instr, values, lanes)
        return sptrsv_blocked_plain(instr, values, b, window=window,
                                    stride=stride,
                                    cycles_per_block=cycles_per_block,
                                    num_slots=num_slots)
    _check_cuda(instr, values, b, num_slots, cols_per_cta, cycles_per_block, lanes)
    if cycles_per_block % STREAM_CHUNK:
        instr, values, cycles_per_block = _pad_blocks(instr, values, cycles_per_block)
    lib = build()
    x = torch.empty_like(b)
    with torch.cuda.device(b.device):
        rc = lib.sptrsv_blocked(
            instr.data_ptr(), values.data_ptr(), b.data_ptr(), x.data_ptr(),
            instr.shape[0], planes, p, b.shape[1], num_slots, cols_per_cta, window,
            stride, cycles_per_block, ring_rows(window), lanes or p, _stream())
    _raise_on(lib, rc, "sptrsv_blocked")
    sptrsv_cuda_blocked.launches += 1
    sptrsv_cuda_blocked.compacted += lanes is not None
    return x


sptrsv_cuda.launches = 0
sptrsv_cuda.x_slotted = 0
sptrsv_cuda.x_in_device = 0
sptrsv_cuda_blocked.launches = 0
sptrsv_cuda_blocked.compacted = 0
