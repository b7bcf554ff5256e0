"""Instruction-stream program emitted by the compiler.

The accelerator is VLIW (paper §II-B): one instruction word per CU per cycle.
We encode the word as a *packed* dense int32 array of shape
``[cycles, planes, num_cus]`` — the software-managed-memory philosophy of the
paper carried to its conclusion: *all* irregularity is resolved at compile
time and the executor (numpy / JAX scan / Pallas kernel) runs a branch-free
data-driven program over a byte-minimal stream (DESIGN.md §Perf,
"Instruction encoding").

Packed word layout (single-plane regime, low bit -> high bit):

    [ src : SRC_BITS ][ op : 2 ][ ctl : 3 ][ slot : 8 ]     31 bits used

``src`` is the solution-row index (EDGE reads x[src]; FINAL reads b[src] and
writes x[src]) — the historical ``out_idx`` field is *derived*, not stored:
it always equals ``src`` on FINAL lanes and the dummy row otherwise, so
executors reconstruct the write index from ``(op, src)``.  The value-stream
index rides in a separate ``val_idx`` plane (the Pallas path pre-gathers
values at staging time and never streams indices at all).

Programs whose row indices do not fit ``SRC_BITS`` fall back automatically
to a two-plane layout: plane 0 carries the full-width ``src`` and plane 1
the remaining control fields with the same relative layout.  Either way one
``decode_instructions`` helper (pure ``&``/``>>`` arithmetic, numpy- and
jax-compatible) is the single source of truth for all three executors.

Opcode / psum-control encodings mirror Fig. 5 of the paper:
  * ``ct=1`` MAC edges  -> OP_EDGE  : psum += L_ij * x[src]
  * ``ct=0`` node update-> OP_FINAL : x[src] = (b[src] - psum) * L_ii^{-1}
    (division is performed as multiplication by the compiler-computed
    reciprocal, exactly as in §III-B).
The psum-control field encodes the S1/S2 multiplexer + psum register file
behaviour of §IV-B (keep/feedback, reset, load, store, read-before-write
swap).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "AccelConfig",
    "ScheduleStats",
    "Program",
    "OP_NOP",
    "OP_EDGE",
    "OP_FINAL",
    "PS_KEEP",
    "PS_RESET",
    "PS_LOAD",
    "PS_STORE_RESET",
    "PS_SWAP",
    "SRC_BITS",
    "OP_BITS",
    "CTL_BITS",
    "SLOT_BITS",
    "MAX_SLOT",
    "packed_planes",
    "pack_instructions",
    "decode_instructions",
    "validate_fields",
    "program_from_arrays",
]

OP_NOP, OP_EDGE, OP_FINAL = 0, 1, 2
PS_KEEP, PS_RESET, PS_LOAD, PS_STORE_RESET, PS_SWAP = 0, 1, 2, 3, 4

# ---------------------------------------------------------------------------
# Packed single-word instruction encoding
# ---------------------------------------------------------------------------
# Field widths (single-plane regime).  src gets every bit left over after the
# control fields; 18 + 2 + 3 + 8 = 31 bits keeps the word non-negative in
# int32, so arithmetic right-shifts decode it on every backend.
SRC_BITS = 18
OP_BITS = 2
CTL_BITS = 3
SLOT_BITS = 8

_OP_SHIFT = 0            # within the control part ("rest")
_CTL_SHIFT = OP_BITS
_SLOT_SHIFT = OP_BITS + CTL_BITS

_SRC_MASK = (1 << SRC_BITS) - 1
_OP_MASK = (1 << OP_BITS) - 1
_CTL_MASK = (1 << CTL_BITS) - 1
_SLOT_MASK = (1 << SLOT_BITS) - 1

# Largest psum slot id the packed word can carry — the compiler's overflow
# slots grow on demand but must stop here (compiler/sched.peek_over_slot).
MAX_SLOT = _SLOT_MASK


def packed_planes(n: int) -> int:
    """Planes needed to pack a program over ``n`` rows (1, or 2 for huge n).

    The single-plane word holds row indices up to ``2**SRC_BITS - 1``, so
    one plane covers ``n <= 2**SRC_BITS``; beyond that the encoding falls
    back to two int32 planes (full-width ``src`` in plane 0, control fields
    in plane 1) — chosen automatically at compile/staging time, decoded by
    the same helper.
    """
    return 1 if n - 1 <= _SRC_MASK else 2


def validate_fields(op, src, ctl, slot, planes: int) -> None:
    """Single validation point for the packed field widths.

    Shared by the compiler and the packer: any field exceeding its bit
    width raises a clear ``ValueError`` instead of silently wrapping into a
    neighbouring field (the historical risk: `schedule._CU.peek_over_slot`
    grows overflow slots toward 250 while the packed slot field is 8 bits).
    """
    op = np.asarray(op)
    src = np.asarray(src)
    ctl = np.asarray(ctl)
    slot = np.asarray(slot)
    src_max = np.iinfo(np.int32).max if planes == 2 else _SRC_MASK
    for name, arr, hi in (
        (f"src ({SRC_BITS}-bit)" if planes == 1 else "src (int32)", src, src_max),
        (f"op ({OP_BITS}-bit)", op, _OP_MASK),
        (f"ctl ({CTL_BITS}-bit)", ctl, _CTL_MASK),
        (f"slot ({SLOT_BITS}-bit)", slot, _SLOT_MASK),
    ):
        if arr.size == 0:
            continue
        lo_v, hi_v = int(arr.min()), int(arr.max())
        if lo_v < 0 or hi_v > hi:
            raise ValueError(
                f"instruction field {name} out of range: saw value "
                f"{lo_v if lo_v < 0 else hi_v}, allowed [0, {hi}] "
                f"(planes={planes})"
            )


def pack_instructions(op, src, ctl, slot, planes: int | None = None,
                      n: int | None = None) -> np.ndarray:
    """Pack per-field ``[T, P]`` arrays into ``[T, planes, P]`` int32 words.

    ``planes=None`` auto-selects from ``n`` (or the max src value) via
    `packed_planes`.  Fields are validated against their bit widths first
    (`validate_fields`).
    """
    op = np.asarray(op, dtype=np.int64)
    src = np.asarray(src, dtype=np.int64)
    ctl = np.asarray(ctl, dtype=np.int64)
    slot = np.asarray(slot, dtype=np.int64)
    if planes is None:
        rows = n if n is not None else (int(src.max()) + 1 if src.size else 1)
        planes = packed_planes(rows)
    if planes not in (1, 2):
        raise ValueError(f"planes must be 1 or 2, got {planes}")
    validate_fields(op, src, ctl, slot, planes)
    rest = (op << _OP_SHIFT) | (ctl << _CTL_SHIFT) | (slot << _SLOT_SHIFT)
    if planes == 1:
        word = src | (rest << SRC_BITS)
        return word.astype(np.int32)[:, None, :]
    return np.stack([src, rest], axis=1).astype(np.int32)


def decode_instructions(words, planes: int):
    """Decode packed words back into ``(op, src, ctl, slot)``.

    ``words`` is ``[..., planes, P]`` — a whole program, one cycle block, or
    a single cycle row — as a numpy array or an int32 torch tensor: the
    decode is pure ``&``/``>>`` arithmetic, so one helper serves the numpy
    oracle, the torch executor and the kernels' plain versions identically.
    """
    w0 = words[..., 0, :]
    if planes == 1:
        src = w0 & _SRC_MASK
        rest = w0 >> SRC_BITS
    elif planes == 2:
        src = w0
        rest = words[..., 1, :]
    else:
        raise ValueError(f"planes must be 1 or 2, got {planes}")
    op = rest & _OP_MASK
    ctl = (rest >> _CTL_SHIFT) & _CTL_MASK
    slot = (rest >> _SLOT_SHIFT) & _SLOT_MASK
    return op, src, ctl, slot


@dataclasses.dataclass(frozen=True)
class AccelConfig:
    """Hardware parameters (paper §V-A synthesis configuration)."""

    num_cus: int = 64          # 2^N compute units
    xi_words: int = 64         # x_i register file words per CU (2^M)
    psum_words: int = 8        # psum register file words per CU (2^K)
    num_banks: int = 64        # banked x-read ports across the interconnect
    clock_mhz: float = 150.0   # paper runs at 150 MHz (half of DPU-v2)
    alloc: str = "least_edges"  # node->CU allocation: least_edges | roundrobin
    icr: bool = True           # intra-node edge computation reordering
    psum_cache: bool = True    # partial-sum caching mechanism (§IV-B)
    dataflow: str = "medium"   # medium | coarse
    icr_window: int = 16       # per-CU ready-edge window examined by ICR

    @property
    def clock_period_s(self) -> float:
        return 1.0 / (self.clock_mhz * 1e6)


@dataclasses.dataclass
class ScheduleStats:
    """Everything the paper reports per benchmark (Figs. 9/10, Tables III/IV)."""

    name: str
    n: int
    nnz: int
    cycles: int          # hardware cycles (incl. all-NOP stall cycles)
    exec_edges: int
    exec_finals: int
    emitted_cycles: int = 0  # instruction rows actually emitted (stall rows
                             # where no lane executes are elided at emission)
    bnop: int = 0        # bank-conflict blocking
    pnop: int = 0        # psum-capacity blocking
    dnop: int = 0        # DAG-structure blocking (has tasks, all blocked)
    lnop: int = 0        # load-imbalance blocking (task list drained)
    snop: int = 0        # x_i register-file spill reload stalls (ours; tiny)
    constraints: int = 0     # bank-coloring constraint pairs (Fig. 9d)
    conflicts: int = 0       # unresolved same-bank collisions (Fig. 9e)
    reuse_events: int = 0    # broadcast reads serving >1 CU (Fig. 9f)
    distinct_reads: int = 0  # total distinct x reads across all cycles
    spilled_values: int = 0
    dm_escapes: int = 0      # emergency psum overflow parks (DESIGN.md §5)
    per_cu_edges: np.ndarray | None = None
    compile_seconds: float = 0.0
    # per-pass observability of the staged pipeline (DESIGN.md §6): a list
    # of `compiler.PassStats` (name, seconds, metrics) in pass order
    pass_stats: list | None = None
    # scheduling-strategy frontier (DESIGN.md §11): which schedule pass
    # produced this program, and — on schedule="auto" compiles — the
    # predicted cost of every candidate ({name: {cycles, stall_rows,
    # psum_spills, planes}}), the evidence behind the pick (and behind the
    # SPT208 "cycles left on the table" perf lint)
    schedule: str = "paper"
    schedule_costs: dict | None = None

    # -- paper metrics ---------------------------------------------------
    def flops(self) -> int:
        return 2 * self.nnz - self.n

    def throughput_gops(self, cfg: AccelConfig) -> float:
        return self.flops() / (self.cycles * cfg.clock_period_s) / 1e9

    def peak_throughput_gops(self, cfg: AccelConfig) -> float:
        """Equation 3 of the paper."""
        p = cfg.num_cus
        return (2.0 * p / cfg.clock_period_s) * (1.0 - self.n / (2.0 * self.nnz)) / 1e9

    def utilization(self) -> float:
        return (self.exec_edges + self.exec_finals) / (self.cycles * max(1, len(self.per_cu_edges)))

    def load_balance_cv(self) -> float:
        """Coefficient of variation (%) of input edges per CU (§V-B)."""
        e = self.per_cu_edges.astype(np.float64)
        return float(100.0 * e.std() / max(e.mean(), 1e-12))

    def nop_breakdown(self) -> dict[str, float]:
        total = self.cycles * max(1, len(self.per_cu_edges))
        return {
            "exec": (self.exec_edges + self.exec_finals) / total,
            "bnop": self.bnop / total,
            "pnop": self.pnop / total,
            "dnop": self.dnop / total,
            "lnop": self.lnop / total,
            "snop": self.snop / total,
        }


@dataclasses.dataclass(eq=False)
class Program:
    """Compiled VLIW instruction stream + reordered stream memory.

    The canonical instruction storage is the packed ``instr`` tensor (see
    module docstring); the historical per-field planes (``opcode``,
    ``src_idx``, ``psum_ctrl``, ``psum_slot``) are decoded views, and
    ``out_idx`` is *derived* — equal to ``src_idx`` on FINAL lanes, the
    dummy row ``n`` otherwise.

    ``eq=False`` keeps identity hashing/weakref support so executors can be
    cached per compiled program (see ``executor.make_jax_executor``).
    """

    config: AccelConfig
    n: int
    instr: np.ndarray      # [T, planes, P] int32 packed instruction words
    val_idx: np.ndarray    # [T, P] int32 index into `stream`
    stream: np.ndarray     # [S] float32: L_ij / 1/L_ii in schedule order
    stats: ScheduleStats
    num_slots: int = 0     # executor psum RF size (psum_words + overflow used)
    # Per-cycle solution-row access ranges (DESIGN.md §1, row-blocked x):
    # row_lo[t]/row_hi[t] = min/max row index touched by any active lane in
    # cycle t (EDGE reads x[src]; FINAL reads b[row] and writes x[row]).
    # Cycles with no active lane carry the empty sentinel (n, -1).  The
    # Pallas wrapper reduces these to per-cycle-block VMEM window bounds
    # that drive the level-boundary flush/refill DMAs.
    row_lo: np.ndarray | None = None  # [T] int32
    row_hi: np.ndarray | None = None  # [T] int32
    # Value provenance of `stream` (values-only recompilation, DESIGN.md
    # §10): stream_src[s] >= 0 is the global edge index into the frontend
    # ComputeDag's weight array whose coefficient was streamed at slot s;
    # a negative entry -(i+1) means node i's scale (diagonal reciprocal)
    # was streamed.  `compiler.recompile_values` regathers a fresh stream
    # from this plane without rescheduling; None on pre-provenance
    # programs (they take the full recompile path).
    stream_src: np.ndarray | None = None  # [S] int64

    @property
    def cycles(self) -> int:
        """Emitted instruction rows (== ``stats.emitted_cycles``; the
        *hardware* cycle count incl. elided stall rows is ``stats.cycles``)."""
        return self.instr.shape[0]

    @property
    def planes(self) -> int:
        return self.instr.shape[1]

    @property
    def num_cus(self) -> int:
        return self.instr.shape[2]

    # -- decoded views (host-side convenience; hot paths decode packed) ----
    def _decoded(self):
        cached = getattr(self, "_decoded_cache", None)
        if cached is None:
            cached = decode_instructions(self.instr, self.planes)
            object.__setattr__(self, "_decoded_cache", cached)
        return cached

    @property
    def opcode(self) -> np.ndarray:
        return self._decoded()[0]

    @property
    def src_idx(self) -> np.ndarray:
        return self._decoded()[1]

    @property
    def psum_ctrl(self) -> np.ndarray:
        return self._decoded()[2]

    @property
    def psum_slot(self) -> np.ndarray:
        return self._decoded()[3]

    @property
    def out_idx(self) -> np.ndarray:
        """Derived x write index: ``src`` on FINAL lanes, dummy row else."""
        op, src, _, _ = self._decoded()
        return np.where(op == OP_FINAL, src, self.n).astype(np.int32)

    # -- integrity hooks (DESIGN.md §7) -------------------------------------
    def validate_fields(self) -> None:
        """Re-check every decoded field against its packed bit width.

        Method form of the module-level `validate_fields`, run over this
        program's own words — the first line of defence of the structural
        validator (`core.robust.verify_program`), which wraps the raised
        ``ValueError`` into a `ProgramCorruptionError`.
        """
        op, src, ctl, slot = decode_instructions(self.instr, self.planes)
        validate_fields(op, src, ctl, slot, self.planes)

    def content_crc32(self) -> int:
        """CRC32 fingerprint of the executable content (instr/val_idx/stream).

        Stable across processes for bit-identical programs — the cheap
        identity the serving cache and the serialized format
        (`core.serialize`) key integrity on.
        """
        import zlib

        crc = 0
        for arr in (self.instr, self.val_idx, self.stream):
            crc = zlib.crc32(np.ascontiguousarray(arr).tobytes(), crc)
        return crc

    # -- instruction-traffic accounting ------------------------------------
    def instr_bytes_per_lane_cycle(self) -> int:
        """Streamed instruction bytes per lane per emitted cycle.

        One packed int32 word per plane plus the pre-gathered f32 stream
        value: 8 B in the single-plane regime (was 24 B with the five
        unpacked int32 planes).
        """
        return 4 * self.planes + 4

    def instr_bytes(self) -> int:
        """Total instruction HBM traffic streamed for one solve."""
        return self.cycles * self.num_cus * self.instr_bytes_per_lane_cycle()

    def instruction_bits(self) -> int:
        """Approximate instruction-memory footprint (Fig. 5a word layout)."""
        import math

        cfg = self.config
        n_, m_, k_ = (
            int(math.log2(cfg.num_cus)),
            int(math.log2(cfg.xi_words)),
            int(math.log2(cfg.psum_words)),
        )
        t_ = 14  # data-memory addressing depth 2^T
        word = (1 + k_) + (1 + m_ + 1) + (1 + t_) + n_ + 2 + 2 + 2 + 1 + 1
        return int(self.cycles * self.num_cus * word)


def _fields_of(cls, obj) -> dict:
    """Read ``cls``'s dataclass fields off ``obj`` (an object or a mapping)."""
    get = obj.get if isinstance(obj, dict) else (lambda k: getattr(obj, k))
    return {f.name: get(f.name) for f in dataclasses.fields(cls)}


def program_from_arrays(config, n: int, instr, val_idx, stream, stats, *,
                        num_slots: int = 0, row_lo=None, row_hi=None,
                        stream_src=None) -> Program:
    """Build a `Program` from another compiler's fields (duck-typed).

    ``config`` and ``stats`` are anything carrying the `AccelConfig` /
    `ScheduleStats` field names, as attributes or mapping keys (e.g. the
    JAX package's own dataclasses); the arrays are numpy arrays, copied so
    that the result shares no buffer with its source.
    """

    def arr(a):
        return None if a is None else np.array(a)

    return Program(
        config=AccelConfig(**_fields_of(AccelConfig, config)),
        n=int(n),
        instr=arr(instr),
        val_idx=arr(val_idx),
        stream=arr(stream),
        stats=ScheduleStats(**_fields_of(ScheduleStats, stats)),
        num_slots=int(num_slots),
        row_lo=arr(row_lo),
        row_hi=arr(row_hi),
        stream_src=arr(stream_src),
    )
