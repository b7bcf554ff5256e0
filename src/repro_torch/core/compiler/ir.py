"""Intermediate representations of the staged compiler pipeline (DESIGN.md §6).

The compiler is a sequence of passes, each consuming and producing an
explicit IR dataclass::

    frontend            ComputeDag      (generic SpTRSV-like compute DAG)
      └─ partition   →  PartitionIR     (medium-granularity node/edge view)
         └─ cu-assign→  AssignIR        (+ node→CU ownership)
            └─ psum-cache schedule + ICR reorder
                      →  ScheduleIR     (dense cycle trace, incl. stall rows)
               └─ stall-elide
                      →  EmitIR         (all-NOP rows dropped, row envelopes)
                  └─ pack/emit
                      →  Program        (packed VLIW words, core/program.py)

`ComputeDag` is the frontend contract: *any* workload whose nodes compute

    x[i] = (b[i] - sum_k weight[k] * x[src[k]]) * scale[i]

over a DAG in topological order lowers to it — lower-triangular SpTRSV
(`frontends/sptrsv.py`, weight = L_ij / scale = 1/L_ii), upper-triangular
and transpose solves via index reversal (`frontends/upper.py`), and
general DPU-v2-style weighted-accumulate circuits (`frontends/dagcirc.py`).
The emitted `Program` format is unchanged, so every executor (numpy,
`lax.scan`, both Pallas placements), batching, sharding and the packed
encoding run all of these workloads verbatim.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..program import ScheduleStats

__all__ = [
    "ComputeDag",
    "PartitionIR",
    "AssignIR",
    "ScheduleIR",
    "EmitIR",
    "PassStats",
]


@dataclasses.dataclass(frozen=True)
class ComputeDag:
    """Generic SpTRSV-like compute DAG — the compiler's frontend IR.

    Node ``i`` (ids ``0..n-1``, a topological order) computes

        x[i] = (b[i] - sum_k weight[k] * x[src[k]]) * scale[i]

    where ``k`` ranges over ``ptr[i]:ptr[i+1]``.  Sources must be strictly
    smaller node ids (topological order), ascending and duplicate-free
    within a node — exactly the off-diagonal layout of the paper's CSR
    convention, minus the triangular-matrix interpretation.
    """

    name: str
    n: int
    ptr: np.ndarray     # int64 [n+1] — per-node edge slices
    src: np.ndarray     # int64 [E]   — source node ids (ascending per node)
    weight: np.ndarray  # float64 [E] — coefficient on x[src] in the psum
    scale: np.ndarray   # float64 [n] — multiplier applied to (b[i] - psum)

    # ------------------------------------------------------------------
    @property
    def n_edges(self) -> int:
        return int(self.ptr[-1])

    @property
    def nnz(self) -> int:
        """Edge count + one final op per node (== matrix nnz for SpTRSV)."""
        return self.n_edges + self.n

    @property
    def binary_nodes(self) -> int:
        """Flop count: one FMA per edge + one mul-sub per final."""
        return 2 * self.nnz - self.n

    def node(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        lo, hi = int(self.ptr[i]), int(self.ptr[i + 1])
        return self.src[lo:hi], self.weight[lo:hi]

    def in_degree(self) -> np.ndarray:
        return np.diff(self.ptr)

    # ------------------------------------------------------------------
    def validate(self) -> None:
        """Enforce the frontend contract (raises ValueError)."""
        if self.ptr.shape != (self.n + 1,) or self.ptr[0] != 0:
            raise ValueError(f"{self.name}: ptr must be [n+1] starting at 0")
        if np.any(np.diff(self.ptr) < 0):
            raise ValueError(f"{self.name}: ptr must be non-decreasing")
        e = self.n_edges
        if self.src.shape != (e,) or self.weight.shape != (e,):
            raise ValueError(f"{self.name}: src/weight must have ptr[-1] entries")
        if self.scale.shape != (self.n,):
            raise ValueError(f"{self.name}: scale must be [n]")
        if not np.all(np.isfinite(self.scale)) or np.any(self.scale == 0.0):
            raise ValueError(f"{self.name}: scale must be finite and non-zero")
        if e:
            if not np.all(np.isfinite(self.weight)):
                raise ValueError(f"{self.name}: non-finite edge weight")
            owner_row = np.repeat(np.arange(self.n), np.diff(self.ptr))
            if int(self.src.min()) < 0 or np.any(self.src >= owner_row):
                raise ValueError(
                    f"{self.name}: every edge source must be a strictly "
                    f"smaller node id (topological order)")
            inner = np.ones(e, dtype=bool)
            bnd = self.ptr[1:-1]
            inner[bnd[bnd < e]] = False  # node boundaries
            if np.any((np.diff(self.src) <= 0)[inner[1:]]):
                raise ValueError(
                    f"{self.name}: sources must be ascending and "
                    f"duplicate-free within a node")


@dataclasses.dataclass(frozen=True)
class PartitionIR:
    """Output of the partition pass: the medium-granularity node/edge view.

    Nodes are the minimal *allocation* units, edges the minimal
    *scheduling* units (§IV-A); the consumer adjacency is what the
    scheduler uses to wake nodes as their inputs finalize.
    """

    dag: ComputeDag
    consumers: list            # list[list[int]] — consumers[j] ascending
    in_degree: np.ndarray      # int64 [n]
    metrics: dict


@dataclasses.dataclass(frozen=True)
class AssignIR:
    """Output of the cu-assign pass: node → CU ownership."""

    part: PartitionIR
    owner: np.ndarray          # int64 [n] — owning CU per node
    task_lists: list           # list[list[int]] — per-CU nodes, topo order
    metrics: dict


@dataclasses.dataclass(frozen=True)
class ScheduleIR:
    """Output of the psum-cache schedule (+ per-cycle ICR reorder) passes.

    A *dense* cycle trace: one row per hardware cycle, including all-NOP
    stall rows (bank-conflict replay / global psum stalls) — those are the
    stall-elide pass's input.  ``stats`` is the shared `ScheduleStats`
    accumulator (cycles / nop breakdown / ICR counters already filled;
    ``emitted_cycles`` is set later by stall-elide).
    """

    name: str
    n: int
    ops: np.ndarray            # uint8 [C, P]
    val_idx: np.ndarray        # int32 [C, P] — index into `stream`
    src: np.ndarray            # int32 [C, P]
    ctl: np.ndarray            # uint8 [C, P]
    slot: np.ndarray           # uint8 [C, P]
    stream: np.ndarray         # float64 [S] — values in schedule order
    num_slots: int
    stats: ScheduleStats
    metrics: dict              # psum-schedule pass metrics
    icr_metrics: dict          # ICR-reorder pass metrics
    # value provenance, parallel to `stream`: entry >= 0 is a global edge
    # index into the frontend ComputeDag's weight array, entry < 0 encodes
    # node id -(i+1) whose scale was streamed — the map the values-only
    # recompile path (`compiler.recompile_values`) regathers from
    stream_src: np.ndarray | None = None  # int64 [S]


@dataclasses.dataclass(frozen=True)
class EmitIR:
    """Output of the stall-elide pass: the rows actually streamed.

    All-NOP rows are dropped (they change no state — streaming them would
    be pure HBM traffic); ``row_lo/row_hi`` are the per-emitted-row
    touched-solution-row envelopes the row-blocked Pallas placement plans
    its VMEM window from (DESIGN.md §1).
    """

    name: str
    n: int
    ops: np.ndarray            # uint8 [T, P]
    val_idx: np.ndarray        # int32 [T, P]
    src: np.ndarray            # int32 [T, P]
    ctl: np.ndarray            # uint8 [T, P]
    slot: np.ndarray           # uint8 [T, P]
    row_lo: np.ndarray         # int32 [T]
    row_hi: np.ndarray         # int32 [T]
    stream: np.ndarray         # float64 [S]
    num_slots: int
    stats: ScheduleStats
    metrics: dict
    stream_src: np.ndarray | None = None  # int64 [S] (see ScheduleIR)


@dataclasses.dataclass(frozen=True)
class PassStats:
    """Per-pass observability record (attached as ``stats.pass_stats``)."""

    name: str
    seconds: float
    metrics: dict
