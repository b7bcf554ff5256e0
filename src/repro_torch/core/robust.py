"""Hardened solve path: program integrity, numerical health, degradation.

Ports the JAX package's ``core/robust.py``.  Three layers over the
compile/execute stack (DESIGN.md §7):

  * `verify_program` — a structural validator for compiled `Program`s.
    Everything the executors and kernels *assume* about an instruction
    stream is checked explicitly: packed-field ranges, zero-word NOP lanes,
    value-index bounds, finite stream values with non-zero FINAL
    reciprocals, psum slot capacity and slot *lifetimes*, each solution
    row finalized exactly once, dependency order, and the row-envelope
    metadata (``row_lo/row_hi``) re-derived from the words it summarizes.
    A thin wrapper over `core.analysis.program_diagnostics`, the
    implementation shared with `compile_dag(verify_ir=True)`; any
    violation is a `ProgramCorruptionError`.
  * `RobustSolver` — a health-checked wrapper over the executors: input
    validation (shape, dtype, NaN/Inf in b), output checks (non-finite x,
    relative residual ``max|Lx-b| / max|b|`` against the retained
    `TriCSR`), and a deterministic fallback ladder cuda-blocked →
    cuda-resident → torch → numpy → reference (the JAX package's
    pallas-blocked → pallas-resident → jax → numpy → reference) with
    bounded per-stage retries, an optional per-stage deadline on an
    injectable clock, and machine-readable `Incident` records of what
    degraded and why.
  * `FaultInjector` + `run_fault_injection` — a seeded fault-injection
    harness (instruction-word bit flips, value-plane and serialized-blob
    corruption, poisoned right-hand sides, psum-slot rewrites) that proves
    every fault class is either *detected* or *safely degraded* — never a
    silent wrong answer.  `run_ir_fault_injection` mutates each
    intermediate IR of the staged compiler post-pass and asserts the
    per-pass contract verifiers (`core/analysis/contracts.py`) catch the
    mutation with the expected diagnostic code, and
    `run_service_fault_injection` drives a resilient `serve.SolveService`
    through the service-level fault classes.

The torch and cuda rungs return tensors on the solver's device; every
answer crosses to the host through `host_array` before it is checked.
"""

from __future__ import annotations

import dataclasses
import os
import time
import zlib

import numpy as np
import torch

from .analysis import SEV_ERROR, program_diagnostics
from .csr import TriCSR, serial_solve
from .errors import (
    BackendExecutionError,
    NumericalHealthError,
    ProgramCorruptionError,
    RobustnessError,
)
from .executor import as_batch, execute_numpy, make_cuda_executor, make_torch_executor
from .program import (
    OP_EDGE,
    OP_FINAL,
    PS_LOAD,
    PS_STORE_RESET,
    PS_SWAP,
    AccelConfig,
    Program,
    decode_instructions,
)

__all__ = [
    "verify_program",
    "host_array",
    "Incident",
    "RobustSolver",
    "FaultInjector",
    "run_fault_injection",
    "run_ir_fault_injection",
    "run_service_fault_injection",
    "csr_matvec",
    "relative_residual",
    "LADDER",
    "FAULT_CLASSES",
    "IR_FAULT_CLASSES",
    "SERVICE_FAULT_CLASSES",
]

# The deterministic degradation order.  A requested backend enters the
# ladder at its own rung and degrades rightward; "reference" (a direct
# serial solve from the retained TriCSR, independent of the compiled
# program) is only available when the solver retains the matrix.
LADDER = ("cuda-blocked", "cuda-resident", "torch", "numpy", "reference")
_ENTRY = {"cuda": 0, "torch": 2, "numpy": 3}
# the rungs that run on the solver's device
_DEVICE_RUNGS = ("cuda-blocked", "cuda-resident", "torch")


def verify_program(prog: Program) -> None:
    """Structurally validate a compiled `Program` (see module docstring).

    Raises `ProgramCorruptionError` naming the first violated invariant;
    returns None on a clean program.  Pure numpy, no executor is touched —
    safe to run on untrusted/deserialized programs before any solve.

    Thin wrapper over the shared static analyzer
    (`core.analysis.program_diagnostics`): the hazard checks run in the
    historical order and the raised message is the first error
    diagnostic's, verbatim, so callers matching on messages are
    unaffected; the diagnostic code rides along in ``detail["code"]``.
    """
    for d in program_diagnostics(prog):
        if d.severity == SEV_ERROR:
            anchors = {k: v for k, v in
                       (("cycle", d.cycle), ("cu", d.cu), ("node", d.node))
                       if v is not None}
            raise ProgramCorruptionError(
                f"program integrity: {d.message}",
                detail={**anchors, **d.detail, "code": d.code})


def host_array(x) -> np.ndarray:
    """A rung's answer as a host numpy array.

    The torch and cuda rungs return tensors on the solver's device, and
    ``np.asarray`` raises ``TypeError`` on a CUDA tensor.  Inside the ladder
    that error would be recorded as a failed rung, so every answer would
    quietly come from the numpy rung; every solve result crosses here
    instead.
    """
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# numerical health helpers
# ---------------------------------------------------------------------------
def csr_matvec(mat: TriCSR, x: np.ndarray) -> np.ndarray:
    """``L @ x`` for the retained CSR; ``x`` is ``[n]`` or ``[n, B]``."""
    prod = mat.values[:, None] * np.asarray(x, dtype=np.float64)[mat.colidx]
    return np.add.reduceat(prod, mat.rowptr[:-1].astype(np.intp), axis=0)


def _matvec_fn(mat: TriCSR):
    """``x -> L @ x`` closure: scipy's C matvec when the host has scipy
    (an order of magnitude faster on the per-solve residual check),
    `csr_matvec` otherwise."""
    try:
        import scipy.sparse as sp
    except ImportError:  # pragma: no cover - both installations ship scipy
        return lambda x: csr_matvec(mat, x)
    a = sp.csr_matrix((mat.values, mat.colidx, mat.rowptr),
                      shape=(mat.n, mat.n))
    return lambda x: a @ x


def _relative_residual(matvec, x: np.ndarray, b: np.ndarray) -> float:
    xm, _ = as_batch(np.asarray(x, dtype=np.float64))
    bm, _ = as_batch(np.asarray(b, dtype=np.float64))
    num = np.abs(matvec(xm) - bm).max()
    den = max(np.abs(bm).max(), np.finfo(np.float64).tiny)
    return float(num / den)


def relative_residual(mat: TriCSR, x: np.ndarray, b: np.ndarray) -> float:
    """``max|Lx - b| / max|b|`` over all RHS columns (∞-norm, relative)."""
    return _relative_residual(_matvec_fn(mat), x, b)


@dataclasses.dataclass(frozen=True)
class Incident:
    """One machine-readable degradation/detection event of a `RobustSolver`."""

    stage: str          # ladder rung ("cuda-blocked", ..., "reference")
    kind: str           # "exception" | "nonfinite-output" | "residual"
                        # | "deadline" | "build-failed" | "input"
    message: str
    error: str = ""     # exception class name, "" for health-check events
    attempt: int = 1
    elapsed_s: float = 0.0
    detail: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _placement_refused(inc: Incident) -> bool:
    """The cuda-blocked rung refused a program whose row envelope admits no
    window (`errors.PlacementInfeasibleError`): a property of the program,
    recorded as ``build-failed``, not a sign of a fault."""
    return inc.kind == "build-failed" and inc.error == "PlacementInfeasibleError"


class RobustSolver:
    """Health-checked, gracefully degrading solve wrapper (DESIGN.md §7).

    ``prog`` is the compiled program; ``mat`` (optional but recommended)
    is the `TriCSR` it was compiled from — retaining it enables the
    relative-residual output check and the final "reference" ladder rung,
    which solves directly from the CSR and therefore returns a *correct*
    answer even when the program itself is corrupt.

    Parameters
    ----------
    backend : entry rung — "cuda" starts at cuda-blocked, "torch"
        (default) at the eager torch executor, "numpy" at the oracle.
    device : the device of the cuda and torch rungs, CUDA when None.  It is
        resolved here, once: a machine without CUDA raises at construction
        instead of recording failed rungs and answering from numpy.
    verify : run `verify_program` once at construction (default True).
    check_inputs / check_outputs : per-solve health checks (default on).
    residual_tol : relative ∞-norm residual threshold (needs ``mat``);
        ``None`` disables the residual check.
    max_retries : extra attempts per rung after an *exception* (health
        failures are deterministic and never retried).
    stage_deadline_s : wall-clock budget per rung, measured on ``clock``;
        a rung that exceeds it is recorded and disabled for subsequent
        solves.  ``None`` (default) disables deadlines.
    clock : injectable monotonic clock (seconds), for deterministic tests.
    backend_opts : forwarded to the cuda rungs (``cycles_per_block``,
        ``smem_limit_bytes``, ``x_block_rows``).

    Solves accept ``b`` of shape ``[n]`` or ``[n, B]`` and return numpy
    arrays.  Every detection and degradation appends an `Incident` to
    ``last_incidents`` (per solve) and ``incidents`` (lifetime); a solve
    that exhausts the ladder raises the classified exception with the
    incident trail attached to ``.detail["incidents"]``.
    """

    def __init__(self, prog: Program, mat: TriCSR | None = None, *,
                 backend: str = "torch", verify: bool = True,
                 check_inputs: bool = True, check_outputs: bool = True,
                 residual_tol: float | None = 1e-3, max_retries: int = 1,
                 stage_deadline_s: float | None = None,
                 clock=time.perf_counter, ladder: tuple[str, ...] | None = None,
                 device=None, **backend_opts):
        if backend not in _ENTRY:
            from .errors import UnknownBackendError

            raise UnknownBackendError(
                f"unknown backend {backend!r} (choose from "
                f"{sorted(_ENTRY)})")
        if verify:
            verify_program(prog)
        self.prog = prog
        self.mat = mat
        self.check_inputs = check_inputs
        self.check_outputs = check_outputs
        self.residual_tol = residual_tol if mat is not None else None
        self.max_retries = max(0, int(max_retries))
        self.stage_deadline_s = stage_deadline_s
        self.clock = clock
        self.backend_opts = dict(backend_opts)
        stages = ladder if ladder is not None else LADDER[_ENTRY[backend]:]
        if mat is None:
            stages = tuple(s for s in stages if s != "reference")
        self.ladder = tuple(stages)
        self.device = None
        if any(s in _DEVICE_RUNGS for s in self.ladder):
            from repro_torch.kernels.common import resolve_device

            self.device = resolve_device(device)
        self._matvec = None if mat is None else _matvec_fn(mat)
        self._disabled: set[str] = set()
        self._solvers: dict[tuple, object] = {}
        self.incidents: list[Incident] = []
        self.last_incidents: list[Incident] = []
        self.last_stage: str = ""  # rung that produced the last answer

    # -- stage plumbing ----------------------------------------------------
    def _solver_for(self, stage: str, batch: int | None):
        key = (stage, batch)
        fn = self._solvers.get(key)
        if fn is not None:
            return fn
        if stage in ("cuda-blocked", "cuda-resident"):
            fn = make_cuda_executor(self.prog, batch=batch,
                                    placement=stage[len("cuda-"):],
                                    device=self.device, **self.backend_opts)
        elif stage == "torch":
            fn = make_torch_executor(self.prog, batch=batch, device=self.device)
        elif stage == "numpy":
            fn = lambda b: execute_numpy(self.prog, b)  # noqa: E731
        elif stage == "reference":
            mat = self.mat

            def fn(b):
                bm, single = as_batch(np.asarray(b, dtype=np.float64))
                x = np.stack([serial_solve(mat, bm[:, j])
                              for j in range(bm.shape[1])], axis=1)
                return x[:, 0] if single else x
        else:
            raise ValueError(f"unknown ladder stage {stage!r}")
        self._solvers[key] = fn
        return fn

    def _record(self, stage: str, kind: str, message: str, *, error: str = "",
                attempt: int = 1, elapsed_s: float = 0.0,
                detail: dict | None = None) -> Incident:
        inc = Incident(stage=stage, kind=kind, message=message, error=error,
                       attempt=attempt, elapsed_s=float(elapsed_s),
                       detail=dict(detail or {}))
        self.last_incidents.append(inc)
        self.incidents.append(inc)
        return inc

    # -- health checks -----------------------------------------------------
    def residual(self, x: np.ndarray, b: np.ndarray) -> float:
        """Relative ∞-norm residual via the solver's cached CSR matvec."""
        if self._matvec is None:
            raise ValueError("residual check needs the retained TriCSR "
                             "(construct with mat=...)")
        return _relative_residual(self._matvec, x, b)

    def _check_input(self, b: np.ndarray) -> np.ndarray:
        try:
            b = np.asarray(b, dtype=np.float64)
        except (TypeError, ValueError) as e:
            raise NumericalHealthError(
                f"right-hand side not numeric: {e}") from e
        if b.ndim not in (1, 2) or b.shape[0] != self.prog.n:
            raise NumericalHealthError(
                f"right-hand side must be [n] or [n, B] with n={self.prog.n},"
                f" got shape {b.shape}", detail={"shape": list(b.shape)})
        bad = ~np.isfinite(b)
        if bad.any():
            idx = np.argwhere(bad)[0]
            raise NumericalHealthError(
                f"right-hand side carries {int(bad.sum())} non-finite "
                f"entr{'y' if bad.sum() == 1 else 'ies'} (first at "
                f"index {tuple(int(i) for i in idx)})",
                detail={"non_finite": int(bad.sum())})
        return b

    def _check_output(self, x: np.ndarray, b: np.ndarray, stage: str,
                      elapsed: float) -> bool:
        if not np.isfinite(x).all():
            self._record(stage, "nonfinite-output",
                         f"{int(np.count_nonzero(~np.isfinite(x)))} "
                         f"non-finite solution component(s)",
                         elapsed_s=elapsed)
            return False
        if self.check_outputs and self.residual_tol is not None:
            rel = self.residual(x, b)
            if not rel <= self.residual_tol:
                self._record(stage, "residual",
                             f"relative residual {rel:.3e} exceeds "
                             f"tolerance {self.residual_tol:.1e}",
                             elapsed_s=elapsed, detail={"residual": rel})
                return False
        return True

    # -- the solve ---------------------------------------------------------
    def solve(self, b: np.ndarray) -> np.ndarray:
        """Solve Lx=b through the ladder; see class docstring."""
        self.last_incidents = []
        if self.check_inputs:
            b = self._check_input(b)
        else:
            b = np.asarray(b, dtype=np.float64)
        single = b.ndim == 1
        batch = None if single else b.shape[1]

        for stage in self.ladder:
            if stage in self._disabled:
                continue
            try:
                solver = self._solver_for(stage, batch)
            except Exception as e:  # placement infeasible, build failure
                self._record(stage, "build-failed", str(e),
                             error=type(e).__name__)
                self._disabled.add(stage)
                continue
            for attempt in range(1, self.max_retries + 2):
                t0 = self.clock()
                try:
                    x = host_array(solver(b))
                except Exception as e:
                    self._record(stage, "exception", str(e),
                                 error=type(e).__name__, attempt=attempt,
                                 elapsed_s=self.clock() - t0)
                    continue  # bounded retry of the same rung
                elapsed = self.clock() - t0
                if (self.stage_deadline_s is not None
                        and elapsed > self.stage_deadline_s):
                    self._record(stage, "deadline",
                                 f"stage took {elapsed:.3f}s > deadline "
                                 f"{self.stage_deadline_s:.3f}s",
                                 attempt=attempt, elapsed_s=elapsed)
                    self._disabled.add(stage)
                    break  # degrade; do not trust an over-deadline rung
                if not self.check_outputs:
                    self.last_stage = stage
                    return x
                if self._check_output(x, b, stage, elapsed):
                    self.last_stage = stage
                    return x
                break  # health failures are deterministic: degrade

        trail = [i.to_dict() for i in self.last_incidents]
        kinds = {i.kind for i in self.last_incidents}
        msg = (f"all ladder stages failed for n={self.prog.n} solve "
               f"({len(trail)} incident(s); stages {list(self.ladder)})")
        if kinds & {"nonfinite-output", "residual"}:
            raise NumericalHealthError(msg, detail={"incidents": trail})
        raise BackendExecutionError(msg, detail={"incidents": trail})

    __call__ = solve


# ---------------------------------------------------------------------------
# fault injection
# ---------------------------------------------------------------------------
FAULT_CLASSES = ("instr_bit_flip", "psum_slot", "value_plane_nan",
                 "value_plane_scale", "blob", "rhs_nan", "rhs_inf")


def _copy_program(prog: Program) -> Program:
    return dataclasses.replace(
        prog,
        instr=prog.instr.copy(),
        val_idx=prog.val_idx.copy(),
        stream=prog.stream.copy(),
        row_lo=None if prog.row_lo is None else prog.row_lo.copy(),
        row_hi=None if prog.row_hi is None else prog.row_hi.copy(),
    )


class FaultInjector:
    """Seeded fault source for the robustness tests (DESIGN.md §7).

    Every method returns a *new* corrupted object; the input is never
    mutated.  The generator is owned by the injector, so a fixed seed
    yields a reproducible fault sequence across runs — the same sequence
    as the JAX package's injector of the same seed.
    """

    def __init__(self, seed: int = 0):
        self.rng = np.random.default_rng(seed)

    def flip_instr_bits(self, prog: Program, flips: int = 1) -> Program:
        """Flip ``flips`` random bits in the packed instruction words."""
        out = _copy_program(prog)
        flat = out.instr.reshape(-1)
        for _ in range(flips):
            i = int(self.rng.integers(flat.size))
            bit = int(self.rng.integers(31))  # the packed fields' bits
            flat[i] = np.int32(int(flat[i]) ^ (1 << bit))
        return out

    def corrupt_slots(self, prog: Program, k: int = 1) -> Program:
        """Rewrite the psum-slot field of ``k`` random slot-using lanes.

        Targets lanes whose control actually reads or writes the slot
        (LOAD / STORE_RESET / SWAP — a RESET lane's slot field is dead);
        programs with no such traffic are returned unchanged.
        """
        out = _copy_program(prog)
        op, src, ctl, slot = decode_instructions(out.instr, out.planes)
        ev = np.argwhere((ctl == PS_LOAD) | (ctl == PS_STORE_RESET)
                         | (ctl == PS_SWAP))
        if not ev.size:
            return out
        from .program import pack_instructions

        slot = slot.copy()
        for _ in range(k):
            t, p = ev[int(self.rng.integers(len(ev)))]
            slot[t, p] = int(self.rng.integers(256))
        out.instr = pack_instructions(op, src, ctl, slot, planes=out.planes)
        return out

    def corrupt_stream(self, prog: Program, k: int = 1,
                       mode: str = "nan") -> Program:
        """Corrupt ``k`` entries of the value plane (``mode``: nan|scale)."""
        out = _copy_program(prog)
        idx = self.rng.integers(out.stream.size, size=k)
        if mode == "nan":
            out.stream[idx] = np.nan
        elif mode == "scale":
            out.stream[idx] = out.stream[idx] * 64.0 + 1.5
        else:
            raise ValueError(f"unknown stream corruption mode {mode!r}")
        return out

    def corrupt_blob(self, blob: bytes, k: int = 1) -> bytes:
        """XOR ``k`` random bytes of a serialized blob with non-zero junk."""
        buf = bytearray(blob)
        for _ in range(k):
            i = int(self.rng.integers(len(buf)))
            buf[i] ^= int(self.rng.integers(1, 256))
        return bytes(buf)

    def poison_rhs(self, b: np.ndarray, k: int = 1,
                   value: float = np.nan) -> np.ndarray:
        """Plant ``k`` non-finite entries in a right-hand side."""
        out = np.array(b, dtype=np.float64, copy=True)
        flat = out.reshape(-1)
        flat[self.rng.integers(flat.size, size=k)] = value
        return out

    # -- IR-level mutation faults (caught by analysis.contracts) -----------
    # Each returns a corrupted *copy* of one intermediate IR of the staged
    # compiler, or None when the fault does not apply to this workload
    # (e.g. no edges, no psum traffic).  `run_ir_fault_injection` drives
    # the pipeline, mutates each IR post-pass, and asserts the matching
    # per-pass verifier fires the expected diagnostic code.

    def corrupt_dag(self, dag):
        """Rewrite one edge source onto its own consumer (topo break)."""
        if dag.n_edges == 0:
            return None
        src = dag.src.copy()
        owner_row = np.repeat(np.arange(dag.n), np.diff(dag.ptr))
        k = int(self.rng.integers(dag.n_edges))
        src[k] = owner_row[k]  # sources must be strictly smaller node ids
        return dataclasses.replace(dag, src=src)

    def corrupt_partition(self, pir):
        """Drop one consumer edge from the wake-up adjacency."""
        cands = [j for j in range(pir.dag.n) if pir.consumers[j]]
        if not cands:
            return None
        j = cands[int(self.rng.integers(len(cands)))]
        consumers = [list(c) for c in pir.consumers]
        consumers[j] = consumers[j][:-1]
        return dataclasses.replace(pir, consumers=consumers)

    def corrupt_assign(self, air):
        """Flip one node's owner without touching the task lists."""
        if len(air.task_lists) < 2:
            return None
        owner = np.asarray(air.owner).copy()
        i = int(self.rng.integers(owner.size))
        owner[i] = (owner[i] + 1) % len(air.task_lists)
        return dataclasses.replace(air, owner=owner)

    def corrupt_schedule(self, sir, mode: str):
        """Mutate the dense cycle trace (``mode``: raw | dup_final |
        slot_cap | use_before_def)."""
        ops = sir.ops.copy()
        src = sir.src.copy()
        ctl = sir.ctl.copy()
        slot = sir.slot.copy()
        if mode == "raw":
            edges = np.argwhere(ops == OP_EDGE)
            finals = np.argwhere(ops == OP_FINAL)
            if not edges.size or not finals.size:
                return None
            # retarget an early EDGE at the row finalized last
            t_last = int(finals[:, 0].max())
            lt, lp = finals[finals[:, 0] == t_last][0]
            early = edges[edges[:, 0] <= t_last]
            if not early.size:
                return None
            t, p = early[int(self.rng.integers(len(early)))]
            src[t, p] = src[lt, lp]
        elif mode == "dup_final":
            edges = np.argwhere(ops == OP_EDGE)
            if not edges.size:
                return None
            t, p = edges[int(self.rng.integers(len(edges)))]
            ops[t, p] = OP_FINAL  # its src row is already finalized once
        elif mode == "slot_cap":
            ev = np.argwhere((ctl == PS_LOAD) | (ctl == PS_STORE_RESET)
                             | (ctl == PS_SWAP))
            if not ev.size:
                return None
            t, p = ev[int(self.rng.integers(len(ev)))]
            slot[t, p] = 255  # beyond any configured register file
        elif mode == "use_before_def":
            ev = np.argwhere(ctl == PS_STORE_RESET)
            if not ev.size:
                return None
            t, p = ev[int(self.rng.integers(len(ev)))]
            ctl[t, p] = PS_LOAD  # the slot was free here: read-before-store
        else:
            raise ValueError(f"unknown schedule corruption mode {mode!r}")
        return dataclasses.replace(sir, ops=ops, src=src, ctl=ctl, slot=slot)

    def corrupt_emit(self, eir, mode: str):
        """Mutate the emitted trace (``mode``: envelope | stall_row)."""
        if mode == "envelope":
            row_lo = eir.row_lo.copy()
            t = int(self.rng.integers(row_lo.size))
            row_lo[t] += 1
            return dataclasses.replace(eir, row_lo=row_lo)
        if mode == "stall_row":
            t = int(self.rng.integers(eir.ops.shape[0] + 1))
            ins = {f: np.insert(getattr(eir, f), t, 0, axis=0)
                   for f in ("ops", "src", "ctl", "slot", "val_idx")}
            return dataclasses.replace(
                eir,
                row_lo=np.insert(eir.row_lo, t, eir.n),
                row_hi=np.insert(eir.row_hi, t, -1),
                **ins)
        raise ValueError(f"unknown emit corruption mode {mode!r}")


def run_fault_injection(mat: TriCSR, prog: Program | None = None, *,
                        trials_per_class: int = 3, seed: int = 0,
                        residual_tol: float = 1e-3,
                        classes: tuple[str, ...] = FAULT_CLASSES,
                        backend: str = "torch", device=None) -> list[dict]:
    """Inject every fault class and record how the stack responds.

    Returns one dict per trial: ``fault``, ``trial``, ``detected`` (which
    layer caught it: "verify" / "load" / "input" / "health" / "none"),
    ``degraded_to`` (the ladder rung that produced the returned answer,
    "" when the solve raised), and ``silent_wrong`` — True only when
    nothing detected anything AND the returned answer fails the residual
    check.  The acceptance bar is ``not any(r["silent_wrong"])``.

    ``backend`` is the solves' entry rung and ``device`` their device
    (`RobustSolver`).  On the cuda rung, the blocked kernel's refusal of a
    program with no window (`errors.PlacementInfeasibleError`) is a
    property of the program, not a detection, and is not counted as one.
    """
    from . import serialize
    from .schedule import compile_program

    if prog is None:
        prog = compile_program(mat)
    inj = FaultInjector(seed)
    rng = np.random.default_rng(seed + 1)
    results = []

    def solver(p):
        return RobustSolver(p, mat, backend=backend, device=device,
                            verify=False, residual_tol=residual_tol)

    def solve_outcome(bad_prog, b):
        """Solve a (possibly corrupt) program under full health checks."""
        rs = solver(bad_prog)
        try:
            x = rs.solve(b)
        except RobustnessError:
            return "health", "", True  # detected by raising: not silent
        caught = [i for i in rs.last_incidents if not _placement_refused(i)]
        degraded = rs.last_stage if caught else ""
        detected = "health" if caught else "none"
        ok = relative_residual(mat, x, b) <= residual_tol
        return detected, degraded, ok

    for fault in classes:
        for trial in range(trials_per_class):
            b = rng.standard_normal(mat.n)
            detected, degraded, ok = "none", "", True
            if fault in ("instr_bit_flip", "psum_slot"):
                bad = (inj.flip_instr_bits(prog, flips=1)
                       if fault == "instr_bit_flip"
                       else inj.corrupt_slots(prog, k=1))
                try:
                    verify_program(bad)
                except ProgramCorruptionError:
                    detected = "verify"
                else:
                    detected, degraded, ok = solve_outcome(bad, b)
            elif fault in ("value_plane_nan", "value_plane_scale"):
                mode = "nan" if fault.endswith("nan") else "scale"
                bad = inj.corrupt_stream(prog, k=2, mode=mode)
                try:
                    verify_program(bad)
                except ProgramCorruptionError:
                    detected = "verify"
                else:
                    detected, degraded, ok = solve_outcome(bad, b)
            elif fault == "blob":
                blob = serialize.dumps_program(prog)
                try:
                    serialize.loads_program(inj.corrupt_blob(blob, k=3))
                except ProgramCorruptionError:
                    detected = "load"
                else:  # pragma: no cover - CRC collision would be news
                    detected = "none"
            elif fault in ("rhs_nan", "rhs_inf"):
                val = np.nan if fault == "rhs_nan" else np.inf
                try:
                    solver(prog).solve(inj.poison_rhs(b, k=2, value=val))
                except NumericalHealthError:
                    detected = "input"
            else:  # pragma: no cover
                raise ValueError(f"unknown fault class {fault!r}")
            results.append({
                "fault": fault,
                "trial": trial,
                "detected": detected,
                "degraded_to": degraded,
                "silent_wrong": bool(detected == "none" and not ok),
            })
    return results


# ---------------------------------------------------------------------------
# IR-level fault injection (the per-pass verifiers' acceptance harness)
# ---------------------------------------------------------------------------
IR_FAULT_CLASSES = (
    "dag_self_edge",
    "partition_drop_consumer",
    "assign_owner_swap",
    "sched_raw",
    "sched_dup_final",
    "sched_slot_cap",
    "sched_use_before_def",
    "emit_envelope",
    "emit_stall_row",
    "pack_val_idx_oob",
)

# fault class -> the diagnostic code the matching verifier must fire
_IR_EXPECTED = {
    "dag_self_edge": "SPT118",
    "partition_drop_consumer": "SPT119",
    "assign_owner_swap": "SPT120",
    "sched_raw": "SPT111",
    "sched_dup_final": "SPT110",
    "sched_slot_cap": "SPT113",
    "sched_use_before_def": "SPT112",
    "emit_envelope": "SPT114",
    "emit_stall_row": "SPT121",
    "pack_val_idx_oob": "SPT106",
}


def run_ir_fault_injection(mat: TriCSR, cfg: AccelConfig | None = None, *,
                           seed: int = 0,
                           classes: tuple[str, ...] = IR_FAULT_CLASSES) -> list[dict]:
    """Mutate every intermediate IR post-pass; assert the verifiers catch it.

    Runs the staged pipeline once, then for each fault class corrupts the
    relevant IR (`FaultInjector.corrupt_*`) and runs *only* that stage's
    contract verifier (`core/analysis/contracts.py`).  Returns one dict
    per class: ``fault``, ``applicable`` (False when the workload has no
    site for this fault — e.g. no psum traffic), ``expected_code``,
    ``fired_codes`` (error-severity codes the verifier reported) and
    ``caught``.  The acceptance bar is ``caught`` for every applicable
    class — a mutation the verifiers miss would otherwise surface only as
    a generic corrupt-program failure after packing, unattributed.
    """
    from .analysis import contracts
    from .compiler import assign, elide, emit, partition, sched
    from .frontends.sptrsv import lower_tri

    cfg = cfg or AccelConfig()
    dag = lower_tri(mat)
    pir = partition.run(dag)
    air = assign.run(pir, cfg)
    sir = sched.run(air, cfg)
    eir = elide.run(sir)
    prog = emit.run(eir, cfg, planes=None)

    inj = FaultInjector(seed)
    results = []
    for fault in classes:
        expected = _IR_EXPECTED[fault]
        bad, diags = None, None
        if fault == "dag_self_edge":
            bad = inj.corrupt_dag(dag)
            if bad is not None:
                diags = contracts.verify_frontend(bad)
        elif fault == "partition_drop_consumer":
            bad = inj.corrupt_partition(pir)
            if bad is not None:
                diags = contracts.verify_partition(bad)
        elif fault == "assign_owner_swap":
            bad = inj.corrupt_assign(air)
            if bad is not None:
                diags = contracts.verify_assign(bad, cfg)
        elif fault.startswith("sched_"):
            bad = inj.corrupt_schedule(sir, fault[len("sched_"):])
            if bad is not None:
                diags = contracts.verify_schedule(bad, air, cfg)
        elif fault.startswith("emit_"):
            bad = inj.corrupt_emit(eir, fault[len("emit_"):])
            if bad is not None:
                diags = contracts.verify_emit(bad, sir)
        elif fault == "pack_val_idx_oob":
            bad = _copy_program(prog)
            bad.val_idx[0, 0] = np.int32(bad.stream.size + 7)
            diags = contracts.verify_packed_program(bad, eir, cfg)
        else:
            raise ValueError(f"unknown IR fault class {fault!r}")
        fired = sorted({d.code for d in diags
                        if d.severity == SEV_ERROR}) if diags is not None \
            else []
        results.append({
            "fault": fault,
            "applicable": bad is not None,
            "expected_code": expected,
            "fired_codes": fired,
            "caught": expected in fired,
        })
    return results


# ---------------------------------------------------------------------------
# service-level chaos harness (the resilient serving acceptance bar)
# ---------------------------------------------------------------------------
SERVICE_FAULT_CLASSES = (
    "backend_exception",   # entry rung raises; retry/backoff then degrade
    "backend_hang",        # entry rung stalls past flush_timeout_s
    "backend_nonfinite",   # entry rung returns NaN; health check degrades
    "disk_corrupt",        # program-cache disk blob corrupted between gets
    "rhs_poison",          # non-finite b: every rung unhealthy, typed fail
    "overload_burst",      # admission budgets exceeded: typed load sheds
    "expired_deadline",    # requests expire before / while queued
)


def run_service_fault_injection(mats=None, *, seed: int = 0,
                                requests: int = 24,
                                classes: tuple[str, ...] = SERVICE_FAULT_CLASSES,
                                residual_tol: float = 1e-3) -> list[dict]:
    """Drive a resilient `serve.SolveService` through fault schedules.

    For each fault class a fresh two-tenant service (numpy entry rung,
    `serve.ManualClock`, full resilience config) takes ``requests``
    submits while the class's faults fire through an injected
    stage-solver wrapper (exceptions / hangs / non-finite outputs on the
    entry rung), corrupted disk blobs, poisoned right-hand sides,
    overload bursts, or expiring deadlines — all seeded, all on virtual
    time.  Returns one dict per class::

        fault, tickets, completed, failed_typed, shed,
        silent_wrong, deadlocked, incidents

    where ``completed`` tickets were checked against the bit-exact
    stage-matched oracle (`executor.execute_numpy` for the entry rung,
    `csr.serial_solve` for the reference rung; residual fallback when a
    wide ticket mixed rungs), failed tickets must raise a typed
    `errors.RobustnessError`, and ``deadlocked`` is True if drain left
    pending columns behind.  The acceptance bar is zero ``silent_wrong``
    and zero ``deadlocked`` across every class and seed.  The results
    equal the JAX package's, seed for seed.
    """
    from .matrices import banded
    from .resilience import AdmissionConfig, BreakerConfig, ResilienceConfig, RetryPolicy
    from .schedule import compile_program
    from .serve import ManualClock, ProgramCache, SolveService

    if mats is None:
        mats = {"a": banded(96, 6, 0.5, seed=3, name="chaos-a"),
                "b": banded(80, 4, 0.6, seed=4, name="chaos-b")}
    mids = sorted(mats)
    oracle_progs = {mid: compile_program(m) for mid, m in mats.items()}

    def oracle_for(mid, b, stages):
        mat = mats[mid]
        bm = np.asarray(b, dtype=np.float64)
        bm2 = bm[:, None] if bm.ndim == 1 else bm
        if stages == {"reference"}:
            x = np.stack([serial_solve(mat, bm2[:, j])
                          for j in range(bm2.shape[1])], axis=1)
            return x[:, 0] if bm.ndim == 1 else x
        if stages == {"numpy"}:
            return np.asarray(execute_numpy(oracle_progs[mid], b))
        return None  # mixed rungs: residual check instead

    results = []
    for fault in classes:
        rng = np.random.default_rng(
            (seed * 1009 + zlib.crc32(fault.encode())) % 2 ** 31)
        clock = ManualClock()
        flush_timeout = 0.25
        res = ResilienceConfig(
            retry=RetryPolicy(max_retries=1, base_delay_s=0.01, seed=seed),
            breaker=BreakerConfig(window_s=50.0, min_samples=4,
                                  failure_threshold=0.75, cooldown_s=5.0),
            admission=AdmissionConfig(
                max_pending_per_matrix=6 if fault == "overload_burst"
                else None,
                max_pending_total=10 if fault == "overload_burst" else None),
            flush_timeout_s=flush_timeout)
        tmp = None
        cache_kw = {}
        if fault == "disk_corrupt":
            import tempfile

            tmp = tempfile.TemporaryDirectory()
            # capacity 1 with two tenants: every other get goes to disk
            cache_kw = {"capacity": 1, "disk_dir": tmp.name}
        svc = SolveService(ProgramCache(**cache_kw), max_batch=4,
                           max_delay=0.5, clock=clock, backend="numpy",
                           resilience=res)
        for mid, m in mats.items():
            svc.register(mid, m)

        # wrap the stage-solver factory with the fault plan: solver-level
        # faults fire on the entry rung only, so the reference rung keeps
        # the always-answers guarantee testable
        inj = FaultInjector(seed + 17)
        orig_stage_solver = svc._stage_solver
        solver_fault = {"backend_exception": "exception",
                        "backend_hang": "hang",
                        "backend_nonfinite": "nonfinite"}.get(fault)

        def chaotic(stage, prog, k, mat,
                    _orig=orig_stage_solver, _fault=solver_fault):
            fn = _orig(stage, prog, k, mat)
            if _fault is None or stage != "numpy":
                return fn

            def wrapped(bmat):
                if rng.random() < 0.5:
                    if _fault == "exception":
                        raise RuntimeError("injected backend fault")
                    if _fault == "hang":
                        clock.advance(flush_timeout * 2)
                        return fn(bmat)
                    x = np.asarray(fn(bmat)).copy()
                    x.reshape(-1)[int(rng.integers(x.size))] = np.nan
                    return x
                return fn(bmat)
            return wrapped

        svc._stage_solver = chaotic

        tickets = []
        for i in range(requests):
            mid = mids[int(rng.integers(len(mids)))]
            n = mats[mid].n
            # overload bursts need wide requests so the pending budgets
            # actually bind (narrow ones flush full before they pile up)
            k = int(rng.integers(1, 9 if fault == "overload_burst" else 4))
            b = rng.standard_normal((n, k)) if k > 1 \
                else rng.standard_normal(n)
            kw = {}
            if fault == "rhs_poison" and rng.random() < 0.4:
                b = inj.poison_rhs(b, k=1)
            if fault == "expired_deadline":
                # half the stream: deadlines that expire in the queue or
                # already lie in the past
                r = rng.random()
                if r < 0.25:
                    kw["timeout"] = -0.1          # expired before submit
                elif r < 0.5:
                    kw["timeout"] = 0.05          # expires while queued
            ticket = svc.submit(mid, b, **kw)
            tickets.append((ticket, b))
            if fault == "disk_corrupt" and i % 5 == 2 and tmp is not None:
                # corrupt every .prog blob currently on disk
                import glob as _glob

                for path in _glob.glob(os.path.join(tmp.name, "*.prog")):
                    with open(path, "rb") as f:
                        blob = f.read()
                    with open(path, "wb") as f:
                        f.write(inj.corrupt_blob(blob, k=3))
            clock.advance(float(rng.uniform(0.0, 0.3)))
            svc.pump()
        clock.advance(1.0)
        svc.pump()
        svc.drain()

        flush_by_index = {r.index: r for r in svc.stats.flushes
                          if r.index >= 0}
        completed = failed_typed = shed = 0
        silent_wrong = False
        for ticket, b in tickets:
            if not ticket.done:
                silent_wrong = True  # a lost ticket is as bad as a wrong one
                continue
            if ticket.shed:
                shed += 1
                continue
            if ticket.failed:
                failed_typed += isinstance(ticket.error, RobustnessError)
                silent_wrong |= not isinstance(ticket.error, RobustnessError)
                continue
            completed += 1
            x = ticket.result()
            stages = {flush_by_index[i].stage
                      for i in ticket.flush_indices if i in flush_by_index}
            want = oracle_for(ticket.matrix_id, b, stages)
            if want is not None:
                ok = np.array_equal(np.asarray(x, dtype=np.float64),
                                    np.asarray(want, dtype=np.float64))
            else:
                ok = relative_residual(mats[ticket.matrix_id], x, b) \
                    <= residual_tol
            silent_wrong |= not ok
        deadlocked = svc.pending_columns() > 0 or \
            any(not t.done for t, _ in tickets)
        results.append({
            "fault": fault,
            "tickets": len(tickets),
            "completed": completed,
            "failed_typed": failed_typed,
            "shed": shed,
            "silent_wrong": bool(silent_wrong),
            "deadlocked": bool(deadlocked),
            "incidents": len(svc.incidents),
        })
        if tmp is not None:
            tmp.cleanup()
    return results
