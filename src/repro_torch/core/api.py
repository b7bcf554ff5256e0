"""Public API of the port's SpTRSV core library.

Ports `repro/core/api.py`:

    from repro_torch.core import api
    mat = api.matrix("ckt_add20")
    prog = api.compile(mat)                      # medium dataflow, ICR, psum
    x = api.solve(prog, b)                       # torch executor
    X = api.solve_batch(prog, B, backend="cuda") # many RHS, Hopper kernels
    solver = api.make_solver(prog, batch=32, backend="cuda")  # cached closure
    api.report(prog)                             # paper metrics

DAG-workload frontends (DESIGN.md §6): SpTRSV-like workloads beyond Lx=b
compile to the same `Program` format and run on every executor and both
kernels:

    cw = api.compile_upper(U)                    # Ux=b (UpperCSR)
    x = cw.solve(b, backend="cuda")              # or api.solve_upper(cw, b)
    pair = api.compile_pair(L)                   # Ly=b then Lᵀx=y (IC sweep)
    x = pair.solve(b, backend="cuda")
    cw = api.compile_circuit(circ)               # general DAG circuit
    y = cw.solve(u, backend="cuda")
    prog, split = api.compile_split(L)           # heavy rows split
    x = api.solve_split(prog, split, b, backend="cuda")

Compile once, serve many (DESIGN.md §7): `save_program` / `load_program`
round-trip a compiled `Program` through the versioned, CRC32-checksummed
on-disk format (`core.serialize`, the JAX package's format byte for byte);
a damaged blob raises `ProgramCorruptionError` and never executes, and
``load_program(verify=True)`` also runs the hazard analysis
(`verify_program`).  Static analysis (DESIGN.md §8): every compile entry
point takes ``verify_ir=True`` (per-pass IR contracts, raising
`errors.IRValidationError` naming the guilty pass) and `analyze_program`
returns an `analysis.AnalysisReport` of hazards and SPT2xx lints:

    api.save_program(prog, "ckt.prog")
    prog = api.load_program("ckt.prog")          # CRC + structural verify
    report = api.analyze_program(prog)           # report.ok(), .render()

The hardened solve path and the solve service (DESIGN.md §7, §9, §10):
`robust_solver` checks every solve's inputs and outputs and degrades
through the ladder cuda-blocked → cuda-resident → torch → numpy →
reference with an `Incident` per step down; `make_service` micro-batches a
stream of ``(matrix_id, b)`` requests over a cache of compiled programs:

    rs = api.robust_solver(prog, mat, backend="cuda")
    x = rs(b)                                    # rs.last_stage, .last_incidents
    svc = api.make_service({"ckt": mat}, backend="cuda")
    ticket = svc.submit("ckt", b); svc.drain(); x = ticket.result()

Every entry point runs on the CUDA device unless the caller passes
``device="cpu"`` (a machine without CUDA raises instead of falling back).
Two backends: ``"torch"`` (the eager per-cycle executor, any device) and
``"cuda"`` (the hand-written kernels; on ``device="cpu"`` their plain
PyTorch versions); `CompiledWorkload.solve` also takes ``"numpy"`` (the
float64 oracle).  Executors are cached per (program identity, padded
batch width, knobs, device), so repeated solves never rebuild.

``mesh=`` (multi-GPU column sharding) raises ``NotImplementedError`` until
the port has a multi-device path.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import matrices
from .compiler import ComputeDag, compile_dag as _compile_dag
from .csr import (  # noqa: F401  (random_rhs re-exported for callers)
    TriCSR,
    UpperCSR,
    random_rhs,
    serial_solve,
    transpose_upper,
)
from .dag import DagInfo, analyze  # noqa: F401  (analyze is public API)
from .executor import (
    as_batch,
    execute_numpy,
    execute_torch,
    make_cuda_executor,
    make_torch_executor,
    validate_backend,
)
from .fine import FineConfig, FineStats, schedule_fine
from .frontends.dagcirc import DagCircuit, lower_circuit
from .frontends.upper import lower_upper
from .program import AccelConfig, Program
from .schedule import compile_program

__all__ = [
    "matrix",
    "compile",
    "recompile_values",
    "compile_dag",
    "compile_upper",
    "compile_pair",
    "compile_circuit",
    "compile_split",
    "solve",
    "solve_batch",
    "solve_upper",
    "solve_pair",
    "solve_split",
    "make_solver",
    "solve_numpy",
    "reference_solve",
    "report",
    "baseline_coarse",
    "baseline_fine",
    "save_program",
    "load_program",
    "verify_program",
    "analyze_program",
    "robust_solver",
    "make_service",
    "AccelConfig",
    "Program",
    "CompiledWorkload",
    "SolvePair",
    "TriCSR",
    "UpperCSR",
    "DagInfo",
]


def matrix(name: str) -> TriCSR:
    return matrices.generate(name)


def compile(mat: TriCSR, cfg: AccelConfig | None = None, *,  # noqa: A001
            schedule: str = "paper",
            verify_ir: bool = False) -> Program:
    """Compile ``mat``; ``schedule="auto"`` picks the predicted-cheapest
    scheduler strategy per matrix (`compiler.strategies`, DESIGN.md §11);
    ``verify_ir=True`` runs the per-pass IR contract verifiers."""
    return compile_program(mat, cfg, schedule=schedule, verify_ir=verify_ir)


def recompile_values(prog: Program, mat: TriCSR) -> Program:
    """Values-only recompilation for factorization loops.

    ``mat`` must share the compiled program's sparsity pattern; the
    schedule is reused and only the value stream regathers through the
    program's provenance plane — a *new* `Program` (executor caches key
    on identity), bit-identical to a full recompile.  Raises
    ``ValueError`` on a pattern mismatch.
    """
    from .schedule import recompile_values as _recompile

    return _recompile(prog, mat)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (multi-GPU column sharding) is not ported yet")


def solve(prog: Program, b: np.ndarray, *, device=None) -> np.ndarray:
    """Solve Lx=b with the cached torch executor.

    ``b`` may be ``[n]`` or ``[n, B]``; 2-D input runs the batched path
    (one instruction-stream pass for all B columns).
    """
    return execute_torch(prog, b, device=device)


def solve_batch(prog: Program, b_matrix: np.ndarray, mesh=None,
                backend: str = "torch", **backend_opts) -> np.ndarray:
    """Solve Lx=b for every column of ``b_matrix`` (shape ``[n, B]``).

    One pass over the compiled instruction stream solves all B right-hand
    sides; the batch axis is padded to a lane-friendly width and the
    executor is cached per (program, padded width, knobs, device).  A 1-D
    ``b`` is treated as ``B=1`` and returns shape ``[n, 1]``.

    ``backend="cuda"`` solves through the Hopper kernels (see `make_solver`
    for the placement knobs, including the row-blocked large-n path).
    Returns a numpy array.
    """
    validate_backend(backend, backend_opts)
    _no_mesh(mesh)
    bmat, _ = as_batch(b_matrix)
    solver = make_solver(prog, batch=bmat.shape[1], backend=backend,
                         **backend_opts)
    return solver(bmat).cpu().numpy()


def make_solver(prog: Program, batch: int | None = None, mesh=None,
                backend: str = "torch", **backend_opts):
    """Return a cached solve closure for `prog`.

    * ``batch=None`` — `solver(b[n]) -> x[n]`;
    * ``batch=B``    — `solver(b[n, B]) -> x[n, B]` (batched multi-RHS).

    The closure takes numpy arrays or tensors and returns a tensor on the
    solver's device.  ``device=`` (every backend) names that device, CUDA
    by default.  ``backend="cuda"`` executes through the Hopper kernels;
    its other keywords are the kernel knobs (``cycles_per_block``,
    ``placement`` in {"auto", "resident", "blocked"}, ``smem_limit_bytes``,
    ``x_block_rows`` — see
    `executor.make_cuda_executor`); the closure's ``placement`` attribute
    says which regime it took.
    """
    validate_backend(backend, backend_opts)
    _no_mesh(mesh)
    if backend == "cuda":
        return make_cuda_executor(prog, batch=batch, **backend_opts)
    return make_torch_executor(prog, batch=batch, **backend_opts)


# ---------------------------------------------------------------------------
# DAG-workload frontends (DESIGN.md §6): upper / transpose / circuit solves
# ---------------------------------------------------------------------------
@dataclasses.dataclass(eq=False)
class CompiledWorkload:
    """A compiled frontend workload: `Program` + internal↔user index map.

    Frontends whose internal node numbering differs from the user's
    unknowns (e.g. the reversed upper-triangular solve) carry ``perm``:
    internal node ``k`` solves user unknown ``perm[k]``, so the program
    consumes ``b[perm]`` and its solution scatters back through ``perm``.
    ``perm=None`` means the identity (lower-tri, circuits).

    `solve` accepts ``[n]`` or ``[n, B]`` right-hand sides and returns a
    numpy array.  ``backend`` is ``"numpy"`` (the float64 oracle, no
    options), ``"torch"`` or ``"cuda"`` with the keywords of `solve_batch`
    (``device=``, and for ``"cuda"`` the placement knobs of `make_solver`):
    the emitted `Program` format is unchanged, so every execution path
    works on every frontend workload.
    """

    program: Program
    perm: np.ndarray | None = None
    name: str = ""

    def solve(self, b: np.ndarray, *, backend: str = "torch", mesh=None,
              **backend_opts) -> np.ndarray:
        b = np.asarray(b)
        single = b.ndim == 1
        bi = b[self.perm] if self.perm is not None else b
        if backend == "numpy":
            if mesh is not None or backend_opts:
                raise ValueError("backend='numpy' takes no mesh/extra options")
            xi = execute_numpy(self.program, bi)
        else:
            xi = solve_batch(self.program, bi, mesh=mesh, backend=backend,
                             **backend_opts)
            if single:
                xi = xi[:, 0]
        if self.perm is None:
            return xi
        x = np.empty_like(xi)
        x[self.perm] = xi
        return x


@dataclasses.dataclass(eq=False)
class SolvePair:
    """Forward+backward sweep pair: Ly=b then Lᵀx=y from ONE factor L.

    One incomplete-Cholesky preconditioner application is
    ``x = Lᵀ \\ (L \\ b)``; `compile_pair` compiles both sweeps once and
    this object replays them per application (any backend/placement knobs
    are shared by both sweeps).
    """

    forward: CompiledWorkload   # Ly=b (identity perm)
    backward: CompiledWorkload  # Lᵀx=y (reversed node order)

    def solve(self, b: np.ndarray, **opts) -> np.ndarray:
        return self.backward.solve(self.forward.solve(b, **opts), **opts)


def compile_dag(dag: ComputeDag, cfg: AccelConfig | None = None, *,
                planes: int | None = None,
                schedule: str = "paper",
                verify_ir: bool = False) -> Program:
    """Compile a generic `compiler.ComputeDag` through the staged pipeline.

    ``schedule`` picks the schedule pass — ``"paper"``, an alternative
    strategy name, or ``"auto"`` for per-matrix cost-model selection
    (DESIGN.md §11).  ``verify_ir=True`` runs the per-pass contract
    verifiers between stages (`core/analysis/`) and raises
    `errors.IRValidationError` naming the guilty pass on the first broken
    invariant.
    """
    return _compile_dag(dag, cfg, planes=planes, schedule=schedule,
                        verify_ir=verify_ir)


def compile_upper(mat: UpperCSR, cfg: AccelConfig | None = None, *,
                  planes: int | None = None,
                  schedule: str = "paper",
                  verify_ir: bool = False) -> CompiledWorkload:
    """Compile the upper-triangular solve Ux=b (CSC-row reversal frontend)."""
    dag, perm = lower_upper(mat)
    return CompiledWorkload(_compile_dag(dag, cfg, planes=planes,
                                         schedule=schedule,
                                         verify_ir=verify_ir),
                            perm=perm, name=mat.name)


def compile_pair(mat: TriCSR, cfg: AccelConfig | None = None, *,
                 planes: int | None = None,
                 schedule: str = "paper",
                 verify_ir: bool = False) -> SolvePair:
    """Compile the forward (Ly=b) + backward (Lᵀx=y) sweep pair of ``mat``."""
    fwd = CompiledWorkload(compile_program(mat, cfg, planes=planes,
                                           schedule=schedule,
                                           verify_ir=verify_ir),
                           name=mat.name)
    bwd = compile_upper(transpose_upper(mat), cfg, planes=planes,
                        schedule=schedule, verify_ir=verify_ir)
    return SolvePair(forward=fwd, backward=bwd)


def compile_circuit(circ: DagCircuit, cfg: AccelConfig | None = None, *,
                    planes: int | None = None,
                    schedule: str = "paper",
                    verify_ir: bool = False) -> CompiledWorkload:
    """Compile a general DAG circuit (`frontends.dagcirc`) workload."""
    return CompiledWorkload(_compile_dag(lower_circuit(circ), cfg,
                                         planes=planes, schedule=schedule,
                                         verify_ir=verify_ir),
                            name=circ.name)


def solve_upper(cw: CompiledWorkload | UpperCSR, b: np.ndarray,
                **opts) -> np.ndarray:
    """Solve Ux=b; accepts a `CompiledWorkload` (preferred — reuses the
    compile) or a raw `UpperCSR` (compiled ad hoc)."""
    if isinstance(cw, UpperCSR):
        cw = compile_upper(cw)
    return cw.solve(b, **opts)


def solve_pair(pair: SolvePair, b: np.ndarray, **opts) -> np.ndarray:
    """Run one forward+backward preconditioner application through `pair`."""
    return pair.solve(b, **opts)


def save_program(prog: Program, path) -> None:
    """Persist a compiled program in the checksummed on-disk format
    (`core.serialize`, DESIGN.md §7) for compile-once/serve-many reuse."""
    from .serialize import save_program as _save

    _save(prog, path)


def load_program(path, *, verify: bool = True) -> Program:
    """Load a program saved by `save_program`; CRC mismatches and (with
    ``verify=True``) structural violations raise `ProgramCorruptionError`."""
    from .serialize import load_program as _load

    return _load(path, verify=verify)


def verify_program(prog: Program) -> None:
    """Structurally validate a compiled program; raises
    `ProgramCorruptionError` on the first violated invariant.

    `core.robust` holds it beside the checks that use it: `robust_solver`
    verifies its program at construction, and `load_program` (also the
    service's disk tier) before returning one.
    """
    from .robust import verify_program as _verify

    _verify(prog)


def analyze_program(prog: Program, *, lint: bool = True):
    """Full static analysis of a compiled program (`core.analysis`).

    Returns an `analysis.AnalysisReport`: correctness diagnostics (the
    same hazard checks `verify_program` raises on, collected instead of
    raised) plus, with ``lint=True``, the SPT2xx performance lints.
    ``report.ok()`` is True when no error-severity diagnostic was found;
    ``report.render()`` / ``report.to_json()`` render it.
    """
    from .analysis import analyze_program as _analyze

    return _analyze(prog, lint=lint)


def robust_solver(prog: Program, mat: TriCSR | None = None, **opts):
    """Health-checked solve closure with graceful degradation.

    Returns a `core.robust.RobustSolver` — callable like the `make_solver`
    closures (``solver(b)`` with ``b`` of shape ``[n]`` or ``[n, B]``, but
    numpy out) with input validation, output health checks (non-finite x,
    relative residual against ``mat`` when retained), and the
    deterministic fallback ladder cuda-blocked → cuda-resident → torch →
    numpy → reference with machine-readable incident records (DESIGN.md
    §7).  ``backend`` ("cuda", "torch" — the default — or "numpy") is the
    entry rung and ``device`` (CUDA when None) the device of the cuda and
    torch rungs, resolved at construction.
    """
    from .robust import RobustSolver

    return RobustSolver(prog, mat, **opts)


def make_service(matrices=None, *, capacity: int = 32, disk_dir=None,
                 max_batch: int = 16, max_delay: float = 1e-3,
                 clock=None, timer=None, cfg: AccelConfig | None = None,
                 schedule: str = "paper", backend: str = "torch", mesh=None,
                 resilience=None, device=None, **backend_opts):
    """Build a production solve service (`core.serve`, DESIGN.md §9).

    Returns a `serve.SolveService` over a fresh `serve.ProgramCache`
    (bounded LRU of ``capacity`` programs keyed by the structure-only
    `serve.pattern_fingerprint`; ``disk_dir=`` adds the CRC-verified disk
    tier that rehydrates evicted entries through `save_program` /
    `load_program` instead of recompiling, file for file the JAX
    package's).  ``matrices`` is an optional ``{matrix_id: TriCSR}`` dict
    to register up front; more tenants can join later via
    ``service.register``.

    Requests stream in through ``service.submit(matrix_id, b)`` (``b`` of
    shape ``[n]`` or ``[n, k]``) and micro-batch per matrix into the
    padded widths the executor cache keys on; a bucket flushes at
    ``max_batch`` columns or when its oldest column ages past
    ``max_delay`` seconds (checked by ``service.pump()`` / at the next
    submit; ``service.drain()`` flushes everything).  The scheduling core
    runs entirely on the injectable ``clock`` — here, and only here, a
    missing clock defaults to the wall (``time.monotonic``); construct
    `serve.SolveService` directly (or pass a `serve.ManualClock`) for
    deterministic tests.

    ``backend`` ("numpy", "torch" or "cuda") and ``backend_opts`` choose
    the execution path per `make_solver`, shared by every flush;
    ``device`` (CUDA when None) is resolved at construction.  ``mesh=``
    raises `NotImplementedError` (no multi-GPU path yet).

    ``resilience`` (a `resilience.ResilienceConfig`, DESIGN.md §10) arms
    the resilient flush path: per-request deadlines
    (``submit(..., deadline=|timeout=)``), retry with deterministic
    backoff through the backend ladder, per-(matrix, rung) circuit
    breakers, admission-control load shedding, and the unified SPT3xx
    incident report (``service.report()``).  A production resilience
    config usually passes ``sleep=time.sleep`` so backoff really waits;
    the default config never sleeps (virtual-clock friendly).
    """
    from . import serve

    if clock is None:
        import time

        clock = time.monotonic
    cache = serve.ProgramCache(capacity=capacity, disk_dir=disk_dir, cfg=cfg,
                               schedule=schedule)
    svc = serve.SolveService(cache, max_batch=max_batch,
                             max_delay=max_delay, clock=clock, timer=timer,
                             backend=backend, mesh=mesh, resilience=resilience,
                             device=device, **backend_opts)
    for mid, m in (matrices or {}).items():
        svc.register(mid, m)
    return svc


def solve_numpy(prog: Program, b: np.ndarray) -> np.ndarray:
    """Reference numpy executor; accepts ``[n]`` or ``[n, B]`` like `solve`."""
    return execute_numpy(prog, b)


def reference_solve(mat: TriCSR, b: np.ndarray) -> np.ndarray:
    return serial_solve(mat, b)


def report(prog: Program) -> dict:
    st, cfg = prog.stats, prog.config
    out = {
        "name": st.name,
        "n": st.n,
        "nnz": st.nnz,
        # which scheduler strategy produced this program; auto compiles
        # also expose the per-candidate predictions
        "schedule": getattr(st, "schedule", "paper"),
        "cycles": st.cycles,
        "emitted_cycles": st.emitted_cycles,
        "planes": prog.planes,
        "instr_bytes": prog.instr_bytes(),
        "throughput_gops": round(st.throughput_gops(cfg), 3),
        "peak_gops": round(st.peak_throughput_gops(cfg), 3),
        "pe_utilization": round(st.utilization(), 4),
        "load_balance_cv_pct": round(st.load_balance_cv(), 1),
        "compile_s": round(st.compile_seconds, 4),
        "dm_escapes": st.dm_escapes,
        **{k: round(v, 4) for k, v in st.nop_breakdown().items()},
        "constraints": st.constraints,
        "conflicts": st.conflicts,
        "reuse_events": st.reuse_events,
    }
    if getattr(st, "schedule_costs", None):
        out["schedule_costs"] = st.schedule_costs
    return out


def compile_split(mat: TriCSR, cfg: AccelConfig | None = None,
                  max_indegree: int = 64):
    """Beyond-paper path: split heavy nodes (core.transform), then compile.

    Returns (program, split_result); solve with `solve_split`, which
    accepts single (``[n]``) and batched (``[n, B]``) right-hand sides.
    """
    from .transform import split_heavy_nodes

    split = split_heavy_nodes(mat, max_indegree=max_indegree)
    return compile_program(split.mat, cfg), split


def solve_split(prog: Program, split, b: np.ndarray, mesh=None,
                backend: str = "torch", **backend_opts) -> np.ndarray:
    """Solve through a node-splitting transform; ``b`` is ``[n]`` or ``[n, B]``.

    `SplitResult.expand_rhs` / `extract` preserve a trailing batch axis, so
    node splitting composes with the batched executors and with the
    kernels' placements (``backend="cuda"`` + `make_solver` knobs,
    including the row-blocked large-n regime).  Returns a numpy array.
    """
    eb = split.expand_rhs(np.asarray(b))
    x = solve_batch(prog, eb, mesh=mesh, backend=backend, **backend_opts)
    return split.extract(x[:, 0] if eb.ndim == 1 else x)


def baseline_coarse(mat: TriCSR, base: AccelConfig | None = None) -> Program:
    cfg = base or AccelConfig()
    return compile_program(
        mat, dataclasses.replace(cfg, dataflow="coarse", icr=False, psum_cache=False)
    )


def baseline_fine(mat: TriCSR, cfg: FineConfig | None = None) -> FineStats:
    return schedule_fine(mat, cfg)
