"""Public API of the port's SpTRSV core library.

Ports `repro/core/api.py` (the lower-triangular solve path):

    from repro_torch.core import api
    mat = api.matrix("ckt_add20")
    prog = api.compile(mat)                      # medium dataflow, ICR, psum
    x = api.solve(prog, b)                       # torch executor
    X = api.solve_batch(prog, B, backend="cuda") # many RHS, Hopper kernels
    solver = api.make_solver(prog, batch=32, backend="cuda")  # cached closure
    api.report(prog)                             # paper metrics

Every entry point runs on the CUDA device unless the caller passes
``device="cpu"`` (a machine without CUDA raises instead of falling back).
Two backends: ``"torch"`` (the eager per-cycle executor, any device) and
``"cuda"`` (the hand-written kernels; on ``device="cpu"`` their plain
PyTorch versions).  Executors are cached per (program identity, padded
batch width, knobs, device), so repeated solves never rebuild.

``mesh=`` (multi-GPU column sharding) raises ``NotImplementedError`` until
the port has a multi-device path.
"""

from __future__ import annotations

import numpy as np

from . import matrices
from .csr import (  # noqa: F401  (random_rhs re-exported for callers)
    TriCSR,
    random_rhs,
    serial_solve,
)
from .executor import (
    as_batch,
    execute_numpy,
    execute_torch,
    make_cuda_executor,
    make_torch_executor,
    validate_backend,
)
from .program import AccelConfig, Program
from .schedule import compile_program

__all__ = [
    "matrix",
    "compile",
    "recompile_values",
    "solve",
    "solve_batch",
    "make_solver",
    "solve_numpy",
    "reference_solve",
    "report",
    "AccelConfig",
    "Program",
    "TriCSR",
]


def matrix(name: str) -> TriCSR:
    return matrices.generate(name)


def compile(mat: TriCSR, cfg: AccelConfig | None = None, *,  # noqa: A001
            schedule: str = "paper",
            verify_ir: bool = False) -> Program:
    """Compile ``mat``; ``schedule="auto"`` picks the predicted-cheapest
    scheduler strategy per matrix (`compiler.strategies`).  ``verify_ir``
    raises ``NotImplementedError`` until the port has ``core.analysis``."""
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
