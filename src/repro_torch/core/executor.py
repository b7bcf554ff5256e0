"""Executors for compiled VLIW programs.

Ports `repro/core/executor.py`.  Three implementations of identical
semantics:

  * `execute_numpy`  — per-cycle numpy loop in float64, vectorized over
                       CUs and batch (the oracle; copied unchanged);
  * the torch executor (backend ``"torch"``, `make_torch_executor`) — an
    eager per-cycle loop over ``[P, B]`` tensors on any device, the
    counterpart of the JAX package's ``lax.scan`` executor;
  * the Hopper kernels in `repro_torch.kernels.sptrsv` (backend ``"cuda"``,
    `make_cuda_executor`), resident and row-blocked.

Per-cycle semantics (see program.py): the psum control is applied first
(it configures the S1/S2 muxes and psum register file of Fig. 4b), then the
PE op executes.  Edges only ever read x values finalized in *earlier*
cycles (the scheduler guarantees it), so a cycle can be evaluated as one
parallel gather/FMA/scatter over all CUs.

Batched multi-RHS execution: the instruction stream depends only on L, so
one pass over it solves ``B`` right-hand sides at once (state ``x[n + 1,
B]``, ``feedback[P, B]``, ``rf[P, S, B]``).  Executors are cached per
compiled program, *padded* batch width (`pad_batch`), knobs and device, so
repeated solves never rebuild; `trace_count` counts the builds.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from repro_torch.spans import span

from .program import (
    OP_EDGE,
    OP_FINAL,
    PS_LOAD,
    PS_RESET,
    PS_STORE_RESET,
    PS_SWAP,
    Program,
    decode_instructions,
)
from .schedule import PSUM_OVERFLOW_SLOTS

__all__ = [
    "as_batch",
    "batched_entry",
    "build_solve_cols",
    "cached_entries",
    "execute_numpy",
    "execute_torch",
    "make_torch_executor",
    "make_cuda_executor",
    "pad_batch",
    "trace_count",
    "validate_backend",
]

BATCH_PAD = 8  # batch widths are padded to a multiple of this (lane-friendly)

# Bumped whenever an executor is built (the port's "trace"); tests use it to
# assert that the per-program cache prevents rebuilding.
_TRACE_COUNT = 0

# prog -> {cache key -> solve closure}; weak keys let programs die.
_EXEC_CACHE: "weakref.WeakKeyDictionary[Program, dict]" = weakref.WeakKeyDictionary()


def trace_count() -> int:
    """Number of executors built so far (cache-hit observability)."""
    return _TRACE_COUNT


def cached_entries(prog: Program) -> list:
    """Keys of the per-program executor cache (cache-hit observability).

    Torch entries are ``("torch", width, device)`` and cuda entries
    ``("cuda", width, *knobs, device)`` tuples; every ``width`` is a padded
    width (the cache-key contract asserted in `_cached_executor`)."""
    return sorted(_EXEC_CACHE.get(prog, {}), key=repr)


def pad_batch(width: int) -> int:
    """Round a batch width up to the lane-friendly padded width."""
    if width <= 1:
        return 1
    return -(-width // BATCH_PAD) * BATCH_PAD


def as_batch(b, dtype=None) -> tuple[np.ndarray, bool]:
    """Normalize a RHS to ``([n, B], was_1d)`` — shared by all executors.

    With ``dtype=None``, arrays (including torch tensors) pass through
    without a copy; only array-likes are coerced.
    """
    if dtype is not None or not hasattr(b, "ndim"):
        b = np.asarray(b, dtype=dtype)
    single = b.ndim == 1
    return (b[:, None] if single else b), single


def _psum_slots(prog: Program) -> int:
    base = prog.config.psum_words + PSUM_OVERFLOW_SLOTS
    return max(base, prog.num_slots or 0)


def execute_numpy(prog: Program, b: np.ndarray) -> np.ndarray:
    """Reference interpretation of the instruction stream.

    Accepts ``b`` of shape ``[n]`` (single RHS) or ``[n, B]`` (batched);
    returns ``x`` of the matching shape.  Each cycle is evaluated as one
    vectorized gather/FMA/select/scatter over all CUs and all RHS columns.
    """
    bmat, single = as_batch(b, dtype=np.float64)
    nb = bmat.shape[1]

    n, p = prog.n, prog.num_cus
    x = np.zeros((n + 1, nb), dtype=np.float64)
    feedback = np.zeros((p, nb), dtype=np.float64)
    rf = np.zeros((p, _psum_slots(prog), nb), dtype=np.float64)
    stream = prog.stream.astype(np.float64)
    lanes = np.arange(p)
    planes = prog.planes

    for t in range(prog.cycles):
        # shared packed decode — NOP lanes carry word 0, i.e. ctrl PS_KEEP
        op, src, ctrl, slot = decode_instructions(prog.instr[t], planes)
        slot = slot.astype(np.intp)
        ctb = ctrl[:, None]

        pv = feedback
        slot_val = rf[lanes, slot]  # [p, nb]
        # psum control mux (S1/S2 of Fig. 4b)
        pv = np.where(ctb == PS_RESET, 0.0, pv)
        pv = np.where(ctb == PS_LOAD, slot_val, pv)
        store = (ctrl == PS_STORE_RESET) | (ctrl == PS_SWAP)
        rf[lanes[store], slot[store]] = feedback[store]
        pv = np.where(ctb == PS_STORE_RESET, 0.0, pv)
        pv = np.where(ctb == PS_SWAP, slot_val, pv)

        v = stream[prog.val_idx[t]][:, None]  # [p, 1]
        edge = op == OP_EDGE
        pv = np.where(edge[:, None], pv + v * x[src], pv)
        fin = op == OP_FINAL
        if fin.any():
            # FINAL writes x[src] (the derived out index); finalized rows
            # are distinct within a cycle (scheduler guarantee)
            x[src[fin]] = (bmat[src[fin]] - pv[fin]) * v[fin]
        feedback = pv
    xr = x[:n]
    return xr[:, 0] if single else xr


def _to_device(b, device: torch.device) -> torch.Tensor:
    """A RHS as a float32 tensor on ``device`` (no copy when it already is);
    span ``exec.h2d``."""
    with span("exec.h2d"):
        if not isinstance(b, torch.Tensor):
            b = torch.from_numpy(np.asarray(b))
        return b.to(device=device, dtype=torch.float32)


def build_solve_cols(prog: Program, width: int, device=None):
    """`solve(b[n, width]) -> x[n, width]` over the instruction stream.

    The counterpart of the JAX package's ``lax.scan`` executor: the
    decoded instruction planes and gathered values are staged on
    ``device`` (None: the CUDA device) once, and each call runs an eager
    per-cycle loop whose state is ``(x, feedback, psum_rf)``, each with a
    trailing batch axis of ``width`` RHS columns.  Row ``x[n]`` absorbs the
    scatter of non-FINAL lanes.
    """
    from repro_torch.kernels.common import resolve_device

    device = resolve_device(device)
    n, p = prog.n, prog.num_cus
    op, si, ct, sl = (torch.from_numpy(f.astype(np.int64)).to(device)
                      for f in decode_instructions(prog.instr, prog.planes))
    vals = torch.from_numpy(prog.stream[prog.val_idx].astype(np.float32)).to(device)
    nslots = _psum_slots(prog)
    lanes = torch.arange(p, device=device)

    def solve_cols(b: torch.Tensor) -> torch.Tensor:
        bx = torch.cat([b, b.new_zeros(1, width)])
        x = b.new_zeros(n + 1, width)
        feedback = b.new_zeros(p, width)
        rf = b.new_zeros(p, nslots, width)
        for t in range(prog.cycles):
            ctb = ct[t][:, None]
            pv = feedback
            slot_val = rf[lanes, sl[t]]  # [p, width]
            # psum control mux (S1/S2 of Fig. 4b)
            pv = torch.where(ctb == PS_RESET, 0.0, pv)
            pv = torch.where(ctb == PS_LOAD, slot_val, pv)
            store = (ctb == PS_STORE_RESET) | (ctb == PS_SWAP)
            rf[lanes, sl[t]] = torch.where(store, feedback, slot_val)
            pv = torch.where(ctb == PS_STORE_RESET, 0.0, pv)
            pv = torch.where(ctb == PS_SWAP, slot_val, pv)

            v = vals[t][:, None]
            src = si[t]
            pv = torch.where((op[t] == OP_EDGE)[:, None], pv + v * x[src], pv)
            outv = (bx[src] - pv) * v
            # derived out index: FINAL writes x[src], everything else
            # scatters into the dummy row x[n]
            x[torch.where(op[t] == OP_FINAL, src, n)] = outv
            feedback = pv
        return x[:n]

    return solve_cols


def _cached_executor(prog: Program, width: int, device: torch.device):
    # Cache-key contract: entries are keyed by the *padded* width — every
    # caller rounds with `pad_batch` before lookup, so batch sizes that pad
    # equal share one executor.  An unpadded width reaching this point is a
    # caller bug, not a cache miss.
    global _TRACE_COUNT
    if width != pad_batch(width):
        raise AssertionError(
            f"executor cache key must be a padded width "
            f"(pad_batch({width}) == {pad_batch(width)}), got {width}")
    per_prog = _EXEC_CACHE.setdefault(prog, {})
    key = ("torch", width, str(device))
    fn = per_prog.get(key)
    if fn is None:
        fn = build_solve_cols(prog, width, device)
        _TRACE_COUNT += 1
        per_prog[key] = fn
    return fn


def batched_entry(core, n: int, batch: int, width: int, device: torch.device):
    """Shared `solver(b[n, batch]) -> x[n, batch]` entry wrapper.

    Moves ``b`` to ``device`` as float32, validates the shape, pads the
    batch axis to ``width``, calls ``core`` and slices the pad columns back
    off.  Returns a tensor on ``device``.
    """

    def solve_many(bmat):
        bmat = _to_device(bmat, device)
        if tuple(bmat.shape) != (n, batch):
            raise ValueError(f"expected b of shape {(n, batch)}, got "
                             f"{tuple(bmat.shape)}")
        if batch == 0:
            return bmat.new_zeros(n, 0)
        if batch != width:
            bmat = torch.nn.functional.pad(bmat, (0, width - batch))
        return core(bmat)[:, :batch]

    return solve_many


def _single_entry(core, n: int, device: torch.device):
    """`solver(b[n]) -> x[n]` over a width-1 core."""

    def solve_one(b):
        b = _to_device(b, device)
        if tuple(b.shape) != (n,):
            raise ValueError(f"expected b of shape {(n,)}, got {tuple(b.shape)}")
        return core(b[:, None])[:, 0]

    return solve_one


def make_torch_executor(prog: Program, batch: int | None = None, *, device=None):
    """Build (or fetch from cache) a torch-executor solve closure for `prog`.

    * ``batch=None`` — `solve(b[n]) -> x[n]`, the classic single-RHS form.
    * ``batch=B``    — `solve(b[n, B]) -> x[n, B]`: one pass over the
      instruction stream solves all B columns.

    ``device=None`` is the CUDA device.  The closure returns a tensor on
    the device; the executor is cached per (program identity, padded batch
    width, device).
    """
    from repro_torch.kernels.common import resolve_device

    dev = resolve_device(device)
    if batch is None:
        return _single_entry(_cached_executor(prog, 1, dev), prog.n, dev)
    width = pad_batch(batch)
    return batched_entry(_cached_executor(prog, width, dev), prog.n, batch,
                         width, dev)


_CUDA_OPTS = ("cycles_per_block", "placement", "smem_limit_bytes",
              "x_block_rows", "device")


def validate_backend(backend: str, backend_opts: dict) -> None:
    """Shared backend-argument check for the api solver entry points.

    Rejections use the structured taxonomy (`core.errors`):
    `UnknownBackendError` for a backend name outside ``("torch",
    "cuda")``, `BackendOptionsError` for options a backend does not take
    (``"torch"`` takes only ``device``).
    """
    from .errors import BackendOptionsError, UnknownBackendError

    if backend not in ("torch", "cuda"):
        raise UnknownBackendError(
            f"unknown backend {backend!r} (choose 'torch' or 'cuda')",
            detail={"backend": backend})
    allowed = ("device",) if backend == "torch" else _CUDA_OPTS
    extra = sorted(set(backend_opts) - set(allowed))
    if extra:
        raise BackendOptionsError(
            f"backend={backend!r} does not take {extra} (takes {list(allowed)})",
            detail={"backend": backend, "options": extra})


def make_cuda_executor(
    prog: Program,
    batch: int | None = None,
    *,
    cycles_per_block: int = 128,
    placement: str = "auto",
    smem_limit_bytes: int | None = None,
    x_block_rows: int | None = None,
    device=None,
):
    """Build (or fetch from cache) a Hopper-kernel solve closure for `prog`.

    Same calling convention as `make_torch_executor` (``batch=None`` ->
    ``solve(b[n]) -> x[n]``; ``batch=B`` -> ``solve(b[n, B]) -> x[n, B]``)
    but executing `repro_torch.kernels.sptrsv` — on CUDA tensors the
    hand-written kernels, on ``device="cpu"`` their plain versions.

    ``placement`` selects the kernels' memory regime: ``"resident"``,
    ``"blocked"`` (the shared-memory row window, large n), or ``"auto"``
    (see `repro_torch.kernels.sptrsv.ops.resolve_placement`).  Executors
    are cached per (program identity, padded batch width, all placement
    knobs, device) — the window plan and the staged instruction tensors
    are made once per cache entry.
    """
    global _TRACE_COUNT
    from repro_torch.kernels.common import resolve_device
    from repro_torch.kernels.sptrsv import ops as sptrsv_ops  # ops imports us

    dev = resolve_device(device)
    if smem_limit_bytes is None:
        smem_limit_bytes = sptrsv_ops.DEFAULT_SMEM_BYTES
    width = pad_batch(batch if batch is not None else 1)
    key = ("cuda", width, cycles_per_block, placement, smem_limit_bytes,
           x_block_rows, str(dev))
    per_prog = _EXEC_CACHE.setdefault(prog, {})
    core = per_prog.get(key)
    if core is None:
        try:
            core = sptrsv_ops.build_solver_cols(
                prog, width, cycles_per_block=cycles_per_block,
                placement=placement, smem_limit_bytes=smem_limit_bytes,
                x_block_rows=x_block_rows, device=dev,
            )
        except Exception as e:
            # surface staging failures as the taxonomy so a caller can
            # classify them; taxonomy leaves (e.g. an infeasible placement)
            # pass through untouched
            from .errors import BackendExecutionError, RobustnessError

            if isinstance(e, RobustnessError):
                raise
            raise BackendExecutionError(
                f"cuda solver construction failed "
                f"({type(e).__name__}: {e})",
                detail={"placement": placement, "width": width}) from e
        _TRACE_COUNT += 1
        per_prog[key] = core
    if batch is None:
        entry = _single_entry(core, prog.n, dev)
    else:
        entry = batched_entry(core, prog.n, batch, width, dev)
    entry.placement = core.placement
    entry.plan = core.plan
    entry.x_in_smem = core.x_in_smem
    return entry


def execute_torch(prog: Program, b, *, device=None) -> np.ndarray:
    """Solve via the cached torch executor; `b` is `[n]` or `[n, B]`."""
    bmat, single = as_batch(b)
    if single:
        return make_torch_executor(prog, device=device)(bmat[:, 0]).cpu().numpy()
    return make_torch_executor(prog, batch=bmat.shape[1],
                               device=device)(bmat).cpu().numpy()
