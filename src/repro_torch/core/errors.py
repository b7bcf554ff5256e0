"""Structured exception taxonomy for the hardened solve path (DESIGN.md §7).

Every detectable failure in the compile/serialize/execute stack maps to one
of three families so callers (the fallback ladder in `core/robust.py`, the
serving layer, operators reading incident records) can branch on *what went
wrong* instead of parsing message strings:

  * `ProgramCorruptionError`   — the compiled artifact itself is damaged:
    checksum mismatch on a serialized blob, packed instruction fields out
    of range, row-envelope metadata inconsistent with the instruction
    words, psum slot lifetime violations, dependency-order violations.
    A corrupted program must never be executed; re-fetch or recompile.
  * `NumericalHealthError`     — the program is fine but the *numbers*
    are not: NaN/Inf in the right-hand side, non-finite solution values,
    a relative residual above tolerance.  Retrying the same backend is
    pointless; degrading to a reference executor (or re-validating the
    inputs) is the correct response.
  * `BackendExecutionError`    — an execution engine failed or was asked
    for an impossible configuration: unknown backend name, stray options,
    an infeasible kernel placement, or a crash inside the backend.  The
    next rung of the ladder may well succeed.

Several leaves multiply inherit the historical builtin (``ValueError`` /
``TypeError``) they replace, so pre-taxonomy callers and tests that catch
the builtin keep working while new code catches the taxonomy — and unlike
the bare ``assert`` validation they replace, these survive ``python -O``.
"""

from __future__ import annotations

__all__ = [
    "RobustnessError",
    "ProgramCorruptionError",
    "IRValidationError",
    "MatrixValidationError",
    "NumericalHealthError",
    "BackendExecutionError",
    "UnknownBackendError",
    "BackendOptionsError",
    "PlacementInfeasibleError",
    "ServingError",
    "DeadlineExceededError",
    "LoadShedError",
]


class RobustnessError(Exception):
    """Base of the hardened-solve-path taxonomy (DESIGN.md §7).

    ``detail`` is an optional machine-readable payload (plain dict) that
    incident records (`robust.Incident`) carry verbatim.
    """

    def __init__(self, message: str, *, detail: dict | None = None):
        super().__init__(message)
        self.detail = dict(detail) if detail else {}


class ProgramCorruptionError(RobustnessError, ValueError):
    """A compiled `Program` (or its serialized form) failed integrity checks."""


class IRValidationError(ProgramCorruptionError):
    """An intermediate IR broke a pass contract (`compile_dag(verify_ir=True)`).

    Raised between compiler passes by the static analyzer
    (`core/analysis/contracts.py`); the message and ``detail`` name the
    pipeline stage whose output violated its invariant plus the
    diagnostic codes found, so a miscompile is attributed to a pass
    instead of surfacing later as a generic corrupt-program failure.
    """


class MatrixValidationError(RobustnessError, ValueError):
    """A sparse-matrix container violates its layout contract.

    Raised by `TriCSR.validate` / `UpperCSR.validate` / `from_coo` with the
    offending matrix name and row in the message (and in ``detail``), in
    place of the historical bare ``assert``s that vanished under
    ``python -O``.
    """


class NumericalHealthError(RobustnessError, ValueError):
    """Inputs or outputs of a solve are numerically unhealthy.

    Covers NaN/Inf right-hand sides, wrong input shape/dtype, non-finite
    solution components, and relative residuals above tolerance.
    """


class BackendExecutionError(RobustnessError, RuntimeError):
    """An execution backend failed, or was configured impossibly."""


class UnknownBackendError(BackendExecutionError, ValueError):
    """Backend name outside the supported set (``"jax"``/``"pallas"``/...)."""


class BackendOptionsError(BackendExecutionError, TypeError):
    """Options passed to a backend that does not accept them."""


class PlacementInfeasibleError(BackendExecutionError, ValueError):
    """The requested Pallas memory placement admits no valid window plan."""


class ServingError(RobustnessError):
    """Service-level failure of the resilient serving layer (DESIGN.md §10).

    The solve stack below is healthy or degraded as its own taxonomy
    describes; this family covers the *service* refusing or abandoning a
    request — by policy, never silently.  ``detail`` carries the
    machine-readable request context (matrix id, deadline, budgets).
    """


class DeadlineExceededError(ServingError):
    """A request's deadline passed before its solve could complete.

    Raised from `serve.SolveTicket.result` when the serving layer failed
    the ticket fast (already expired at submit, or expired while pending)
    instead of consuming a solve on an answer nobody is waiting for.
    ``detail`` carries ``deadline`` / ``now`` on the service clock.
    """


class LoadShedError(ServingError):
    """A request was shed by admission control (bounded pending budgets).

    Raised from `serve.ShedTicket.result`: the per-matrix or global
    pending-column budget was full, so the service refused the request
    instead of growing its queues unboundedly.  ``detail`` names the
    exhausted budget and its limit.
    """
