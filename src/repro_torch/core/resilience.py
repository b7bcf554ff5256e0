"""Resilience primitives for the serving layer (DESIGN.md §10).

A copy of the JAX package's ``core/resilience.py`` (pure python; it needs
only `analysis.diagnostics` and `robust.Incident`).  The solve service
(DESIGN.md §9) turns a fleet of compiled programs into a request stream;
this module supplies the control-plane machinery that keeps that stream
healthy under faults and overload, all of it deterministic and
wall-clock-free so every policy is unit-testable on a `serve.ManualClock`:

  * `IncidentLog` — ONE bounded, indexable log of `robust.Incident`
    records shared by every serving-layer producer (the program cache's
    disk-tier corruption events, retry/backoff, breaker transitions,
    deadline failures, load sheds).  Saturation drops the oldest records
    and counts them (``dropped``) instead of growing without bound; the
    service report surfaces saturation as an SPT309 diagnostic.
  * `RetryPolicy` — exponential backoff with *deterministic* jitter: the
    delay for (key, attempt) is a pure function of the policy seed, so a
    replayed fault schedule yields a bit-identical backoff schedule.  No
    randomness source is consulted at solve time and the core never
    sleeps itself — the computed delay goes to an injectable sleeper.
  * `CircuitBreaker` / `BreakerBoard` — a closed → open → half-open
    state machine per (matrix, backend-rung) key over a sliding
    failure-rate window.  Pure state + an explicit ``now`` argument on
    every operation: the breaker holds no clock.  Every transition is
    recorded as a `robust.Incident` (kind ``breaker-*``) in the shared
    log.
  * `AdmissionConfig` / `ResilienceConfig` — the aggregate knob surface
    `serve.SolveService` consumes: per-matrix and global pending-column
    budgets (admission control / load shedding), the retry policy, the
    breaker config, and the per-stage flush timeout that classifies a
    hung backend.
  * `incident_to_diagnostic` — renders any serving-layer incident as an
    `analysis.Diagnostic` under the stable SPT3xx code block, so
    `SolveService.report()` speaks the same machine-readable JSON as the
    static analyzer (DESIGN.md §8).
"""

from __future__ import annotations

import dataclasses
import hashlib
from collections import deque

from .analysis.diagnostics import SEV_ERROR, SEV_INFO, SEV_WARN, Diagnostic
from .robust import Incident

__all__ = [
    "BREAKER_CLOSED",
    "BREAKER_OPEN",
    "BREAKER_HALF_OPEN",
    "AdmissionConfig",
    "BreakerBoard",
    "BreakerConfig",
    "CircuitBreaker",
    "IncidentLog",
    "ResilienceConfig",
    "RetryPolicy",
    "incident_to_diagnostic",
]


# ---------------------------------------------------------------------------
# incident log
# ---------------------------------------------------------------------------
class IncidentLog:
    """Bounded append-only log of `robust.Incident` records.

    List-like for the read paths the serving tests already use
    (``log[-1]``, ``len(log)``, iteration, slicing) but capped: past
    ``cap`` records the oldest are dropped and counted in ``dropped``
    rather than growing the log without bound — an incident *storm*
    (flapping breaker, corrupt disk tier) must not turn into a memory
    leak on a long-lived service.  The service report renders a non-zero
    ``dropped`` as an SPT309 diagnostic so saturation itself is visible.
    """

    def __init__(self, cap: int = 1024):
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self.dropped = 0
        self._items: list[Incident] = []

    def set_cap(self, cap: int) -> None:
        if cap < 1:
            raise ValueError(f"cap must be >= 1, got {cap}")
        self.cap = int(cap)
        self._trim()

    def _trim(self) -> None:
        excess = len(self._items) - self.cap
        if excess > 0:
            del self._items[:excess]
            self.dropped += excess

    def append(self, inc: Incident) -> Incident:
        self._items.append(inc)
        self._trim()
        return inc

    def extend(self, incs) -> None:
        for inc in incs:
            self.append(inc)

    def __len__(self) -> int:
        return len(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __iter__(self):
        return iter(self._items)

    def by_kind(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for inc in self._items:
            out[inc.kind] = out.get(inc.kind, 0) + 1
        return out

    def to_list(self) -> list[dict]:
        return [inc.to_dict() for inc in self._items]


# ---------------------------------------------------------------------------
# retry / backoff
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with deterministic, seeded jitter.

    ``delay(attempt, key)`` is a pure function: exponential growth from
    ``base_delay_s`` capped at ``max_delay_s``, then shrunk by up to
    ``jitter`` (a fraction in [0, 1]) using a uniform deviate derived by
    hashing ``(seed, key, attempt)`` — no RNG state, no wall clock, so a
    fixed seed replays the exact backoff schedule and two keys (say two
    matrices retrying the same rung) desynchronize instead of
    thundering-herding.  ``max_retries`` counts *extra* attempts after
    the first failure of one ladder rung.
    """

    max_retries: int = 1
    base_delay_s: float = 0.01
    max_delay_s: float = 1.0
    multiplier: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError(f"jitter must be in [0, 1], got {self.jitter}")
        if self.base_delay_s < 0 or self.max_delay_s < 0:
            raise ValueError("delays must be >= 0")
        if self.multiplier < 1.0:
            raise ValueError(f"multiplier must be >= 1, got {self.multiplier}")

    def delay(self, attempt: int, key: str = "") -> float:
        """Backoff before retry number ``attempt`` (1-based) of ``key``."""
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        raw = min(self.base_delay_s * self.multiplier ** (attempt - 1),
                  self.max_delay_s)
        if not self.jitter or raw == 0.0:
            return raw
        h = hashlib.sha256(
            f"retry:{self.seed}:{key}:{attempt}".encode()).digest()
        u = int.from_bytes(h[:8], "little") / 2.0 ** 64  # uniform [0, 1)
        return raw * (1.0 - self.jitter * u)


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------
BREAKER_CLOSED = "closed"        # normal operation, outcomes windowed
BREAKER_OPEN = "open"            # rung gated; cooldown running
BREAKER_HALF_OPEN = "half-open"  # probing: limited traffic allowed


@dataclasses.dataclass(frozen=True)
class BreakerConfig:
    """Knobs of one `CircuitBreaker` (shared across a `BreakerBoard`)."""

    window_s: float = 30.0          # sliding outcome window
    min_samples: int = 4            # outcomes needed before judging
    failure_threshold: float = 0.5  # open at >= this failure fraction
    cooldown_s: float = 10.0        # open -> half-open probe delay
    half_open_probes: int = 1       # consecutive successes to close

    def __post_init__(self):
        if self.window_s <= 0 or self.cooldown_s < 0:
            raise ValueError("window_s must be > 0 and cooldown_s >= 0")
        if self.min_samples < 1 or self.half_open_probes < 1:
            raise ValueError("min_samples and half_open_probes must be >= 1")
        if not 0.0 < self.failure_threshold <= 1.0:
            raise ValueError(
                f"failure_threshold must be in (0, 1], got "
                f"{self.failure_threshold}")


class CircuitBreaker:
    """closed → open → half-open breaker over a sliding failure window.

    Pure state machine: every operation takes an explicit ``now`` (the
    caller's injectable clock) and the breaker never reads time itself.
    While CLOSED, outcomes within ``window_s`` are counted; once at
    least ``min_samples`` are present and the failure fraction reaches
    ``failure_threshold`` the breaker OPENs.  ``allow(now)`` gates
    traffic: False while OPEN until ``cooldown_s`` elapses, then the
    breaker turns HALF_OPEN and admits probes — ``half_open_probes``
    consecutive successes close it (window cleared), any failure
    re-opens it and re-arms the cooldown.  ``on_transition`` (set by the
    `BreakerBoard`) observes every state change.
    """

    def __init__(self, key, cfg: BreakerConfig, on_transition=None):
        self.key = key
        self.cfg = cfg
        self.state = BREAKER_CLOSED
        self.opened_at: float | None = None
        self.transitions = 0
        self._events: deque = deque()   # (now, ok) within window_s
        self._probe_successes = 0
        self._on_transition = on_transition

    def _trim(self, now: float) -> None:
        horizon = now - self.cfg.window_s
        while self._events and self._events[0][0] <= horizon:
            self._events.popleft()

    def _move(self, new: str, now: float, reason: str) -> None:
        old, self.state = self.state, new
        self.transitions += 1
        if new == BREAKER_OPEN:
            self.opened_at = now
            self._probe_successes = 0
        elif new == BREAKER_CLOSED:
            self.opened_at = None
            self._events.clear()
            self._probe_successes = 0
        if self._on_transition is not None:
            self._on_transition(self, old, new, now, reason)

    # ------------------------------------------------------------------
    def allow(self, now: float) -> bool:
        """May the protected rung take traffic at ``now``?"""
        if self.state == BREAKER_OPEN:
            if now >= self.opened_at + self.cfg.cooldown_s:
                self._move(BREAKER_HALF_OPEN, now, "cooldown elapsed")
                return True
            return False
        return True

    def record(self, now: float, ok: bool) -> None:
        """Report one outcome of the protected rung."""
        if self.state == BREAKER_HALF_OPEN:
            if not ok:
                self._move(BREAKER_OPEN, now, "probe failed")
                return
            self._probe_successes += 1
            if self._probe_successes >= self.cfg.half_open_probes:
                self._move(BREAKER_CLOSED, now,
                           f"{self._probe_successes} probe(s) succeeded")
            return
        if self.state == BREAKER_OPEN:
            return  # outcome of a call admitted before opening: stale
        self._events.append((now, ok))
        self._trim(now)
        n = len(self._events)
        fails = sum(1 for _, k in self._events if not k)
        if n >= self.cfg.min_samples and \
                fails / n >= self.cfg.failure_threshold:
            self._move(BREAKER_OPEN, now,
                       f"failure rate {fails}/{n} in window")

    def record_success(self, now: float) -> None:
        self.record(now, True)

    def record_failure(self, now: float) -> None:
        self.record(now, False)


class BreakerBoard:
    """Lazily-created `CircuitBreaker` per key, one shared config.

    Keys are ``(matrix_id, ladder_rung)`` in the serving layer.  Every
    transition of every breaker is appended to ``sink`` (an
    `IncidentLog`) as a `robust.Incident` with kind ``breaker-open`` /
    ``breaker-half-open`` / ``breaker-closed`` — the report layer maps
    them to SPT304.
    """

    def __init__(self, cfg: BreakerConfig | None = None, sink=None):
        self.cfg = cfg or BreakerConfig()
        self.sink = sink
        self._breakers: dict = {}

    def _on_transition(self, brk: CircuitBreaker, old: str, new: str,
                       now: float, reason: str) -> None:
        if self.sink is None:
            return
        mid, stage = (brk.key if isinstance(brk.key, tuple) and
                      len(brk.key) == 2 else ("", str(brk.key)))
        self.sink.append(Incident(
            stage=str(stage), kind=f"breaker-{new}",
            message=f"breaker {brk.key} {old} -> {new}: {reason}",
            detail={"matrix_id": str(mid), "from": old, "to": new,
                    "at": float(now), "reason": reason}))

    def breaker(self, key) -> CircuitBreaker:
        brk = self._breakers.get(key)
        if brk is None:
            brk = CircuitBreaker(key, self.cfg,
                                 on_transition=self._on_transition)
            self._breakers[key] = brk
        return brk

    def allow(self, key, now: float) -> bool:
        return self.breaker(key).allow(now)

    def record(self, key, now: float, ok: bool) -> None:
        self.breaker(key).record(now, ok)

    def state(self, key) -> str:
        brk = self._breakers.get(key)
        return BREAKER_CLOSED if brk is None else brk.state

    def states(self) -> dict[str, str]:
        return {"/".join(map(str, k)) if isinstance(k, tuple) else str(k):
                b.state for k, b in self._breakers.items()}


# ---------------------------------------------------------------------------
# admission / aggregate config
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Pending-column budgets for load shedding (``None`` = unbounded).

    Budgets are checked at ``submit`` time *after* due deadline flushes
    ran (so a due bucket frees its budget before the new arrival is
    judged); a request whose columns would exceed either budget is shed
    whole — a typed `serve.ShedTicket`, never a partial enqueue.
    """

    max_pending_per_matrix: int | None = None
    max_pending_total: int | None = None

    def __post_init__(self):
        for name in ("max_pending_per_matrix", "max_pending_total"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1 or None, got {v}")


class ResilienceConfig:
    """Aggregate resilience surface consumed by `serve.SolveService`.

    ``flush_timeout_s`` bounds one backend attempt (measured on the
    service's injectable clock); an attempt exceeding it is classified a
    hang (SPT308), fails the rung's breaker, and degrades — the stage is
    never retried within the flush.  ``sleep`` is the injected backoff
    sleeper (``seconds -> None``); the default ``None`` makes backoff a
    pure accounting event, which is exactly right for virtual-clock
    serving — production may pass ``time.sleep``.  ``incident_cap``
    re-caps the shared `IncidentLog`.
    """

    def __init__(self, retry: RetryPolicy | None = None,
                 breaker: BreakerConfig | None = None,
                 admission: AdmissionConfig | None = None,
                 flush_timeout_s: float | None = None,
                 sleep=None, incident_cap: int = 1024):
        self.retry = retry or RetryPolicy()
        self.breaker = breaker or BreakerConfig()
        self.admission = admission or AdmissionConfig()
        self.flush_timeout_s = flush_timeout_s
        self.sleep = sleep
        if incident_cap < 1:
            raise ValueError(f"incident_cap must be >= 1, got {incident_cap}")
        self.incident_cap = int(incident_cap)


# ---------------------------------------------------------------------------
# incident -> diagnostic (the SPT3xx block)
# ---------------------------------------------------------------------------
# incident kind -> (code, severity).  Kinds not listed render as SPT301
# at warn severity — an unknown failure is still a backend failure.
_KIND_TO_CODE: dict[str, tuple[str, str]] = {
    "exception": ("SPT301", SEV_WARN),
    "build-failed": ("SPT301", SEV_WARN),
    "ladder-exhausted": ("SPT301", SEV_ERROR),
    "nonfinite-output": ("SPT302", SEV_WARN),
    "residual": ("SPT302", SEV_WARN),
    "deadline": ("SPT303", SEV_WARN),
    "deadline-expired": ("SPT303", SEV_WARN),
    "breaker-open": ("SPT304", SEV_WARN),
    "breaker-half-open": ("SPT304", SEV_INFO),
    "breaker-closed": ("SPT304", SEV_INFO),
    "shed": ("SPT305", SEV_WARN),
    "disk-corrupt": ("SPT306", SEV_WARN),
    "backoff": ("SPT307", SEV_INFO),
    "hang": ("SPT308", SEV_WARN),
    "log-saturated": ("SPT309", SEV_WARN),
}


def incident_to_diagnostic(inc: Incident) -> Diagnostic:
    """Render a serving-layer `robust.Incident` as an SPT3xx `Diagnostic`.

    The incident's free-form fields ride along in ``detail`` (stage,
    error class, attempt, elapsed seconds, plus whatever the producer
    attached), so the JSON report loses nothing relative to
    ``Incident.to_dict`` while gaining the stable code + severity the
    analysis tooling keys on.
    """
    code, severity = _KIND_TO_CODE.get(inc.kind, ("SPT301", SEV_WARN))
    detail = {"kind": inc.kind, "stage": inc.stage, "error": inc.error,
              "attempt": inc.attempt, "elapsed_s": inc.elapsed_s,
              **inc.detail}
    return Diagnostic(code=code, severity=severity, message=inc.message,
                      pass_name="serve", detail=detail)
