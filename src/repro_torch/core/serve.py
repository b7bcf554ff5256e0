"""Production solve service: continuous RHS micro-batching over a
multi-tenant program cache (DESIGN.md §9).

Ports the JAX package's ``core/serve.py``: the same scheduling core, cache
tiers, fingerprints and disk file names (a disk tier written by either
package rehydrates in the other), over the port's backends — ``"numpy"``,
``"torch"`` and ``"cuda"`` (the Hopper kernels), with the resilient ladder
cuda-blocked → cuda-resident → torch → numpy → reference.  The device of
the torch and cuda backends is resolved once, at construction, and every
flush's answer crosses to the host through `robust.host_array`.

The accelerator's economics are compile-once/solve-many: a `Program` is
the expensive artifact, and production traffic (factorization loops,
preconditioner sweeps) is a *stream* of ``(matrix_id, b)`` requests
against a fleet of precompiled programs.  This module turns the batched
executors and kernels (DESIGN.md §4) into a service facing that stream:

  * `SolveService` — accepts single- or multi-column right-hand sides per
    registered matrix and micro-batches the columns per matrix into the
    padded widths the cached batched executors already key on
    (`executor.pad_batch` — the one bucketing function, shared with the
    executor cache so the two can never diverge).  A bucket flushes when
    it reaches ``max_batch`` columns or when its deadline — arrival of
    its oldest pending column plus ``max_delay`` — expires.  **Every
    scheduling decision runs on an injectable clock**: the core never
    reads wall time, so deadline-vs-full flush ordering, out-of-order
    completion and result routing are all unit-testable without sleeps
    (`tests/test_torch_serve.py`).  Production callers get a real clock
    from `api.make_service`.
  * `ProgramCache` — a bounded LRU of compiled `Program`s keyed by
    `pattern_fingerprint` (a structure-only hash over the CSR pattern:
    two tenants registering the same sparsity pattern share one compile).
    A write-through disk tier (`serialize.save_program`) lets an evicted
    entry rehydrate through the CRC-verified `serialize.load_program`
    instead of re-running the compiler; a corrupted blob degrades to a
    recompile with a machine-readable `robust.Incident`, never a crash.
    Because the compiled value plane depends on the numeric values too,
    each entry carries a CRC of the source values — a same-pattern /
    different-values matrix is a miss (its own disk blob), never a
    silently wrong schedule reuse.
  * `ServeStats` — per-entry hit/miss/compile-time counters plus flush
    accounting (full vs deadline vs drain, batched column counts and a
    `FlushRecord` log) so load generators and dashboards read one record.

Request lifecycle: ``submit`` first pumps any bucket whose deadline is
already due (deadline flushes happen-before the new arrival), enqueues
the request's columns, then flushes full ``max_batch`` chunks
immediately.  ``pump(now)`` flushes due buckets in deterministic
(deadline, arrival-order) order; ``drain()`` flushes everything.  A
`SolveTicket` completes when its last column's bucket flushes — tickets
of a hot matrix can complete before earlier-submitted tickets of a cold
one, and each column routes back to exactly the ticket that submitted
it.  Batched columns are bit-identical to per-request solves (no
cross-column arithmetic exists in any executor), which the property
tests (`tests/test_torch_serve.py`) pin down.

Resilient serving (DESIGN.md §10, ``resilience=`` on the service): each
request may carry a deadline — a bucket flushes *early* when waiting the
full ``max_delay`` would miss its tightest deadline, and an
already-expired ticket fails fast with a typed
`errors.DeadlineExceededError` instead of consuming solve width.  Each
flush solves through the backend ladder (`robust.LADDER` from the
service's entry rung down to the CSR "reference" solve) with bounded
retry + deterministic-jitter backoff (`resilience.RetryPolicy`) per
rung, a per-(matrix, rung) circuit breaker (`resilience.BreakerBoard`)
gating rungs that keep failing, a per-attempt hang bound
(``flush_timeout_s``), and a non-finite output check — a flush either
delivers healthy numbers or fails its tickets with a typed error carrying
the incident trail, never silently wrong answers.  Admission control
(`resilience.AdmissionConfig`) bounds pending columns per matrix and
globally; an over-budget ``submit`` returns a typed `ShedTicket`.  Every
degradation event lands in ONE bounded `resilience.IncidentLog` shared
with the program cache's disk tier, rendered by ``report()`` through the
stable SPT3xx diagnostic codes.  All of it runs on the injectable clock —
the chaos harness (`robust.run_service_fault_injection`) replays fault
schedules deterministically.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import zlib
from collections import OrderedDict

import numpy as np

from repro_torch.spans import span, spanned

from .csr import TriCSR, serial_solve
from .errors import (
    BackendExecutionError,
    DeadlineExceededError,
    LoadShedError,
    ProgramCorruptionError,
)
from .executor import execute_numpy, pad_batch, validate_backend
from .program import AccelConfig, Program
from .resilience import BreakerBoard, IncidentLog, ResilienceConfig
from .robust import LADDER, _ENTRY, Incident, host_array
from .schedule import compile_program, recompile_values

__all__ = [
    "FLUSH_DEADLINE",
    "FLUSH_DRAIN",
    "FLUSH_FULL",
    "FLUSH_SHED",
    "CacheEntryStats",
    "FlushRecord",
    "ManualClock",
    "ProgramCache",
    "ServeStats",
    "ShedTicket",
    "SolveService",
    "SolveTicket",
    "pattern_fingerprint",
]

FLUSH_FULL = "full"          # bucket reached max_batch columns
FLUSH_DEADLINE = "deadline"  # oldest pending column aged past max_delay,
                             # or a request deadline forced an early flush
FLUSH_DRAIN = "drain"        # explicit drain() regardless of deadline
FLUSH_SHED = "shed"          # admission control rejected a submit (the
                             # record consumes no flush index: index=-1)

_FP_TAG = b"sptrsv-pattern-v1"


def pattern_fingerprint(mat: TriCSR, schedule: str = "paper") -> str:
    """Structure-only fingerprint of a CSR sparsity pattern (hex, 16 chars).

    Hashes ``(n, rowptr, colidx)`` and nothing else — numeric values do
    not participate, so a factorization loop re-solving one pattern with
    fresh values maps to one fingerprint (the cache guards value changes
    separately with a values CRC).  Two same-shape matrices with
    different patterns fingerprint differently.

    ``schedule`` is the scheduler-strategy the program is compiled with
    (DESIGN.md §11): a non-default strategy participates in the hash, so
    one pattern compiled under two strategies occupies two cache entries
    — no silent reuse of the wrong schedule.  The default ``"paper"``
    hashes exactly as before, keeping pre-frontier disk tiers valid.
    """
    h = hashlib.sha256(_FP_TAG)
    h.update(int(mat.n).to_bytes(8, "little"))
    h.update(np.ascontiguousarray(mat.rowptr, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(mat.colidx, dtype=np.int64).tobytes())
    if schedule != "paper":
        h.update(b"|schedule=" + schedule.encode())
    return h.hexdigest()[:16]


def _values_crc(mat: TriCSR) -> int:
    return zlib.crc32(np.ascontiguousarray(mat.values,
                                           dtype=np.float64).tobytes())


@dataclasses.dataclass
class CacheEntryStats:
    """Per-fingerprint counters of one `ProgramCache` entry."""

    fingerprint: str
    name: str = ""
    hits: int = 0            # served from the in-memory LRU
    disk_hits: int = 0       # rehydrated from the disk tier (no compile)
    compiles: int = 0        # compiler runs (cold miss or corrupt blob)
    value_refreshes: int = 0  # same-pattern/new-values misses served by
                              # `recompile_values` (schedule reused)
    disk_corrupt: int = 0    # disk blobs rejected by CRC/structural verify
    compile_seconds: float = 0.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class ProgramCache:
    """Bounded LRU of compiled `Program`s with a CRC-verified disk tier.

    ``capacity`` bounds the in-memory tier (LRU eviction).  ``disk_dir``
    (optional) enables the disk tier: every compile is written through
    (`serialize.save_program`), so an evicted entry rehydrates via the
    checksummed `serialize.load_program` instead of re-running the
    compiler.  A corrupt blob is removed, recorded as a
    `robust.Incident` (``kind="disk-corrupt"``) in ``incidents``, and
    the entry recompiles — corruption can degrade performance, never
    correctness.  ``get`` is keyed by `pattern_fingerprint`; a values
    CRC rides along so same-pattern/different-values matrices never
    share a program (they do share a fingerprint and get distinct disk
    blobs).
    """

    def __init__(self, capacity: int = 32, disk_dir=None,
                 cfg: AccelConfig | None = None, compile_fn=None,
                 schedule: str = "paper", incident_cap: int = 1024):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.disk_dir = os.fspath(disk_dir) if disk_dir is not None else None
        self._cfg = cfg
        # the strategy keys the fingerprint (same pattern under two
        # strategies -> two entries) and parameterizes the default compile
        self.schedule = schedule
        self._compile = compile_fn or (
            lambda m: compile_program(m, cfg, schedule=schedule))
        self._mem: "OrderedDict[str, tuple[Program, int]]" = OrderedDict()
        self.entries: dict[str, CacheEntryStats] = {}
        # ONE bounded incident log for the whole serving layer: the
        # service that wraps this cache shares the same object, so disk
        # corruption, retries, breaker flips and sheds interleave in one
        # capped record instead of fragmenting across components.
        self.incidents = IncidentLog(incident_cap)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.value_refreshes = 0

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._mem)

    def fingerprints(self) -> list[str]:
        """In-memory fingerprints, least- to most-recently used."""
        return list(self._mem)

    def _path(self, fp: str, vcrc: int) -> str | None:
        if self.disk_dir is None:
            return None
        return os.path.join(self.disk_dir, f"{fp}.{vcrc:08x}.prog")

    def _entry(self, fp: str, name: str) -> CacheEntryStats:
        ent = self.entries.get(fp)
        if ent is None:
            ent = CacheEntryStats(fingerprint=fp, name=name)
            self.entries[fp] = ent
        return ent

    # ------------------------------------------------------------------
    @spanned("serve.cache_get")
    def get(self, mat: TriCSR) -> Program:
        """The compiled program for ``mat``'s pattern+values, through the
        tiers: memory LRU -> disk rehydrate -> compile (write-through)."""
        with span("serve.fingerprint"):
            fp = pattern_fingerprint(mat, self.schedule)
        with span("serve.values_crc"):
            vcrc = _values_crc(mat)
        ent = self._entry(fp, mat.name)
        cached = self._mem.get(fp)
        stale: Program | None = None
        if cached is not None:
            prog, crc = cached
            if crc == vcrc:
                self._mem.move_to_end(fp)
                ent.hits += 1
                self.hits += 1
                return prog
            # same pattern, new numeric values: a guarded miss, but the
            # schedule depends only on the pattern — when the program
            # carries its value-provenance plane the stream is regathered
            # through `recompile_values` instead of re-running the
            # pipeline (the factorization-loop fast path).
            stale = prog
            del self._mem[fp]
        self.misses += 1
        prog = self._refresh(stale, mat, fp, vcrc, ent)
        if prog is None:
            prog = self._rehydrate(fp, vcrc, ent)
        if prog is None:
            prog = self._compile(mat)
            ent.compiles += 1
            ent.compile_seconds += float(prog.stats.compile_seconds or 0.0)
            self._write_through(fp, vcrc, prog)
        self._insert(fp, vcrc, prog)
        return prog

    def _refresh(self, stale: Program | None, mat: TriCSR, fp: str,
                 vcrc: int, ent: CacheEntryStats) -> Program | None:
        """Values-only refresh of a same-pattern stale entry, when its
        provenance plane allows; the refreshed program gets its own disk
        blob (the disk tier is keyed by values CRC too)."""
        if stale is None or stale.stream_src is None:
            return None
        try:
            prog = recompile_values(stale, mat)
        except ValueError:
            return None  # defensive: fingerprint collision / stale plane
        ent.value_refreshes += 1
        self.value_refreshes += 1
        self._write_through(fp, vcrc, prog)
        return prog

    def _rehydrate(self, fp: str, vcrc: int,
                   ent: CacheEntryStats) -> Program | None:
        path = self._path(fp, vcrc)
        if path is None or not os.path.exists(path):
            return None
        from .serialize import load_program

        try:
            prog = load_program(path)  # CRC + structural verify
        except ProgramCorruptionError as e:
            ent.disk_corrupt += 1
            self.incidents.append(Incident(
                stage="program-cache", kind="disk-corrupt",
                message=f"disk entry for {fp} rejected, recompiling: {e}",
                error=type(e).__name__,
                detail={"fingerprint": fp, "path": path}))
            os.remove(path)
            return None
        ent.disk_hits += 1
        return prog

    def _write_through(self, fp: str, vcrc: int, prog: Program) -> None:
        path = self._path(fp, vcrc)
        if path is None:
            return
        from .serialize import save_program

        os.makedirs(self.disk_dir, exist_ok=True)
        save_program(prog, path)

    def _insert(self, fp: str, vcrc: int, prog: Program) -> None:
        self._mem[fp] = (prog, vcrc)
        self._mem.move_to_end(fp)
        while len(self._mem) > self.capacity:
            self._mem.popitem(last=False)
            self.evictions += 1

    def stats_dict(self) -> dict:
        return {
            "hits": self.hits, "misses": self.misses,
            "evictions": self.evictions, "resident": len(self._mem),
            "capacity": self.capacity,
            "value_refreshes": self.value_refreshes,
            "incidents": len(self.incidents),
            "incidents_dropped": self.incidents.dropped,
            "entries": {fp: e.to_dict() for fp, e in self.entries.items()},
        }


# ---------------------------------------------------------------------------
# service
# ---------------------------------------------------------------------------
class ManualClock:
    """Deterministic injectable clock: returns ``now`` until advanced."""

    def __init__(self, start: float = 0.0):
        self.now = float(start)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now


class SolveTicket:
    """Routing handle for one submitted request.

    Completes when the last of its columns has been solved (columns of a
    wide request can span several flushes).  ``result()`` returns ``[n]``
    for a 1-D submit and ``[n, k]`` for a 2-D one; calling it before the
    ticket is done raises (pump or drain the service first).

    A ticket can also complete by *failing*: an expired request deadline
    or an exhausted backend ladder marks the whole ticket failed
    (``failed``, with the typed `errors.RobustnessError` in ``error``)
    and ``result()`` re-raises it — a wide ticket fails whole, partial
    column sets are never returned.  ``deadline`` (optional, on the
    service clock) is the latest time delivery still counts.
    """

    shed = False  # `ShedTicket` overrides; uniform check for callers

    def __init__(self, matrix_id: str, n: int, k: int, single: bool,
                 submitted_at: float, deadline: float | None = None):
        self.matrix_id = matrix_id
        self.columns = k
        self.submitted_at = submitted_at
        self.deadline = deadline
        self.completed_at: float | None = None
        self.flush_indices: list[int] = []
        self._single = single
        self._x: np.ndarray | None = None
        self._n = n
        self._remaining = k
        self._error: Exception | None = None
        if k == 0:  # degenerate [n, 0] request: nothing to solve
            self._x = np.zeros((n, 0), dtype=np.float32)
            self.completed_at = submitted_at

    @property
    def done(self) -> bool:
        return self._remaining == 0

    @property
    def failed(self) -> bool:
        return self._error is not None

    @property
    def error(self) -> Exception | None:
        return self._error

    def _deliver(self, j: int, col: np.ndarray, flush_index: int,
                 at: float) -> None:
        if self._error is not None:
            return  # ticket already failed whole; drop the late column
        if self._x is None:
            self._x = np.empty((self._n, self.columns), dtype=col.dtype)
        self._x[:, j] = col
        self._remaining -= 1
        if flush_index not in self.flush_indices:
            self.flush_indices.append(flush_index)
        if self._remaining == 0:
            self.completed_at = at

    def _fail(self, exc: Exception, at: float) -> None:
        if self.done:
            return
        self._error = exc
        self._remaining = 0
        self.completed_at = at

    def result(self) -> np.ndarray:
        if not self.done:
            raise RuntimeError(
                f"ticket for {self.matrix_id!r} not complete "
                f"({self._remaining}/{self.columns} columns pending) — "
                f"pump() or drain() the service")
        if self._error is not None:
            raise self._error
        return self._x[:, 0] if self._single else self._x


class ShedTicket(SolveTicket):
    """Typed admission-control rejection; quacks like a completed ticket.

    Returned by ``submit`` when the request's columns would exceed a
    pending budget (`resilience.AdmissionConfig`).  ``done`` is True
    immediately, ``shed`` marks the rejection, and ``result()`` raises
    the `errors.LoadShedError` carrying the violated budget in
    ``.detail`` — callers retry later or route elsewhere.
    """

    shed = True

    def __init__(self, matrix_id: str, n: int, k: int, single: bool,
                 at: float, error: LoadShedError):
        super().__init__(matrix_id, n, k, single, at)
        self._error = error
        self._remaining = 0
        self.completed_at = at


@dataclasses.dataclass
class FlushRecord:
    """One executed micro-batch (the unit a load generator replays for
    its queueing model)."""

    index: int         # -1 for FLUSH_SHED records (no solver ran)
    matrix_id: str
    reason: str        # FLUSH_FULL | FLUSH_DEADLINE | FLUSH_DRAIN | FLUSH_SHED
    columns: int       # real RHS columns solved (or shed)
    padded: int        # executor batch width (pad_batch of columns)
    at: float          # injectable-clock time the flush ran
    service_s: float   # measured solve wall time (0.0 without a timer)
    stage: str = ""    # ladder rung that answered ("" on the legacy path
                       # and on failed/shed records)


@dataclasses.dataclass
class ServeStats:
    """Aggregate service counters + the per-entry cache counters."""

    requests: int = 0
    columns: int = 0
    completed_columns: int = 0
    solver_calls: int = 0
    batched_columns: int = 0   # columns solved in flushes of >1 column
    flushes_full: int = 0
    flushes_deadline: int = 0
    flushes_drain: int = 0
    # resilience accounting (DESIGN.md §10); all zero on the legacy path
    requests_shed: int = 0          # submits rejected by admission control
    columns_shed: int = 0
    deadline_failed_columns: int = 0  # columns failed fast, deadline expired
    retries: int = 0                # backend attempts retried with backoff
    degraded_flushes: int = 0       # flushes answered below the entry rung
    failed_flushes: int = 0         # flushes that exhausted the ladder
    flushes: list = dataclasses.field(default_factory=list)
    cache: dict = dataclasses.field(default_factory=dict)

    def flush_count(self) -> int:
        """Solver flushes (shed records carry index=-1 and do not count)."""
        return self.flushes_full + self.flushes_deadline + self.flushes_drain

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["flushes"] = [dataclasses.asdict(f) if dataclasses.is_dataclass(f)
                        else f for f in self.flushes]
        return d


class SolveService:
    """Continuous micro-batching front end over a `ProgramCache`.

    ``clock`` is any ``() -> float`` callable; the default is a
    `ManualClock` at 0.0 so the core is deterministic out of the box
    (production passes ``time.monotonic`` via `api.make_service`).
    ``timer`` (optional ``() -> float``) measures solve wall time for
    `FlushRecord.service_s` — left unset, records carry 0.0 and the core
    stays wall-clock-free.  ``backend`` is "numpy", "torch" or "cuda"
    (+ the `api.make_solver` knobs); bucketing uses `executor.pad_batch`,
    the same rounding the executor cache keys on, so a service never
    stages more than one executor per (program, padded width, backend
    knobs).  ``device`` is the device of the torch and cuda backends, CUDA
    when None, resolved here: a machine without CUDA raises at
    construction instead of degrading every flush.  ``mesh=`` (a
    `shard.BatchMesh`) splits every flush's columns over its devices,
    through `api.make_solver`; the mesh then names the devices (no
    ``device=``) and answers land on its first device.
    """

    def __init__(self, cache: ProgramCache | None = None, *,
                 max_batch: int = 16, max_delay: float = 1e-3,
                 clock=None, timer=None, backend: str = "torch", mesh=None,
                 resilience: ResilienceConfig | None = None, device=None,
                 **backend_opts):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {max_delay}")
        self.device = None
        if backend == "numpy":
            if mesh is not None or backend_opts:
                raise ValueError("backend='numpy' takes no mesh/extra options")
        else:
            from repro_torch.kernels.common import resolve_device

            validate_backend(backend, {} if backend == "torch"
                             else backend_opts)
            if mesh is not None:
                from .shard import mesh_device

                device = mesh_device(mesh, device)
            self.device = resolve_device(device)
        self.mesh = mesh
        self.cache = cache if cache is not None else ProgramCache()
        self.max_batch = int(max_batch)
        self.max_delay = float(max_delay)
        self.backend = backend
        self.backend_opts = backend_opts
        self._clock = clock if clock is not None else ManualClock()
        self._timer = timer
        self._mats: dict[str, TriCSR] = {}
        # matrix_id -> list of (seq, arrival, ticket, column_index, column)
        self._pending: dict[str, list] = {}
        self._seq = 0
        self.stats = ServeStats()
        # one shared, bounded incident log for cache + service events
        self.incidents = self.cache.incidents
        self.resilience = resilience
        self._breakers: BreakerBoard | None = None
        if resilience is not None:
            self.incidents.set_cap(resilience.incident_cap)
            self._breakers = BreakerBoard(resilience.breaker,
                                          sink=self.incidents)
            # degradation order from the service's entry rung down to the
            # CSR reference solve (always available: tenants are retained)
            self._ladder = LADDER[_ENTRY[backend]:]

    # ------------------------------------------------------------------
    def register(self, matrix_id: str, mat: TriCSR) -> str:
        """Register a tenant matrix; returns its pattern fingerprint.

        Registration only records the matrix — compilation happens on
        the first flush, through the cache tiers (so two ids sharing one
        pattern+values compile once)."""
        if matrix_id in self._mats:
            raise ValueError(f"matrix_id {matrix_id!r} already registered")
        self._mats[matrix_id] = mat
        return pattern_fingerprint(mat, getattr(self.cache, "schedule",
                                                "paper"))

    def matrix_ids(self) -> list[str]:
        return list(self._mats)

    def pending_columns(self, matrix_id: str | None = None) -> int:
        if matrix_id is not None:
            return len(self._pending.get(matrix_id, ()))
        return sum(len(v) for v in self._pending.values())

    # ------------------------------------------------------------------
    def submit(self, matrix_id: str, b: np.ndarray, *,
               now: float | None = None, deadline: float | None = None,
               timeout: float | None = None) -> SolveTicket:
        """Enqueue a right-hand side; returns its `SolveTicket`.

        ``deadline`` (absolute, on the service clock) or ``timeout``
        (relative to now; at most one of the two) bounds the request:
        its bucket flushes early rather than miss it, and an
        already-expired request fails fast with a typed
        `errors.DeadlineExceededError` instead of consuming a solve.
        Under admission control (``resilience=``), a request whose
        columns would exceed a pending budget returns a `ShedTicket`
        without enqueueing anything.

        Order of effects: (1) pump every bucket that is already due —
        those flushes happen-before the new arrival (and free budget);
        (2) fail-fast / admission checks; (3) enqueue the request's
        columns; (4) flush full ``max_batch`` chunks of this bucket
        immediately (a wide request can trigger several)."""
        mat = self._mats.get(matrix_id)
        if mat is None:
            raise KeyError(f"unknown matrix_id {matrix_id!r} "
                           f"(registered: {sorted(self._mats)})")
        b = np.asarray(b)
        single = b.ndim == 1
        bmat = b[:, None] if single else b
        if bmat.ndim != 2 or bmat.shape[0] != mat.n:
            raise ValueError(
                f"expected b of shape ({mat.n},) or ({mat.n}, k) for "
                f"{matrix_id!r}, got {b.shape}")
        t = self._clock() if now is None else float(now)
        if deadline is not None and timeout is not None:
            raise ValueError("pass deadline= or timeout=, not both")
        if timeout is not None:
            deadline = t + float(timeout)
        self.pump(now=t)
        k = bmat.shape[1]
        self.stats.requests += 1
        self.stats.columns += k
        if k == 0:
            return SolveTicket(matrix_id, mat.n, 0, single, t, deadline)
        if deadline is not None and deadline < t:
            # already expired: fail fast, consume nothing
            ticket = SolveTicket(matrix_id, mat.n, k, single, t, deadline)
            err = DeadlineExceededError(
                f"request for {matrix_id!r} expired before submit "
                f"(deadline {deadline:.6f} < now {t:.6f})",
                detail={"matrix_id": matrix_id, "deadline": float(deadline),
                        "now": t, "columns": k})
            ticket._fail(err, t)
            self.stats.deadline_failed_columns += k
            self.incidents.append(Incident(
                stage="serve", kind="deadline-expired", message=str(err),
                error=type(err).__name__, detail=dict(err.detail)))
            return ticket
        shed = self._admit(matrix_id, k, single, mat.n, t)
        if shed is not None:
            return shed
        ticket = SolveTicket(matrix_id, mat.n, k, single, t, deadline)
        bucket = self._pending.setdefault(matrix_id, [])
        for j in range(k):
            bucket.append((self._seq, t, ticket, j, bmat[:, j]))
            self._seq += 1
        # _flush replaces the pending list, so re-read it each iteration
        while len(self._pending.get(matrix_id, ())) >= self.max_batch:
            self._flush(matrix_id, t, FLUSH_FULL, count=self.max_batch)
        return ticket

    def _admit(self, matrix_id: str, k: int, single: bool, n: int,
               t: float) -> ShedTicket | None:
        """Admission check; a `ShedTicket` when a budget would overflow."""
        if self.resilience is None:
            return None
        adm = self.resilience.admission
        over = None
        per = adm.max_pending_per_matrix
        if per is not None and \
                len(self._pending.get(matrix_id, ())) + k > per:
            over = ("max_pending_per_matrix", per,
                    len(self._pending.get(matrix_id, ())))
        tot = adm.max_pending_total
        if over is None and tot is not None and \
                self.pending_columns() + k > tot:
            over = ("max_pending_total", tot, self.pending_columns())
        if over is None:
            return None
        budget, limit, pending = over
        err = LoadShedError(
            f"request for {matrix_id!r} shed: {k} column(s) would "
            f"exceed {budget}={limit} ({pending} pending)",
            detail={"matrix_id": matrix_id, "budget": budget,
                    "limit": int(limit), "pending": int(pending),
                    "columns": k})
        st = self.stats
        st.requests_shed += 1
        st.columns_shed += k
        st.flushes.append(FlushRecord(
            index=-1, matrix_id=matrix_id, reason=FLUSH_SHED, columns=k,
            padded=0, at=t, service_s=0.0))
        self.incidents.append(Incident(
            stage="serve", kind="shed", message=str(err),
            error=type(err).__name__, detail=dict(err.detail)))
        return ShedTicket(matrix_id, n, k, single, t, err)

    def _due_time(self, bucket: list) -> float:
        """When this bucket must flush: oldest arrival + ``max_delay``,
        tightened by the tightest request deadline among its columns (a
        bucket flushes early rather than miss a deadline it could meet)."""
        due = bucket[0][1] + self.max_delay
        for (_, _, ticket, _, _) in bucket:
            d = ticket.deadline
            if d is not None and d < due:
                due = d
        return due

    def pump(self, now: float | None = None) -> int:
        """Flush every bucket that is due at ``now`` (default: the
        injected clock) — its oldest column aged past ``max_delay``, or
        a request deadline would otherwise be missed.  Buckets flush in
        deterministic (due-time, arrival-order) order; returns the
        number of flushes."""
        t = self._clock() if now is None else float(now)
        n_flushed = 0
        while True:
            due = [(due_t, bucket[0][0], mid)
                   for mid, bucket in self._pending.items()
                   for due_t in (self._due_time(bucket),)
                   if due_t <= t]
            if not due:
                return n_flushed
            _, _, mid = min(due)
            self._flush(mid, t, FLUSH_DEADLINE)
            n_flushed += 1

    def drain(self, now: float | None = None) -> int:
        """Flush everything pending regardless of deadline (shutdown /
        end-of-stream); returns the number of flushes."""
        t = self._clock() if now is None else float(now)
        n_flushed = 0
        while self._pending:
            mid = min(self._pending, key=lambda m: self._pending[m][0][0])
            self._flush(mid, t, FLUSH_DRAIN)
            n_flushed += 1
        return n_flushed

    # ------------------------------------------------------------------
    def _solver(self, prog: Program, k: int):
        if self.backend == "numpy":
            return lambda bmat: execute_numpy(prog, bmat)
        from .api import make_solver

        return make_solver(prog, batch=k, backend=self.backend,
                           **self._where(), **self.backend_opts)

    def _where(self) -> dict:
        """Where a flush solves: the mesh, or the service's device."""
        if self.mesh is not None:
            return {"mesh": self.mesh}
        return {"device": self.device}

    @spanned("serve.flush")
    def _flush(self, matrix_id: str, now: float, reason: str,
               count: int | None = None) -> None:
        bucket = self._pending[matrix_id]
        if count is None:
            take, rest = bucket, []
        else:
            take, rest = bucket[:count], bucket[count:]
        if rest:
            self._pending[matrix_id] = rest
        else:
            del self._pending[matrix_id]
        take = self._expire(take, matrix_id, now)
        k = len(take)
        if k == 0:
            self.stats.cache = self.cache.stats_dict()
            return
        prog = self.cache.get(self._mats[matrix_id])
        bmat = np.stack([col for (_, _, _, _, col) in take], axis=1)
        st = self.stats
        t0 = self._timer() if self._timer is not None else 0.0
        err: Exception | None = None
        stage = ""
        with span("serve.solve"):
            if self.resilience is None:
                solve = self._solver(prog, k)
                x = host_array(solve(bmat))
            else:
                try:
                    x, stage = self._resilient_solve(matrix_id, prog, bmat, k)
                except BackendExecutionError as e:
                    err, x = e, None
        dt = (self._timer() - t0) if self._timer is not None else 0.0
        index = st.flush_count()
        if reason == FLUSH_FULL:
            st.flushes_full += 1
        elif reason == FLUSH_DEADLINE:
            st.flushes_deadline += 1
        else:
            st.flushes_drain += 1
        st.solver_calls += 1
        st.flushes.append(FlushRecord(
            index=index, matrix_id=matrix_id, reason=reason, columns=k,
            padded=pad_batch(k), at=now, service_s=dt, stage=stage))
        if err is not None:
            st.failed_flushes += 1
            for (_, _, ticket, _, _) in take:
                ticket._fail(err, now)
        else:
            st.completed_columns += k
            if k > 1:
                st.batched_columns += k
            if self.resilience is not None and stage != self._ladder[0]:
                st.degraded_flushes += 1
            for i, (_, _, ticket, j, _) in enumerate(take):
                ticket._deliver(j, x[:, i], index, now)
        st.cache = self.cache.stats_dict()

    def _expire(self, take: list, matrix_id: str, now: float) -> list:
        """Fail expired entries fast (typed, no solve consumed) and drop
        columns of tickets that already failed; returns the live rest."""
        live = []
        for entry in take:
            ticket = entry[2]
            if ticket.failed:
                continue  # failed whole earlier (deadline / prior flush)
            d = ticket.deadline
            if d is not None and d < now:
                err = DeadlineExceededError(
                    f"request for {matrix_id!r} missed its deadline "
                    f"(deadline {d:.6f} < now {now:.6f})",
                    detail={"matrix_id": matrix_id, "deadline": float(d),
                            "now": float(now),
                            "columns": ticket.columns})
                ticket._fail(err, now)
                self.stats.deadline_failed_columns += ticket.columns
                self.incidents.append(Incident(
                    stage="serve", kind="deadline-expired",
                    message=str(err), error=type(err).__name__,
                    detail=dict(err.detail)))
                continue
            live.append(entry)
        return live

    # -- resilient solve path (DESIGN.md §10) --------------------------
    def _stage_solver(self, stage: str, prog: Program, k: int,
                      mat: TriCSR):
        """Build the solve closure of one ladder rung (executor caches
        make repeated construction cheap — keyed on program identity).
        The torch and cuda closures return tensors on the service's
        device."""
        if stage == "numpy":
            return lambda bmat: execute_numpy(prog, bmat)
        if stage == "reference":
            def fn(bmat):
                bm = np.asarray(bmat, dtype=np.float64)
                return np.stack([serial_solve(mat, bm[:, j])
                                 for j in range(bm.shape[1])], axis=1)
            return fn
        from .api import make_solver

        if stage == "torch":
            return make_solver(prog, batch=k, backend="torch",
                               device=self.device)
        placement = ("blocked" if stage == "cuda-blocked" else "resident")
        opts = {kk: v for kk, v in self.backend_opts.items()
                if kk != "placement"}
        return make_solver(prog, batch=k, backend="cuda", placement=placement,
                           **self._where(), **opts)

    def _resilient_solve(self, matrix_id: str, prog: Program,
                         bmat: np.ndarray, k: int):
        """One flush through the backend ladder under the resilience
        policy; returns ``(x, stage)`` or raises `BackendExecutionError`
        with the flush's incident trail in ``.detail["incidents"]``.

        Per rung: breaker gate (open rungs are skipped; if *every* rung
        is gated the terminal rung runs anyway — the service always
        answers), bounded retry with deterministic backoff on
        exceptions, a hang bound (``flush_timeout_s``) and a non-finite
        output check — health failures are deterministic, so they
        degrade immediately instead of retrying.
        """
        res = self.resilience
        mat = self._mats[matrix_id]
        trail: list[Incident] = []

        def record(stage, kind, message, *, error="", attempt=1,
                   elapsed_s=0.0, detail=None):
            inc = Incident(stage=stage, kind=kind, message=message,
                           error=error, attempt=attempt,
                           elapsed_s=float(elapsed_s),
                           detail={"matrix_id": matrix_id,
                                   **(detail or {})})
            trail.append(inc)
            self.incidents.append(inc)

        t_gate = self._clock()
        stages = [s for s in self._ladder
                  if self._breakers.allow((matrix_id, s), t_gate)]
        if not stages:
            stages = [self._ladder[-1]]
        for stage in stages:
            key = (matrix_id, stage)
            try:
                fn = self._stage_solver(stage, prog, k, mat)
            except Exception as e:  # placement infeasible, build failure
                record(stage, "build-failed", str(e),
                       error=type(e).__name__)
                self._breakers.record(key, self._clock(), False)
                continue
            for attempt in range(1, res.retry.max_retries + 2):
                t0 = self._clock()
                try:
                    x = host_array(fn(bmat))
                except Exception as e:
                    t1 = self._clock()
                    record(stage, "exception", str(e),
                           error=type(e).__name__, attempt=attempt,
                           elapsed_s=t1 - t0)
                    self._breakers.record(key, t1, False)
                    if attempt <= res.retry.max_retries:
                        d = res.retry.delay(attempt,
                                            key=f"{matrix_id}:{stage}")
                        record(stage, "backoff",
                               f"retrying {stage} after {d:.4f}s backoff",
                               attempt=attempt,
                               detail={"backoff_s": d})
                        self.stats.retries += 1
                        if res.sleep is not None:
                            res.sleep(d)
                        continue
                    break  # rung exhausted its retries: degrade
                elapsed = self._clock() - t0
                if res.flush_timeout_s is not None \
                        and elapsed > res.flush_timeout_s:
                    record(stage, "hang",
                           f"{stage} attempt took {elapsed:.4f}s > flush "
                           f"timeout {res.flush_timeout_s:.4f}s",
                           attempt=attempt, elapsed_s=elapsed)
                    self._breakers.record(key, self._clock(), False)
                    break  # never retry a hung rung within the flush
                if not np.isfinite(x).all():
                    record(stage, "nonfinite-output",
                           f"{int(np.count_nonzero(~np.isfinite(x)))} "
                           f"non-finite solution component(s)",
                           attempt=attempt, elapsed_s=elapsed)
                    self._breakers.record(key, self._clock(), False)
                    break  # deterministic health failure: degrade
                self._breakers.record(key, self._clock(), True)
                return x, stage
        msg = (f"flush for {matrix_id!r} exhausted the backend ladder "
               f"({len(trail)} incident(s); stages tried {stages})")
        record("serve", "ladder-exhausted", msg)
        raise BackendExecutionError(
            msg, detail={"matrix_id": matrix_id,
                         "incidents": [i.to_dict() for i in trail]})

    # ------------------------------------------------------------------
    def report(self):
        """The service's health record as an `analysis.AnalysisReport`.

        Every incident of the shared log (cache disk tier + resilient
        flush path) renders as a stable SPT3xx `analysis.Diagnostic`
        (`resilience.incident_to_diagnostic`); log saturation surfaces
        as SPT309.  ``report().to_json()`` / ``report().render()`` are
        the same two renderers the static-analysis CLI uses — one
        machine-readable incident surface across the repo.
        """
        from .analysis.diagnostics import AnalysisReport, Diagnostic
        from .resilience import incident_to_diagnostic

        st = self.stats
        meta = {
            "backend": self.backend,
            "tenants": len(self._mats),
            "requests": st.requests,
            "columns": st.columns,
            "completed_columns": st.completed_columns,
            "flushes": st.flush_count(),
            "requests_shed": st.requests_shed,
            "deadline_failed_columns": st.deadline_failed_columns,
            "retries": st.retries,
            "degraded_flushes": st.degraded_flushes,
            "failed_flushes": st.failed_flushes,
            "cache_hits": self.cache.hits,
            "cache_misses": self.cache.misses,
            "value_refreshes": self.cache.value_refreshes,
        }
        if self._breakers is not None:
            meta["breakers"] = self._breakers.states()
        rep = AnalysisReport(name=f"serve[{self.backend}]", meta=meta)
        rep.extend(incident_to_diagnostic(i) for i in self.incidents)
        if self.incidents.dropped:
            rep.diagnostics.append(Diagnostic(
                code="SPT309", severity="warn", pass_name="serve",
                message=f"incident log saturated: {self.incidents.dropped} "
                        f"oldest record(s) dropped (cap "
                        f"{self.incidents.cap})",
                detail={"dropped": self.incidents.dropped,
                        "cap": self.incidents.cap}))
        return rep
