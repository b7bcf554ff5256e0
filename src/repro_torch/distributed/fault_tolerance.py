"""Fault tolerance: heartbeat failure detection + straggler mitigation.

At 1000+ node scale, node failure is routine (MTBF of the *fleet* is
minutes-to-hours) and stragglers dominate tail latency.  This module holds
the pure control-plane logic — host-agnostic and fully unit-testable; the
launcher (`repro_torch.launch.train`) wires it to the run loop and the
`CheckpointManager` + `elastic.plan_remesh` recovery path:

    failure detected  -> abort step -> plan_remesh(healthy) ->
    restore latest checkpoint -> resume at recorded step (data pipeline is
    step-indexed so no samples are lost or repeated)

Straggler policy follows the "tolerate, don't block" approach: per-step
durations are tracked per host; hosts slower than `factor` x the rolling
median for `patience` consecutive steps are flagged, first for data-shard
rebalancing, then for eviction (treated as a failure).

Both classes are clock-injectable: every timestamp flows through the
``clock`` callable handed to the constructor (default ``time.monotonic``)
or through explicit ``at=`` arguments — no wall-clock call sits inside the
decision logic, so the timeout and eviction paths are deterministically
unit-testable with a fake clock.

A copy of `repro/distributed/fault_tolerance.py` (plain Python).
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque

__all__ = ["HeartbeatMonitor", "StragglerPolicy"]


class HeartbeatMonitor:
    """Tracks per-host liveness; a host is failed after `timeout_s` silence."""

    def __init__(self, hosts: list[int], timeout_s: float = 60.0,
                 clock=time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        now = clock()
        self._last = {h: now for h in hosts}
        self._failed: set[int] = set()

    def beat(self, host: int, at: float | None = None) -> None:
        if host in self._failed:
            return  # failed hosts must rejoin via `rejoin`
        self._last[host] = self._clock() if at is None else at

    def check(self, at: float | None = None) -> list[int]:
        """Returns newly failed hosts."""
        now = self._clock() if at is None else at
        newly = [
            h
            for h, t in self._last.items()
            if h not in self._failed and now - t > self.timeout_s
        ]
        self._failed.update(newly)
        return newly

    def rejoin(self, host: int, at: float | None = None) -> None:
        self._failed.discard(host)
        self._last[host] = self._clock() if at is None else at

    def last_seen(self, host: int) -> float:
        """Timestamp of the host's most recent heartbeat (clock domain)."""
        return self._last[host]

    @property
    def healthy(self) -> list[int]:
        return sorted(set(self._last) - self._failed)

    @property
    def failed(self) -> list[int]:
        return sorted(self._failed)


@dataclasses.dataclass
class StragglerVerdict:
    rebalance: list[int]   # slow: shift data share away
    evict: list[int]       # hopeless: treat as failed
    at: float = 0.0        # verdict timestamp (policy clock domain)


class StragglerPolicy:
    """Rolling-median step-time policy with hysteresis.

    ``clock`` only stamps verdicts for incident records — the flag/evict
    decisions depend purely on the recorded step durations, so the policy
    is deterministic under any clock.
    """

    def __init__(self, factor: float = 1.5, patience: int = 5,
                 window: int = 50, evict_factor: float = 3.0,
                 clock=time.monotonic):
        self.factor = factor
        self.evict_factor = evict_factor
        self.patience = patience
        self._clock = clock
        self._times: dict[int, deque] = defaultdict(lambda: deque(maxlen=window))
        self._strikes: dict[int, int] = defaultdict(int)

    def record_step(self, durations: dict[int, float],
                    at: float | None = None) -> StragglerVerdict:
        if not durations:
            raise ValueError("record_step needs at least one host duration")
        med = sorted(durations.values())[len(durations) // 2]
        rebalance, evict = [], []
        for h, d in durations.items():
            self._times[h].append(d)
            if d > self.evict_factor * med:
                self._strikes[h] += 2
            elif d > self.factor * med:
                self._strikes[h] += 1
            else:
                self._strikes[h] = max(0, self._strikes[h] - 1)
            if self._strikes[h] >= 2 * self.patience:
                evict.append(h)
            elif self._strikes[h] >= self.patience:
                rebalance.append(h)
        return StragglerVerdict(rebalance=rebalance, evict=evict,
                                at=self._clock() if at is None else at)

    def host_share(self, hosts: list[int], flagged: list[int],
                   discount: float = 0.5) -> dict[int, float]:
        """Data-share weights after rebalancing away from stragglers."""
        w = {h: (discount if h in flagged else 1.0) for h in hosts}
        z = sum(w.values())
        return {h: v / z for h, v in w.items()}
