"""Loop ``serve``: independent clients, open loop, through the solve service.

Requests of 1 to 4 columns arrive at the traffic's fixed rate; the service
is ``api.make_service(backend="cuda", clock=time.monotonic,
timer=time.perf_counter, max_batch, max_delay)`` with one tenant.  The
service is synchronous, so one thread drives it: ``submit`` at each due
time and ``pump`` when the oldest pending column's ``max_delay`` runs out,
and spins in between.

Every seed gets the same work in another order: the gaps between arrivals
are the ``N = rate * seconds`` quantiles of the exponential distribution
(a Poisson stream's gaps), scaled to fill the window, and the widths are
1, 2, 3, 4 in equal shares, both shuffled by the seed.  A request is timed
from when it was due to when its ticket is done, so a flush that blocks the
loop counts against the requests due behind it; the generator's lateness
(submit time less due time) is kept too.  After the last arrival the loop
pumps on until every ticket is done, at most ``tail_wait_s``; a request
still without an answer then keeps the latency ``inf`` and counts as
missing.

Every request's columns hold new numbers (`perfbench.common.RhsStream`:
pool rows times the seed's scale for that request), made into a new array
once the previous request is submitted, so ahead of its due time.
"""

from __future__ import annotations

import collections
import math
import time

import numpy as np

from perfbench.common import RhsStream, seed_rng

TENANT = "m"


def schedule(rate: float, seconds: float, widths, seed: int):
    """``(arrivals_s, widths)`` of one window: the same multiset of gaps
    and widths for every seed, in the seed's order."""
    n_req = max(1, int(round(rate * seconds)))
    rng = seed_rng(seed, 1)
    gaps = -np.log1p(-(np.arange(n_req) + 0.5) / n_req) / rate
    gaps = rng.permutation(gaps)
    gaps *= seconds / gaps.sum()
    arrivals = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    w = rng.permutation(np.resize(np.asarray(widths, dtype=np.int64), n_req))
    return arrivals, w


class Loop:
    def __init__(self, system, traffic: dict, seed: int, device):
        from repro_torch.core import api

        self.system = system
        self.traffic = traffic
        self.seed = seed
        self.rate = float(traffic["rate_rps"])
        self.svc = api.make_service(
            {TENANT: system.mat}, backend="cuda", device=device,
            clock=time.monotonic, timer=time.perf_counter,
            max_batch=traffic["max_batch"], max_delay=traffic["max_delay_s"],
            schedule=system.schedule, **system.solver_opts)
        self.rhs = RhsStream(system.n, traffic["pool"], seed, device)
        self._f0 = 0
        self._n = 0

    def warm(self) -> None:
        """Flushes at the padded widths this traffic reaches (the first one
        compiles the program in the service's cache)."""
        svc, rhs = self.svc, self.rhs
        for _ in range(2):
            for w in self.traffic["warm_widths"]:
                tk = svc.submit(TENANT, rhs.make(0, 0, w).T)
                svc.drain()
                tk.result()
        self.system.note_program(svc.cache.get(self.system.mat))

    def _first_rows(self, widths):
        """Pool row of each request's first column: consecutive, wrapping
        to row 0 where a request would run past the pool's end."""
        k, s, out = len(self.rhs.pool), 0, []
        for w in widths.tolist():
            if s + w > k:
                s = 0
            out.append(s)
            s += w
        return out

    def run(self, seconds: float, span) -> None:
        svc, rhs, tr = self.svc, self.rhs, self.traffic
        arrivals, widths = schedule(self.rate, seconds, tr["widths"],
                                    self.seed)
        starts = self._first_rows(widths)
        wl = widths.tolist()
        n = self._n = len(arrivals)
        flushes = svc.stats.flushes
        self._f0 = len(flushes)
        maxd = svc.max_delay
        clock = time.monotonic
        tickets = [None] * n
        done = [math.inf] * n
        late = [math.nan] * n
        fspans = []              # (wall, first flush, flushes) per call
        out = collections.deque()

        def reap(t):
            while out and tickets[out[0]].done:
                done[out.popleft()] = t

        nxt_b = rhs.make(0, starts[0], wl[0]).T
        t0 = clock()
        due = (arrivals + t0).tolist()
        give_up = t0 + seconds + tr["tail_wait_s"]
        i = 0
        while True:
            now = clock()
            if now >= give_up:
                break
            if i < n and now >= due[i]:
                c = len(flushes)
                with span("submit"):
                    tk = svc.submit(TENANT, nxt_b)
                t1 = clock()
                tickets[i] = tk
                late[i] = now - due[i]
                out.append(i)
                i += 1
                if i < n:
                    nxt_b = rhs.make(i, starts[i], wl[i]).T
                if len(flushes) > c:
                    fspans.append((t1 - now, c, len(flushes) - c))
                    reap(t1)
                continue
            fdue = math.inf
            if out:
                fdue = tickets[out[0]].submitted_at + maxd
                if now >= fdue:
                    c = len(flushes)
                    with span("pump"):
                        svc.pump()
                    t1 = clock()
                    if len(flushes) > c:
                        fspans.append((t1 - now, c, len(flushes) - c))
                        reap(t1)
                    continue
            elif i >= n:
                break
            nxt = min(due[i] if i < n else math.inf, fdue, give_up)
            with span("generator_wait"):
                while clock() < nxt:
                    pass
        self._t0, self._seconds = t0, seconds
        self._tickets, self._rows, self._widths = tickets, starts, widths
        self._due = np.asarray(due) - t0
        self._done = np.asarray(done) - t0
        self._late = np.asarray(late)
        self._fspans = fspans

    def _backlog(self, lo: float, hi: float, points: int = 200) -> float:
        """Mean columns due and not yet done over [lo, hi] of the window."""
        cum = np.concatenate([[0], np.cumsum(self._widths)])
        ts = np.linspace(lo, hi, points)
        due_cols = cum[np.searchsorted(self._due, ts, side="right")]
        done_sorted = np.sort(self._done)
        done_cols = cum[np.searchsorted(done_sorted, ts, side="right")]
        return float(np.mean(due_cols - done_cols))

    def record(self) -> dict:
        flushes = self.svc.stats.flushes[self._f0:]
        at = {f.index: f.at - self._t0 for f in flushes}
        wait = []
        for k, tk in enumerate(self._tickets):
            if tk is not None and tk.done and not tk.failed:
                wait.append(at[max(tk.flush_indices)] - self._due[k])
        finished = np.isfinite(self._done)
        last = float(self._done[finished].max()) if finished.any() else 0.0
        cols_done = int(self._widths[finished].sum())
        sec = self._seconds
        return {
            "latency_s": (self._done - self._due).tolist(),
            "attempted": self._n,
            "failed": sum(1 for tk in self._tickets
                          if tk is not None and tk.failed),
            "missing": sum(1 for tk in self._tickets
                           if tk is None or not tk.done),
            "columns": int(self._widths.sum()),
            "window_s": sec,
            "launch_columns": [f.columns for f in flushes],
            "flush_spans": [(wall, [f.service_s for f in
                                    self.svc.stats.flushes[c:c + k]])
                            for wall, c, k in self._fspans],
            "queue_wait_s": wait,
            "late_s": self._late.tolist(),
            "offered_columns_per_s": float(self._widths.sum()) / sec,
            "completed_columns_per_s": cols_done / max(last, sec),
            "backlog_columns": [self._backlog(0.0, sec / 4),
                                self._backlog(3 * sec / 4, sec)],
        }

    def answers(self):
        """``[(b [n, k], x [n, k] or None)]`` for a sample of the window's
        requests drawn from the seed; None for one that never came."""
        n = self._n
        rng = seed_rng(self.seed, 3)
        pick = np.sort(rng.choice(n, size=min(n, self.traffic["sample"]),
                                  replace=False))
        out = []
        for k in pick.tolist():
            tk = self._tickets[k]
            s, w = self._rows[k], int(self._widths[k])
            x = tk.result() if (tk is not None and tk.done
                                and not tk.failed) else None
            out.append((self.rhs.make(k, s, w).T, x))
        return out

    def close(self) -> None:
        self.svc = None
