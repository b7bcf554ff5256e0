"""Loop ``solve1``: one caller, one right-hand side a call, closed loop.

The caller holds the closure of ``api.make_solver(prog, backend="cuda")``
and calls it with a 1-D numpy ``b``, takes ``.cpu().numpy()`` and only then
makes the next call: what an iterative method does when it applies a
triangular factor once an iteration.  The service is bypassed.

Every call's right-hand side holds new numbers (`perfbench.common.RhsStream`:
call i is pool row ``i % pool`` times the seed's i-th scale), written
before the call into one buffer, so the same address sees other numbers at
every call and an answer kept from an earlier call would fail the check.
The write is outside the call's latency and inside the window.  Answers are kept for a systematic sample of the
calls (every ``stride``-th from a phase drawn from the seed, ``stride`` set
from the warm-up's pace so that about ``sample`` are kept) and compared
after the window.
"""

from __future__ import annotations

import time

import numpy as np

from perfbench.common import RhsStream, seed_rng


class Loop:
    def __init__(self, system, traffic: dict, seed: int, device):
        from repro_torch.core import api

        self.system = system
        self.traffic = traffic
        self.prog = system.compile()
        self.solver = api.make_solver(self.prog, backend="cuda",
                                      device=device, **system.solver_opts)
        self.rhs = RhsStream(system.n, traffic["pool"], seed, device)
        self.buf = np.empty((1, system.n), dtype=np.float32)
        self._phase_u = float(seed_rng(seed, 2).random())
        self.latency_s: list[float] = []
        self.kept: dict[int, object] = {}
        self.window_s = 0.0
        self._call_s = None

    def warm(self) -> None:
        """``warm_calls`` calls at the window's one width; the last one's
        time sets the sample's stride."""
        rhs, buf, solver = self.rhs, self.buf, self.solver
        k = len(rhs.pool)
        for i in range(self.traffic["warm_calls"]):
            rhs.fill(i, i % k, 1, buf)
            t0 = time.perf_counter()
            solver(buf[0]).cpu().numpy()
            self._call_s = time.perf_counter() - t0

    def run(self, seconds: float, span) -> None:
        rhs, buf, solver = self.rhs, self.buf, self.solver
        fill, b, k = rhs.fill, buf[0], len(rhs.pool)
        est = max(1, int(seconds / max(self._call_s, 1e-6)))
        stride = max(1, est // self.traffic["sample"])
        phase = int(self._phase_u * stride)
        lat, kept = self.latency_s, self.kept
        clock = time.perf_counter
        i = 0
        start = clock()
        end = start + seconds
        t1 = start
        while True:
            fill(i, i % k, 1, buf)
            t0 = clock()
            if t0 >= end:
                break
            with span("solve_call"):
                x = solver(b).cpu().numpy()
            t1 = clock()
            lat.append(t1 - t0)
            if i % stride == phase:
                kept[i] = x
            i += 1
        self.window_s = t1 - start

    def record(self) -> dict:
        return {"latency_s": self.latency_s,
                "attempted": len(self.latency_s), "failed": 0, "missing": 0,
                "columns": len(self.latency_s), "window_s": self.window_s,
                "launch_columns": [1] * len(self.latency_s)}

    def answers(self):
        """``[(b [n, 1], x [n, 1] or None)]`` for the kept calls."""
        rhs = self.rhs
        k = len(rhs.pool)
        return [(rhs.make(i, i % k, 1).T, x[:, None])
                for i, x in sorted(self.kept.items())]

    def close(self) -> None:
        self.solver = self.prog = None
