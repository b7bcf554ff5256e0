"""Reduction of a `torch.profiler` trace to what the metric readers read.

A traced run wraps each of the benchmark's calls into the program in a
``record_function`` span (`SPANS`), so the host spans and the device's
operations share the profiler's clock.  `Trace` holds both, in seconds:

* ``spans``: ``[(name, start, end)]`` of the benchmark's own spans;
* ``device``: ``[(name, start, end)]`` of every device operation
  (kernels, copies, memsets), the spans' own device-side marks left out;
* `busy` answers "how long was the device busy between lo and hi" from
  the union of the device intervals.

Device busy time is the union of the device intervals (on one stream, the
sum of the operations' times) and the idle share ``1 - busy / wall``, as
``repro_torch.launch.profile.device_breakdown`` reckons them.
"""

from __future__ import annotations

import bisect
import collections

__all__ = ["SPANS", "Trace", "from_profiler"]

# the benchmark's spans around its calls into the program, and its wait
# for the next arrival
SPANS = ("solve_call", "submit", "pump", "generator_wait")
TOP = 10


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    def __init__(self, spans, device, window):
        self.spans = sorted(spans, key=lambda s: s[1])
        self.device = sorted(device, key=lambda d: d[1])
        self.window = window
        merged = _merge((s, e) for _, s, e in self.device)
        self._starts = [s for s, _ in merged]
        self._ends = [e for _, e in merged]
        self._cum = [0.0]
        for s, e in merged:
            self._cum.append(self._cum[-1] + (e - s))

    def busy(self, lo: float, hi: float) -> float:
        """Seconds in [lo, hi] in which some device operation ran."""
        if hi <= lo or not self._starts:
            return 0.0
        i = bisect.bisect_right(self._ends, lo)       # first ending after lo
        j = bisect.bisect_left(self._starts, hi)      # first starting at/after hi
        if j <= i:
            return 0.0
        total = self._cum[j] - self._cum[i]
        total -= max(0.0, lo - self._starts[i])
        total -= max(0.0, self._ends[j - 1] - hi)
        return total

    def spans_named(self, *names):
        return [s for s in self.spans if s[0] in names]

    def kernels(self, pattern: str):
        """Device operations whose name contains ``pattern``, in order."""
        return [d for d in self.device if pattern in d[0]]

    def busy_s(self) -> float:
        return self.busy(*self.window)

    def device_ops(self):
        """``[[name, seconds]]`` of the device operations that took most
        time in all, at most `TOP`."""
        by = collections.Counter()
        for name, s, e in self.device:
            by[name] += e - s
        return [[name[:160], t] for name, t in by.most_common(TOP)]

    def idle_gaps(self):
        """``[[span, seconds]]``: the device's idle time in the window,
        by the benchmark span that was open on the host meanwhile
        (``between_calls`` where none was), at most `TOP`."""
        lo, hi = self.window
        gaps, t = [], lo
        for s, e in zip(self._starts, self._ends):
            if s > t:
                gaps.append((t, min(s, hi)))
            t = max(t, e)
        if t < hi:
            gaps.append((t, hi))
        by = collections.Counter()
        starts = [s for _, s, _ in self.spans]
        for g0, g1 in gaps:
            if g1 <= g0:
                continue
            covered = 0.0
            k = max(0, bisect.bisect_right(starts, g0) - 1)
            while k < len(self.spans) and self.spans[k][1] < g1:
                name, s, e = self.spans[k]
                part = min(e, g1) - max(s, g0)
                if part > 0:
                    by[name] += part
                    covered += part
                k += 1
            if g1 - g0 - covered > 0:
                by["between_calls"] += g1 - g0 - covered
        return [[name, t] for name, t in by.most_common(TOP)]


def from_profiler(prof, window=None) -> Trace:
    """Build a `Trace` from a finished ``torch.profiler.profile``.

    ``window`` defaults to the first to the last of the benchmark's spans.
    """
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, device = [], []
    # the profiler's raw events: no event tree is built
    for evt in prof.profiler.kineto_results.events():
        name, dtype = evt.name(), evt.device_type()
        s, e = evt.start_ns() * 1e-9, evt.end_ns() * 1e-9
        if name in SPANS:
            if dtype != cuda:
                spans.append((name, s, e))
        elif dtype == cuda and not evt.is_user_annotation():
            device.append((name, s, e))
    if window is None and spans:
        window = (min(s for _, s, _ in spans), max(e for _, _, e in spans))
    return Trace(spans, device, window or (0.0, 0.0))
