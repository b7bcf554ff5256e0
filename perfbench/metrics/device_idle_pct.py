"""device_idle_pct: the share of the solving wall in which no device
operation ran.  In a solve loop that is the traced window (first solve
call's start to the last one's end); in a service it is the flushing
submit and pump calls alone, the gaps between arrivals left out: at a
fixed rate a faster host would otherwise read as more idle."""

from perfbench.metrics_common import flushing_spans


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    calls = tr.spans_named("solve_call")
    if calls:
        lo, hi = calls[0][1], calls[-1][2]
        return 100.0 * (1.0 - tr.busy(lo, hi) / (hi - lo))
    spans = flushing_spans(rec)
    if not spans:
        return None
    wall = sum(e - s for _, s, e in spans)
    busy = sum(tr.busy(s, e) for _, s, e in spans)
    return 100.0 * (1.0 - busy / wall)
