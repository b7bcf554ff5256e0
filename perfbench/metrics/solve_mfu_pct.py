"""solve_mfu_pct: the whole solve's share of the chip's peak: the least
time of the window's launches (`perfbench.work.roofline_s` of each launch's
columns, from the CSR matrix alone) over the summed wall of the calls that
solved them: the solve calls of a solve loop, or a service's submit and
pump calls that flushed."""

from perfbench.metrics_common import flushing_spans, mfu_pct


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    return mfu_pct(rec, tr.spans_named("solve_call") or flushing_spans(rec))
