"""Arithmetic that more than one metric reader uses."""

from __future__ import annotations

from perfbench import work
from perfbench.common import percentile


def latency_ms(rec, q: float):
    """The ``q``-th percentile of the window's request latencies, in ms."""
    v = percentile(rec.get("latency_s", ()), q)
    return None if v is None else v * 1e3


def flushing_spans(rec):
    """The traced submit and pump calls that flushed: those in which the
    device did some work (a call that only enqueues does none)."""
    tr = rec.get("trace")
    if tr is None:
        return []
    return [sp for sp in tr.spans_named("submit", "pump")
            if tr.busy(sp[1], sp[2]) > 0.0]


def kernel_roofline_pct(rec, pattern: str):
    """The least time of the window's launches of the kernel whose device
    name contains ``pattern`` over their device time, in %; None where the
    trace holds no such launch or not one for each launch of the window."""
    tr = rec.get("trace")
    if tr is None:
        return None
    launches = tr.kernels(pattern)
    cols = rec["launch_columns"]
    if not launches or len(launches) != len(cols):
        return None
    device = sum(e - s for _, s, e in launches)
    least = sum(work.roofline_s(rec["n"], rec["nnz"], k) for k in cols)
    return 100.0 * least / device


def mfu_pct(rec, spans):
    """The least time of the window's launches (`perfbench.work.roofline_s`
    of each launch's columns, from the CSR matrix alone) over the summed
    wall of the calls that solved them, in %."""
    if not spans:
        return None
    wall = sum(e - s for _, s, e in spans)
    least = sum(work.roofline_s(rec["n"], rec["nnz"], k)
                for k in rec["launch_columns"])
    return 100.0 * least / wall
