"""staging_ms: host time of a solve call with the device idle: the median
over the traced window's calls of (the call's wall less the device's busy
time inside it).  That is the H2D and D2H staging, the executor's
allocations and the launch from the host."""

import numpy as np


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    vals = [(e - s) - tr.busy(s, e) for _, s, e in tr.spans_named("solve_call")]
    return float(np.median(vals)) * 1e3 if vals else None
