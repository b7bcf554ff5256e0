"""flush_overhead_ms: the service's own time per flush, outside the
solve: the median over flushes of (the wall of the submit or pump call that
flushed, over its flushes) less the flush's ``FlushRecord.service_s``.
That is the cache lookup (fingerprint, values CRC), stacking and delivery.
"""

import numpy as np


def read(rec):
    vals = [wall / len(svc) - s
            for wall, svc in rec.get("flush_spans", ()) for s in svc]
    return float(np.median(vals)) * 1e3 if vals else None
