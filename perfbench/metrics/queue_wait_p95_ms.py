"""queue_wait_p95_ms: 95th percentile over the window's requests of the
wait from the request's due time to the start (``FlushRecord.at``) of the
flush that delivered its last column."""

from perfbench.common import percentile


def read(rec):
    v = percentile(rec.get("queue_wait_s", ()), 95)
    return None if v is None else v * 1e3
