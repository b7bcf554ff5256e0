"""latency_p95_ms: 95th percentile of the same requests as
latency_p50_ms."""

from perfbench.metrics_common import latency_ms


def read(rec):
    return latency_ms(rec, 95)
