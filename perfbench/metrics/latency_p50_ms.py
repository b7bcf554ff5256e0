"""latency_p50_ms: median over every request of the window: a solve call
timed from its start to its answer on the host, or a service request from
when it was due to when its ticket was done (the wait behind a flush that
blocked the loop included; ``inf`` for one never answered)."""

from perfbench.metrics_common import latency_ms


def read(rec):
    return latency_ms(rec, 50)
