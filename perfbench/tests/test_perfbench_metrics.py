"""Each metric reader's arithmetic on a synthetic record."""

import pytest

from perfbench import harness, work
from perfbench.common import percentile
from perfbench.devtrace import Trace

MS = 1e-3


def reader(name):
    return harness.load_module(harness.reader_path(name)).read


def solve_record():
    # two calls of 10 ms, each with a 6 ms blocked kernel and 1 ms of copies
    spans = [("solve_call", 0.0, 0.010), ("solve_call", 0.011, 0.021)]
    device = [("Memcpy HtoD", 0.001, 0.0015), ("x blocked_kernel<1, 2>", 0.002, 0.008),
              ("Memcpy DtoH", 0.0085, 0.009),
              ("Memcpy HtoD", 0.012, 0.0125), ("x blocked_kernel<1, 2>", 0.013, 0.019),
              ("Memcpy DtoH", 0.0195, 0.020)]
    return {"trace": Trace(spans, device, (0.0, 0.021)), "n": 65536,
            "nnz": 433143, "launch_columns": [1, 1],
            "latency_s": [0.010, 0.010], "columns": 2, "window_s": 0.021}


def serve_record():
    # a flushing submit of 8 ms (kernel 2 ms), a pump that only waits
    spans = [("submit", 0.0, 0.008), ("generator_wait", 0.008, 0.010),
             ("pump", 0.010, 0.011), ("submit", 0.011, 0.015)]
    device = [("y resident_kernel<1, 2, true>", 0.005, 0.007),
              ("y resident_kernel<1, 2, true>", 0.012, 0.013)]
    return {"trace": Trace(spans, device, (0.0, 0.015)), "n": 32768,
            "nnz": 143517, "launch_columns": [3, 5],
            "flush_spans": [(0.008, [0.002]), (0.004, [0.001, 0.001])],
            "queue_wait_s": [i * MS for i in range(1, 101)]}


def test_trace_busy_clips_to_the_range():
    tr = Trace([], [("k", 0.0, 1.0), ("k", 2.0, 3.0), ("c", 2.5, 3.5)],
               (0.0, 4.0))
    assert tr.busy(0.5, 2.5) == pytest.approx(1.0)
    assert tr.busy(0.0, 4.0) == pytest.approx(2.5)
    assert tr.busy(1.2, 1.8) == 0.0
    assert tr.busy(2.2, 2.4) == pytest.approx(0.2)
    assert tr.busy_s() == pytest.approx(2.5)


def test_idle_gaps_by_the_open_span():
    rec = serve_record()
    gaps = dict(rec["trace"].idle_gaps())
    assert gaps["submit"] == pytest.approx(0.006 + 0.003)
    assert gaps["generator_wait"] == pytest.approx(0.002)
    assert gaps["pump"] == pytest.approx(0.001)
    ops = dict(rec["trace"].device_ops())
    assert ops["y resident_kernel<1, 2, true>"] == pytest.approx(0.003)


def test_latency_and_rate_readers():
    rec = {"latency_s": [i * MS for i in range(1, 101)], "columns": 300,
           "window_s": 2.0, "setup_s": 12.5}
    assert reader("latency_p50_ms")(rec) == pytest.approx(50.5)
    assert reader("latency_p95_ms")(rec) == pytest.approx(95.05)
    assert reader("columns_per_s")(rec) == pytest.approx(150.0)
    assert reader("setup_s")(rec) == 12.5
    assert reader("latency_p50_ms")({"latency_s": []}) is None


def test_a_split_metric_is_read_by_its_base_reader():
    assert harness.reader_path("latency_p95_ms.serve_ckt") == \
        harness.HERE / "metrics" / "latency_p95_ms.py"
    assert harness.reader_path("sptrsv_cuda_roofline.serve_ckt.x") == \
        harness.HERE / "metrics" / "sptrsv_cuda_roofline.py"
    assert harness.reader_path("device_idle_pct") == \
        harness.HERE / "metrics" / "device_idle_pct.py"
    assert not harness.reader_path("no_such_metric.solve_band").exists()
    rec = {"latency_s": [i * MS for i in range(1, 101)]}
    assert reader("latency_p95_ms.serve_ckt")(rec) == reader(
        "latency_p95_ms")(rec)


def test_an_unanswered_request_stays_in_the_tail():
    # 10 of 100 requests never answered: the p95 reaches them
    rec = {"latency_s": [i * MS for i in range(1, 91)] + [float("inf")] * 10}
    assert reader("latency_p50_ms")(rec) == pytest.approx(50.5)
    assert reader("latency_p95_ms")(rec) == float("inf")


def test_program_readers():
    rec = {"compile_s": 7.5, "program_cycles": 63268}
    assert reader("compile_s")(rec) == 7.5
    assert reader("program_cycles")(rec) == 63268


def test_solve_readers():
    rec = solve_record()
    # each call: 10 ms of wall, 6 + 0.5 + 0.5 ms busy
    assert reader("staging_ms")(rec) == pytest.approx(3.0)
    assert reader("device_idle_pct.solve_band")(rec) == pytest.approx(
        100 * (1 - 0.014 / 0.021))
    least = 2 * work.roofline_s(65536, 433143, 1)
    assert reader("sptrsv_cuda_blocked_roofline.solve_band")(rec) == \
        pytest.approx(100 * least / 0.012)
    assert reader("solve_mfu_pct.solve_band")(rec) == pytest.approx(
        100 * least / 0.020)
    assert reader("sptrsv_cuda_roofline")(rec) is None


def test_serve_readers():
    rec = serve_record()
    # (8 - 2) ms for the first flush, (4 / 2 - 1) ms twice for the others
    assert reader("flush_overhead_ms")(rec) == pytest.approx(1.0)
    assert reader("queue_wait_p95_ms")(rec) == pytest.approx(95.05)
    # the two submits flushed: 12 ms of wall, 3 ms busy; the pump did not
    assert reader("device_idle_pct.serve_ckt")(rec) == pytest.approx(75.0)
    least = (work.roofline_s(32768, 143517, 3)
             + work.roofline_s(32768, 143517, 5))
    assert reader("sptrsv_cuda_roofline.serve_ckt")(rec) == pytest.approx(
        100 * least / 0.003)
    assert reader("solve_mfu_pct.serve_ckt")(rec) == pytest.approx(
        100 * least / 0.012)
    assert reader("sptrsv_cuda_blocked_roofline")(rec) is None


def test_readers_find_nothing_without_a_trace():
    for name in ("staging_ms", "device_idle_pct", "solve_mfu_pct",
                 "sptrsv_cuda_roofline", "sptrsv_cuda_blocked_roofline"):
        assert reader(name)({"trace": None, "launch_columns": [1]}) is None


def test_roofline_needs_a_launch_for_every_flush():
    rec = serve_record()
    rec["launch_columns"] = [3]
    assert reader("sptrsv_cuda_roofline")(rec) is None


INF = float("inf")


@pytest.mark.parametrize("values, q, want", [
    ([1.0, 2.0, 3.0, 4.0, 5.0], 50, 3.0),
    ([1.0, 2.0, 3.0, 4.0, 5.0], 95, 4.8),
    ([3.0], 95, 3.0),
    ([1.0, 2.0, INF], 50, 2.0),
    ([1.0, 2.0, INF], 95, INF),
    ([1.0, INF, INF], 50, INF),
    ([], 50, None),
])
def test_percentile_keeps_unanswered_requests(values, q, want):
    got = percentile(values, q)
    assert got == (pytest.approx(want) if want not in (None, INF) else want)
