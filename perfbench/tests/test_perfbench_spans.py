"""The program's own spans and build counter beside the benchmark's readers.

The port records ``record_function`` spans inside its solve path
(`repro_torch.spans.NAMES`) whenever a profiler runs, so a traced window
holds them beside the benchmark's spans: `devtrace.from_profiler` keeps
them out of ``spans``, ``device`` and the window, so every reader reads
what it read before the program had spans.
``kernel_build_s`` reads the program's count of seconds spent in ``nvcc``.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from perfbench import devtrace, harness
from perfbench.tests.helpers import cells, run_cpu
from repro_torch import spans
from repro_torch.core import api, matrices
from repro_torch.kernels import common


def reader(name):
    return harness.load_module(harness.reader_path(name)).read


def _traced_flushes(device):
    """A profile of three flushes of a service, each inside a benchmark
    span, with a benchmark span between them; the service warmed first."""
    mat = matrices.generate("chem_bp")
    svc = api.make_service({"m": mat}, backend="cuda", device=device)
    b = torch.ones(mat.n, 2).numpy()
    svc.submit("m", b)
    svc.drain()
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for name in ("submit", "pump", "submit"):
            with record_function("generator_wait"):
                pass
            with record_function(name):
                svc.submit("m", b)
                svc.drain()
        if acts[-1] == ProfilerActivity.CUDA:
            torch.cuda.synchronize()
    return prof


def _check_kept_out(prof):
    tr = devtrace.from_profiler(prof)
    assert [s[0] for s in tr.spans] == ["generator_wait", "submit",
                                        "generator_wait", "pump",
                                        "generator_wait", "submit"]
    assert tr.window == (tr.spans[0][1], max(e for _, _, e in tr.spans))
    assert not {d[0] for d in tr.device} & set(spans.NAMES)
    recorded = {e.name for e in prof.events()}
    assert set(spans.NAMES) <= recorded
    return tr


def test_from_profiler_keeps_program_spans_out():
    tr = _check_kept_out(_traced_flushes("cpu"))
    assert tr.device == [] and tr.busy_s() == 0.0
    assert dict(tr.idle_gaps()).keys() <= set(devtrace.SPANS) | {
        "between_calls"}


@pytest.mark.cuda
def test_from_profiler_keeps_program_spans_out_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tr = _check_kept_out(_traced_flushes("cuda"))
    # the device's operations are the kernels and copies, none of them a
    # span's device-side mark
    assert any("resident_kernel" in d[0] for d in tr.device)
    assert 0.0 < tr.busy_s() < tr.window[1] - tr.window[0]


@pytest.mark.parametrize("secs, want", [
    (None, None), ({}, None), ({"sptrsv": 0.0}, 0.0),
    ({"sptrsv": 12.5, "ssd_scan": 0.0}, 12.5)])
def test_kernel_build_s_reads_the_build_counter(monkeypatch, secs, want):
    if secs is None:
        monkeypatch.delattr(common, "BUILD_SECONDS")
    else:
        monkeypatch.setattr(common, "BUILD_SECONDS", secs)
    assert reader("kernel_build_s")({}) == want


@pytest.mark.parametrize("cell", cells())
@pytest.mark.parametrize("secs", [{}, {"sptrsv": 0.0}])
def test_traced_line_reports_kernel_build_s_where_a_library_loaded(
        monkeypatch, cell, secs):
    monkeypatch.setattr(common, "BUILD_SECONDS", secs)
    r = run_cpu(cell, trace=True)
    assert r["correct"] is True
    if secs:
        assert r["metrics"]["kernel_build_s"] == {"value": 0.0, "unit": "s"}
    else:
        assert "kernel_build_s" not in r["metrics"]
