"""The port's profiler spans (`repro_torch.spans`).

Under a ``torch.profiler`` the solve path records every name of
`spans.NAMES`, each nested where its work happens; with no profiler no
``record_function`` is entered and the answers are bit for bit those of
the kernels called directly, as the path did before it had spans.  The
train step's phases (`launch.steps.SPANS`) go through the same gate.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import api, matrices
from repro_torch.kernels.sptrsv import ops

CPU = {"backend": "cuda", "device": "cpu"}


@pytest.fixture(scope="module")
def mat():
    return matrices.generate("chem_bp")


@pytest.fixture(scope="module")
def prog(mat):
    return api.compile(mat)


@pytest.fixture
def entered(monkeypatch):
    """How many ``record_function`` ranges the code under test entered."""
    count = [0]
    real = autograd_profiler.record_function

    class Counting(real):
        def __enter__(self):
            count[0] += 1
            return super().__enter__()

    monkeypatch.setattr(autograd_profiler, "record_function", Counting)
    return count


def _rhs(n: int, k: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


def _flush_once(svc, b):
    tk = svc.submit("m", b)
    svc.drain()
    return tk.result()


def _recorded(fn):
    """``(result, [(name, start_us, end_us)])`` of the port's spans that
    ``fn()`` recorded under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    evs = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name in spans.NAMES]
    return out, evs


def _inside(evs, inner, outer):
    """Every ``inner`` span lies within some ``outer`` span."""
    outs = [(s, e) for n, s, e in evs if n == outer]
    ins = [(s, e) for n, s, e in evs if n == inner]
    assert ins and outs, (inner, outer)
    return all(any(s0 <= s and e <= e0 for s0, e0 in outs) for s, e in ins)


def test_span_is_the_shared_null_context_without_a_profiler(entered):
    assert not autograd_profiler._is_profiler_enabled
    assert spans.span("serve.flush") is spans.span("exec.h2d")
    with spans.span("serve.flush"):
        pass
    assert entered[0] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        ctx = spans.span("serve.flush")
        assert isinstance(ctx, autograd_profiler.record_function)
        with ctx:
            pass
    assert entered[0] == 1


def test_flush_and_solve_record_every_span_nested(mat, prog):
    svc = api.make_service({"m": mat}, **CPU)
    b = _rhs(mat.n, 3)
    _flush_once(svc, b)                      # compiles outside the profile
    _, evs = _recorded(lambda: _flush_once(svc, b))
    names = {n for n, _, _ in evs}
    assert names == set(spans.NAMES)
    assert sum(n == "serve.flush" for n, _, _ in evs) == 1
    assert _inside(evs, "serve.fingerprint", "serve.cache_get")
    assert _inside(evs, "serve.values_crc", "serve.cache_get")
    assert _inside(evs, "serve.cache_get", "serve.flush")
    assert _inside(evs, "serve.solve", "serve.flush")
    for inner in ("exec.h2d", "sptrsv.rhs_stage", "sptrsv.launch"):
        assert _inside(evs, inner, "serve.solve")

    solve = api.make_solver(prog, **CPU)
    _, evs = _recorded(lambda: solve(_rhs(mat.n, 1)[:, 0]))
    assert [n for n, _, _ in evs] == ["exec.h2d", "sptrsv.rhs_stage",
                                      "sptrsv.launch"]


@pytest.mark.parametrize("placement", ["resident", "blocked"])
def test_no_profiler_enters_no_span_and_answers_are_unchanged(
        mat, prog, entered, placement):
    b = _rhs(mat.n, 5, seed=1)
    solve = api.make_solver(prog, batch=5, placement=placement, **CPU)
    core = ops.build_solver_cols(prog, 8, placement=placement, device="cpu")
    assert solve.placement == core.placement == placement
    x = solve(b)
    # the parent's solve_cols, step for step: zeroed bp, b copied in, the
    # kernel wrapper, the pad columns and rows sliced off
    instr, values = core.staged
    n_rows = prog.n + 1 if placement == "resident" else core.plan.n_hbm
    bp = torch.zeros((n_rows, 8), dtype=torch.float32)
    bp[:prog.n, :5] = torch.from_numpy(b)
    slots = ops._psum_slots(prog)
    if placement == "resident":
        ref = ops.sptrsv_cuda(instr, values, bp, num_slots=slots,
                              x_in_smem=core.x_in_smem,
                              cols_per_cta=ops.COLS_PER_CTA)
    else:
        ref = ops.sptrsv_cuda_blocked(
            instr, values, bp, window=core.plan.window,
            stride=core.plan.stride, cycles_per_block=128, num_slots=slots,
            cols_per_cta=ops.COLS_PER_CTA)
    assert torch.equal(x, ref[:prog.n, :5])

    svc = api.make_service({"m": mat}, placement=placement, **CPU)
    np.testing.assert_array_equal(_flush_once(svc, b), x.numpy())
    one = api.make_solver(prog, placement=placement, **CPU)
    assert torch.equal(one(b[:, 0]), x[:, 0])
    assert entered[0] == 0
    # the same answers with the spans recorded
    x_traced, _ = _recorded(lambda: solve(b))
    assert torch.equal(x_traced, x)
    assert entered[0] == 3


def test_train_step_phases_are_gated_spans(entered):
    from repro_torch.launch import steps, train

    tr = train.setup(train.parse_args(
        ["--reduced", "--device", "cpu", "--batch", "2", "--seq", "16"]))
    step = lambda s: tr.train_step(tr.model, tr.opt_state, tr.batch(s))
    step(0)
    assert entered[0] == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(1)
    assert entered[0] == len(steps.SPANS)
    names = {e.name for e in prof.events()}
    assert set(steps.SPANS) <= names


def test_spanned_reads_the_gate_at_each_call(entered):
    @spans.spanned("serve.flush")
    def twice(x, *, k=2):
        """doc"""
        return k * x

    assert twice.__name__ == "twice" and twice.__doc__ == "doc"
    assert twice(3) == 6 and entered[0] == 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert twice(3, k=3) == 9
    assert entered[0] == 1
    assert [e.name for e in prof.events()
            if e.name in spans.NAMES] == ["serve.flush"]


def test_span_times_and_idle_by_span_by_hand():
    from repro_torch.launch.profile import idle_by_span, span_times

    # two calls; the first holds h2d and a launch, the launch holds nothing
    host = [("call", 0, 100), ("exec.h2d", 10, 30), ("sptrsv.launch", 40, 60),
            ("call", 120, 150)]
    t = span_times(host)
    assert t["call"] == {"count": 2, "median_ms": 0.065, "self_ms": 0.045}
    assert t["exec.h2d"] == {"count": 1, "median_ms": 0.02, "self_ms": 0.02}
    # the device works 20-25 (a copy) and 50-110 (the kernel, past the call)
    idle = idle_by_span(host, [(50, 110), (20, 25)])
    want = {"call": 0.010 + 0.010 + 0.030 + 0.0,   # 0-10, 30-40, 120-150
            "exec.h2d": 0.015, "sptrsv.launch": 0.010, "between calls": 0.010}
    assert idle.keys() == want.keys()
    for name, ms in want.items():
        assert idle[name] == pytest.approx(ms)
    assert idle_by_span([], [(0, 1)]) == {}


@pytest.mark.parametrize("mode, want", [
    (["--solve", "chem_bp"], ("profile.solve", "exec.h2d", "sptrsv.rhs_stage",
                              "sptrsv.launch")),
    (["--service", "banded(500, 8, 0.5, 3)", "--columns", "2"],
     ("profile.flush",) + spans.NAMES)])
def test_profile_tool_reads_the_solve_paths_spans(capsys, mode, want):
    from repro_torch.launch import profile as tool

    r = tool.main(mode + ["--calls", "2", "--device", "cpu"])
    assert set(r["spans"]) == set(want)
    assert all(t["count"] == 2 and 0 <= t["self_ms"] <= t["median_ms"]
               for t in r["spans"].values())
    assert list(r["wall_ms"]) == ["no profiler", "CPU profiler"]
    assert list(r["spans_cost_ms"]) == ["CPU profiler"]
    assert r["empty_span_us"]["no profiler"] < r["empty_span_us"]["CPU profiler"]
    assert "idle_ms" not in r                     # no device on the CPU
    out = capsys.readouterr().out
    assert all(name in out for name in want)


def test_profile_tool_keeps_every_other_calls_spans_off():
    from repro_torch.launch.profile import _timed_calls

    seen = []

    def call(i):
        with spans.span("exec.h2d"):
            pass
        seen.append(i)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on, off = _timed_calls(call, range(4), [ProfilerActivity.CPU])
    assert seen == [0, 1, 2, 3] and len(on) == len(off) == 2
    assert sum(e.name == "exec.h2d" for e in prof.events()) == 2
    assert not autograd_profiler._is_profiler_enabled
    on, off = _timed_calls(call, range(3))          # no profiler: no halves
    assert len(on) == 3 and off == []
