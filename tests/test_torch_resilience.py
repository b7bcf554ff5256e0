"""The port's resilient serving layer against the JAX package's.

Twins tests/test_resilience.py and tests/test_resilience_property.py: the
breaker state machine, deterministic retry/backoff, the bounded incident
log and its SPT3xx rendering, request deadlines, admission-control load
shedding, the resilient flush ladder (retry, degradation, forced terminal
rung, hangs, typed exhaustion), the unified report, and the service chaos
harness.  Every scenario runs in both packages on the same seeded inputs
and virtual clock, with the numpy entry rung of the reference's tests, so
the answers are bit-equal and the stats, incident kinds and harness
results equal; the torch entry rung (``device="cpu"``) degrades the same
way, with its rung renamed.  No wall clock anywhere.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import csr as ref_csr
from repro.core import errors as ref_errors
from repro.core import executor as ref_executor
from repro.core import matrices as ref_matrices
from repro.core import resilience as ref_resilience
from repro.core import robust as ref_robust
from repro.core import serve as ref_serve
from repro_torch.core import csr, errors, executor, matrices, resilience, robust, serve
from repro_torch.core.resilience import (
    BREAKER_CLOSED,
    BREAKER_HALF_OPEN,
    BREAKER_OPEN,
    BreakerBoard,
    BreakerConfig,
    CircuitBreaker,
    IncidentLog,
    RetryPolicy,
    incident_to_diagnostic,
)
from repro_torch.core.robust import SERVICE_FAULT_CLASSES, Incident, run_service_fault_injection
from repro_torch.core.serve import FLUSH_SHED, ShedTicket

REF = SimpleNamespace(serve=ref_serve, resilience=ref_resilience, robust=ref_robust,
                      errors=ref_errors, csr=ref_csr, executor=ref_executor,
                      matrices=ref_matrices)
PORT = SimpleNamespace(serve=serve, resilience=resilience, robust=robust, errors=errors,
                       csr=csr, executor=executor, matrices=matrices)


def _mats(pkg):
    return (pkg.matrices.banded(64, 6, 0.5, 7, "res-a"),
            pkg.matrices.banded(48, 4, 0.6, 8, "res-b"))


def make_svc(pkg, clock=None, resilience=None, **kw):
    clock = clock or pkg.serve.ManualClock()
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay", 1.0)
    kw.setdefault("backend", "numpy")
    svc = pkg.serve.SolveService(pkg.serve.ProgramCache(), clock=clock,
                                 resilience=resilience, **kw)
    a, b = _mats(pkg)
    svc.register("a", a)
    svc.register("b", b)
    return svc, clock


def _res(pkg, **kw):
    """A `ResilienceConfig` of ``pkg`` from keyword specs of its parts."""
    r = pkg.resilience
    parts = {"retry": r.RetryPolicy, "breaker": r.BreakerConfig,
             "admission": r.AdmissionConfig}
    return r.ResilienceConfig(**{k: parts[k](**v) if k in parts else v
                                 for k, v in kw.items()})


def fail_n_times(svc, stage_name, n, exc=RuntimeError("boom")):
    """Wrap the service's stage-solver: first ``n`` calls of a rung raise."""
    orig = svc._stage_solver
    count = {"left": n}

    def wrapped(stage, prog, k, mat):
        fn = orig(stage, prog, k, mat)
        if stage != stage_name:
            return fn

        def chaotic(bmat):
            if count["left"] > 0:
                count["left"] -= 1
                raise exc
            return fn(bmat)
        return chaotic
    svc._stage_solver = wrapped
    return count


def _summary(svc, tickets):
    """What a scenario shows, comparable across the packages."""
    outs = []
    for t in tickets:
        if t.shed or t.failed:
            outs.append((t.shed, type(t.error).__name__, t.error.detail.get("budget")))
        elif t.done:
            outs.append(("ok", np.asarray(t.result()).tobytes()))
        else:
            outs.append(("pending",))
    st = svc.stats.to_dict()
    st.pop("cache")  # compile_seconds is wall time
    return outs, st, [(i.stage, i.kind, i.error, i.attempt) for i in svc.incidents]


def _twin(scenario):
    """Run ``scenario(pkg)`` in both packages; the results must be equal."""
    port, ref = scenario(PORT), scenario(REF)
    assert port == ref
    return port


# ------------------------------------------------------------- breaker
def _breaker_trace(pkg, cfg, steps):
    """Replay ``steps`` (("allow"|"record", now[, ok])) on one breaker."""
    log = pkg.resilience.IncidentLog()
    board = pkg.resilience.BreakerBoard(pkg.resilience.BreakerConfig(**cfg), sink=log)
    out = []
    for op, now, *ok in steps:
        if op == "allow":
            out.append(board.allow(("a", "numpy"), now))
        else:
            board.record(("a", "numpy"), now, *ok)
        out.append(board.state(("a", "numpy")))
    return out, [(i.kind, i.message, i.detail) for i in log], board.states()


def test_breaker_opens_on_failure_rate_and_cools_down():
    cfg = BreakerConfig(window_s=10.0, min_samples=4, failure_threshold=0.5,
                        cooldown_s=5.0, half_open_probes=1)
    brk = CircuitBreaker(("a", "numpy"), cfg)
    t = 0.0
    for ok in (True, False, True, False):
        assert brk.allow(t)
        brk.record(t, ok)
        t += 1.0
    assert brk.state == BREAKER_OPEN
    assert not brk.allow(t)
    assert not brk.allow(7.99)
    assert brk.allow(8.0)
    assert brk.state == BREAKER_HALF_OPEN
    steps = [("allow", 0.0), ("record", 0.0, True), ("record", 1.0, False),
             ("record", 2.0, True), ("record", 3.0, False), ("allow", 4.0),
             ("allow", 7.99), ("allow", 8.0)]
    cfg = dict(window_s=10.0, min_samples=4, failure_threshold=0.5, cooldown_s=5.0)
    assert _breaker_trace(PORT, cfg, steps) == _breaker_trace(REF, cfg, steps)


def test_breaker_half_open_probe_success_closes():
    cfg = dict(min_samples=2, failure_threshold=0.5, cooldown_s=1.0, half_open_probes=2)
    steps = [("record", 0.0, False), ("record", 0.1, False), ("allow", 2.0),
             ("record", 2.0, True), ("record", 2.1, True), ("record", 2.2, False)]
    states, _, _ = _twin(lambda pkg: _breaker_trace(pkg, cfg, steps))
    assert states == [BREAKER_CLOSED, BREAKER_OPEN, True, BREAKER_HALF_OPEN,
                      BREAKER_HALF_OPEN, BREAKER_CLOSED, BREAKER_CLOSED]


def test_breaker_half_open_probe_failure_reopens_and_rearms():
    cfg = dict(min_samples=2, failure_threshold=0.5, cooldown_s=2.0)
    steps = [("record", 0.0, False), ("record", 0.0, False), ("allow", 2.0),
             ("record", 2.0, False), ("allow", 3.9), ("allow", 4.0)]
    states, _, _ = _twin(lambda pkg: _breaker_trace(pkg, cfg, steps))
    # the failed probe re-opens and re-arms the cooldown from t=2
    assert states == [BREAKER_CLOSED, BREAKER_OPEN, True, BREAKER_HALF_OPEN,
                      BREAKER_OPEN, False, BREAKER_OPEN, True, BREAKER_HALF_OPEN]


def test_breaker_window_expiry_forgets_old_failures():
    cfg = dict(window_s=5.0, min_samples=4, failure_threshold=0.5)
    steps = [("record", 0.0, False), ("record", 0.1, False), ("record", 6.0, True),
             ("record", 6.1, True), ("record", 6.2, True), ("record", 6.3, False)]
    states, log, _ = _twin(lambda pkg: _breaker_trace(pkg, cfg, steps))
    assert states[-1] == BREAKER_CLOSED and log == []


def test_breaker_board_records_transitions_as_incidents():
    cfg = dict(min_samples=2, failure_threshold=0.5, cooldown_s=1.0)
    steps = [("record", 0.0, False), ("record", 0.1, False), ("allow", 2.0),
             ("record", 2.0, True)]
    _, log, states = _twin(lambda pkg: _breaker_trace(pkg, cfg, steps))
    assert [k for k, _, _ in log] == ["breaker-open", "breaker-half-open", "breaker-closed"]
    assert all(d["matrix_id"] == "a" for _, _, d in log)
    assert states == {"a/numpy": BREAKER_CLOSED}
    board = BreakerBoard(BreakerConfig(), sink=IncidentLog())
    assert board.state(("b", "torch")) == BREAKER_CLOSED


# ------------------------------------------------------- retry / backoff
def test_retry_backoff_deterministic_and_bounded():
    kw = dict(max_retries=3, base_delay_s=0.01, max_delay_s=0.05, multiplier=2.0,
              jitter=0.5, seed=42)
    pol, ref = RetryPolicy(**kw), ref_resilience.RetryPolicy(**kw)
    d = [pol.delay(a, key="a:numpy") for a in (1, 2, 3, 4)]
    assert d == [ref.delay(a, key="a:numpy") for a in (1, 2, 3, 4)]
    for got, r in zip(d, [0.01, 0.02, 0.04, 0.05]):
        assert r * 0.5 <= got <= r
    assert pol.delay(1, key="b:numpy") != pol.delay(1, key="a:numpy")
    assert RetryPolicy(seed=1).delay(1, "k") != RetryPolicy(seed=2).delay(1, "k")
    assert RetryPolicy(jitter=0.0).delay(2) == 0.02
    assert RetryPolicy(seed=7).delay(2, "cuda-blocked") == \
        ref_resilience.RetryPolicy(seed=7).delay(2, "cuda-blocked")


@pytest.mark.parametrize("bad", [dict(max_retries=-1), dict(jitter=1.5),
                                 dict(multiplier=0.5), dict(base_delay_s=-1.0)])
def test_retry_policy_validation(bad):
    with pytest.raises(ValueError):
        RetryPolicy(**bad)
    with pytest.raises(ValueError):
        ref_resilience.RetryPolicy(**bad)


def test_retry_delay_is_one_based():
    with pytest.raises(ValueError):
        RetryPolicy().delay(0)


# --------------------------------------------------------- incident log
def test_incident_log_bounded_and_indexable():
    log = IncidentLog(cap=3)
    for i in range(5):
        log.append(Incident(stage="s", kind=f"k{i}", message=str(i)))
    assert len(log) == 3 and log.dropped == 2
    assert log[-1].kind == "k4" and log[0].kind == "k2"
    assert [i.kind for i in log] == ["k2", "k3", "k4"]
    assert log.by_kind() == {"k2": 1, "k3": 1, "k4": 1}
    log.set_cap(1)
    assert len(log) == 1 and log.dropped == 4
    with pytest.raises(ValueError):
        IncidentLog(cap=0)


@pytest.mark.parametrize("kind,code", [
    ("exception", "SPT301"), ("build-failed", "SPT301"), ("ladder-exhausted", "SPT301"),
    ("nonfinite-output", "SPT302"), ("residual", "SPT302"), ("deadline", "SPT303"),
    ("deadline-expired", "SPT303"), ("breaker-open", "SPT304"),
    ("breaker-half-open", "SPT304"), ("shed", "SPT305"), ("disk-corrupt", "SPT306"),
    ("backoff", "SPT307"), ("hang", "SPT308"), ("something-new", "SPT301"),
])
def test_incident_to_diagnostic_codes(kind, code):
    kw = dict(stage="cuda-blocked", kind=kind, message="m", detail={"matrix_id": "a"})
    d = incident_to_diagnostic(Incident(**kw))
    r = ref_resilience.incident_to_diagnostic(ref_robust.Incident(**kw))
    assert d.code == code and d.pass_name == "serve"
    assert d.detail["kind"] == kind and d.detail["matrix_id"] == "a"
    assert (d.code, d.severity, d.message, d.detail) == (r.code, r.severity, r.message,
                                                         r.detail)


# ------------------------------------------------------------ deadlines
def test_expired_deadline_fails_fast_at_submit():
    def scenario(pkg):
        svc, clock = make_svc(pkg)
        clock.advance(5.0)
        t = svc.submit("a", np.random.default_rng(0).standard_normal(64), deadline=4.0)
        assert t.done and t.failed and not t.shed
        with pytest.raises(pkg.errors.DeadlineExceededError) as ei:
            t.result()
        assert ei.value.detail["deadline"] == 4.0
        assert svc.stats.deadline_failed_columns == 1 and svc.stats.solver_calls == 0
        assert svc.incidents[-1].kind == "deadline-expired"
        return _summary(svc, [t]), str(ei.value)
    _twin(scenario)


def test_deadline_tightens_bucket_flush():
    def scenario(pkg):
        svc, clock = make_svc(pkg)
        b = np.random.default_rng(1).standard_normal(64)
        t = svc.submit("a", b, timeout=0.25)
        clock.advance(0.125)
        assert svc.pump() == 0 and not t.done
        clock.advance(0.125)
        assert svc.pump() == 1 and t.done and not t.failed
        np.testing.assert_array_equal(
            t.result(), pkg.executor.execute_numpy(svc.cache.get(_mats(pkg)[0]), b))
        return _summary(svc, [t])
    _twin(scenario)


def test_deadline_missed_in_queue_fails_typed():
    def scenario(pkg):
        svc, clock = make_svc(pkg)
        t = svc.submit("a", np.random.default_rng(2).standard_normal(64), timeout=0.3)
        clock.advance(2.0)
        svc.pump()
        assert t.done and t.failed and svc.stats.solver_calls == 0
        with pytest.raises(pkg.errors.DeadlineExceededError):
            t.result()
        return _summary(svc, [t])
    _twin(scenario)


def test_mixed_bucket_expired_column_does_not_poison_live_ones():
    def scenario(pkg):
        svc, clock = make_svc(pkg)
        rng = np.random.default_rng(3)
        t_short = svc.submit("a", rng.standard_normal(64), timeout=0.2)
        t_long = svc.submit("a", rng.standard_normal(64))
        clock.advance(2.0)
        svc.pump()
        assert t_short.failed and t_long.done and not t_long.failed
        assert t_long.result().shape == (64,)
        return _summary(svc, [t_short, t_long])
    _twin(scenario)


def test_submit_rejects_deadline_and_timeout_together():
    svc, _ = make_svc(PORT)
    with pytest.raises(ValueError, match="not both"):
        svc.submit("a", np.zeros(64), deadline=1.0, timeout=1.0)


# ------------------------------------------------------------- shedding
def test_admission_sheds_over_budget_request_whole():
    def scenario(pkg):
        res = _res(pkg, admission=dict(max_pending_per_matrix=3))
        svc, clock = make_svc(pkg, resilience=res, max_batch=8)
        rng = np.random.default_rng(4)
        ok = svc.submit("a", rng.standard_normal((64, 2)))
        assert not ok.shed and svc.pending_columns("a") == 2
        t = svc.submit("a", rng.standard_normal((64, 2)))
        assert isinstance(t, pkg.serve.ShedTicket) and t.shed and t.done
        with pytest.raises(pkg.errors.LoadShedError) as ei:
            t.result()
        assert ei.value.detail["budget"] == "max_pending_per_matrix"
        assert svc.pending_columns("a") == 2
        st = svc.stats
        assert st.requests_shed == 1 and st.columns_shed == 2
        shed = [f for f in st.flushes if f.reason == pkg.serve.FLUSH_SHED]
        assert len(shed) == 1 and shed[0].index == -1
        assert svc.incidents[-1].kind == "shed"
        other = svc.submit("b", rng.standard_normal(48))
        assert not other.shed
        return _summary(svc, [ok, t]), str(ei.value)
    _twin(scenario)
    assert FLUSH_SHED == "shed" and ShedTicket.shed


def test_global_budget_sheds_across_matrices():
    def scenario(pkg):
        res = _res(pkg, admission=dict(max_pending_total=3))
        svc, _ = make_svc(pkg, resilience=res, max_batch=8)
        rng = np.random.default_rng(5)
        svc.submit("a", rng.standard_normal((64, 2)))
        t = svc.submit("b", rng.standard_normal((48, 2)))
        assert t.shed and t.error.detail["budget"] == "max_pending_total"
        return _summary(svc, [t])
    _twin(scenario)


def test_due_flush_frees_budget_before_admission():
    def scenario(pkg):
        res = _res(pkg, admission=dict(max_pending_per_matrix=2))
        svc, clock = make_svc(pkg, resilience=res, max_batch=8)
        rng = np.random.default_rng(6)
        first = svc.submit("a", rng.standard_normal((64, 2)))
        clock.advance(1.5)
        t = svc.submit("a", rng.standard_normal((64, 2)))
        assert not t.shed
        return _summary(svc, [first, t])
    _twin(scenario)


# ------------------------------------------------- resilient flush path
def test_retry_recovers_transient_fault_same_rung():
    def scenario(pkg):
        svc, clock = make_svc(pkg, resilience=_res(pkg, retry=dict(max_retries=1,
                                                                   jitter=0.0)))
        fail_n_times(svc, "numpy", 1)
        t = svc.submit("a", np.random.default_rng(7).standard_normal(64))
        clock.advance(1.0)
        svc.pump()
        assert t.done and not t.failed
        assert [f for f in svc.stats.flushes if f.index >= 0][-1].stage == "numpy"
        assert svc.stats.retries == 1 and svc.stats.degraded_flushes == 0
        assert {"exception", "backoff"} <= {i.kind for i in svc.incidents}
        return _summary(svc, [t])
    _twin(scenario)


def test_persistent_fault_degrades_to_reference_rung():
    def scenario(pkg):
        svc, clock = make_svc(pkg, resilience=_res(pkg, retry=dict(max_retries=1,
                                                                   jitter=0.0)))
        fail_n_times(svc, "numpy", 99)
        b = np.random.default_rng(8).standard_normal(64)
        t = svc.submit("a", b)
        clock.advance(1.0)
        svc.pump()
        assert t.done and not t.failed
        assert [f for f in svc.stats.flushes if f.index >= 0][-1].stage == "reference"
        assert svc.stats.degraded_flushes == 1
        np.testing.assert_array_equal(t.result(), pkg.csr.serial_solve(_mats(pkg)[0], b))
        return _summary(svc, [t])
    _twin(scenario)


def test_torch_entry_rung_degrades_like_the_jax_rung():
    """A service entered at the torch rung (the reference's jax) walks the
    same ladder: a persistent fault there degrades to numpy, bit for bit
    the reference's numpy answer, with the rung renamed in the trail."""
    def scenario(pkg, backend, opts):
        res = _res(pkg, retry=dict(max_retries=1, jitter=0.0))
        svc, clock = make_svc(pkg, resilience=res, backend=backend, **opts)
        fail_n_times(svc, backend, 99)
        t = svc.submit("a", np.random.default_rng(8).standard_normal((64, 3)))
        clock.advance(1.0)
        svc.pump()
        return _summary(svc, [t])

    outs, st, trail = scenario(PORT, "torch", {"device": "cpu"})
    rout, rst, rtrail = scenario(REF, "jax", {})
    assert (outs, st) == (rout, rst)
    assert trail == [({"jax": "torch"}.get(s, s), *rest) for s, *rest in rtrail]
    assert [s for s, *_ in trail] == ["torch"] * 3  # attempt 1, backoff, attempt 2
    assert st["degraded_flushes"] == 1


def test_repeated_failures_open_breaker_then_skip_rung():
    def scenario(pkg):
        res = _res(pkg, retry=dict(max_retries=0),
                   breaker=dict(min_samples=2, failure_threshold=0.5, cooldown_s=100.0))
        svc, clock = make_svc(pkg, resilience=res)
        fail_n_times(svc, "numpy", 99)
        rng = np.random.default_rng(9)
        tickets = []
        for _ in range(2):
            tickets.append(svc.submit("a", rng.standard_normal(64)))
            clock.advance(1.1)
            svc.pump()
        assert svc._breakers.state(("a", "numpy")) == BREAKER_OPEN
        exc_before = sum(1 for i in svc.incidents if i.kind == "exception")
        t = svc.submit("a", rng.standard_normal(64))
        clock.advance(1.1)
        svc.pump()
        assert t.done and not t.failed
        assert sum(1 for i in svc.incidents if i.kind == "exception") == exc_before
        assert svc._breakers.state(("b", "numpy")) == BREAKER_CLOSED
        return _summary(svc, tickets + [t])
    _twin(scenario)


def test_all_rungs_gated_forces_terminal_rung_service_still_answers():
    def scenario(pkg):
        res = _res(pkg, retry=dict(max_retries=0),
                   breaker=dict(min_samples=1, failure_threshold=0.1, cooldown_s=1e9))
        svc, clock = make_svc(pkg, resilience=res)
        fail_n_times(svc, "numpy", 99)
        counts_ref = fail_n_times(svc, "reference", 1)
        rng = np.random.default_rng(10)
        t1 = svc.submit("a", rng.standard_normal(64))
        clock.advance(1.1)
        svc.pump()
        assert t1.failed and isinstance(t1.error, pkg.errors.BackendExecutionError)
        assert t1.error.detail["incidents"] and svc.stats.failed_flushes == 1
        t2 = svc.submit("a", rng.standard_normal(64))
        clock.advance(1.1)
        svc.pump()
        assert t2.done and not t2.failed and counts_ref["left"] == 0
        assert [f for f in svc.stats.flushes if f.index >= 0][-1].stage == "reference"
        return _summary(svc, [t1, t2])
    _twin(scenario)


def test_nonfinite_output_degrades_without_retry():
    def scenario(pkg):
        svc, clock = make_svc(pkg, resilience=_res(pkg, retry=dict(max_retries=3,
                                                                   jitter=0.0)))
        orig = svc._stage_solver

        def wrapped(stage, prog, k, mat):
            fn = orig(stage, prog, k, mat)
            if stage != "numpy":
                return fn
            return lambda bmat: np.full_like(np.asarray(fn(bmat)), np.nan)
        svc._stage_solver = wrapped
        t = svc.submit("a", np.random.default_rng(11).standard_normal(64))
        clock.advance(1.1)
        svc.pump()
        assert t.done and not t.failed
        assert sum(1 for i in svc.incidents if i.kind == "nonfinite-output") == 1
        assert svc.stats.retries == 0
        return _summary(svc, [t])
    _twin(scenario)


def test_hang_classified_and_rung_abandoned():
    def scenario(pkg):
        res = _res(pkg, retry=dict(max_retries=3, jitter=0.0), flush_timeout_s=0.5)
        svc, clock = make_svc(pkg, resilience=res)
        orig = svc._stage_solver

        def wrapped(stage, prog, k, mat):
            fn = orig(stage, prog, k, mat)
            if stage != "numpy":
                return fn

            def hanging(bmat):
                clock.advance(1.0)
                return fn(bmat)
            return hanging
        svc._stage_solver = wrapped
        t = svc.submit("a", np.random.default_rng(12).standard_normal(64))
        clock.advance(1.1)
        svc.pump()
        assert t.done and not t.failed
        hangs = [i for i in svc.incidents if i.kind == "hang"]
        assert len(hangs) == 1 and hangs[0].elapsed_s > 0.5
        assert [f for f in svc.stats.flushes if f.index >= 0][-1].stage == "reference"
        return _summary(svc, [t])
    _twin(scenario)


def test_backoff_sleeper_is_injectable():
    def scenario(pkg):
        slept = []
        res = _res(pkg, retry=dict(max_retries=2, jitter=0.0, base_delay_s=0.25),
                   sleep=slept.append)
        svc, clock = make_svc(pkg, resilience=res)
        fail_n_times(svc, "numpy", 2)
        svc.submit("a", np.random.default_rng(13).standard_normal(64))
        clock.advance(1.1)
        svc.pump()
        return slept
    assert _twin(scenario) == [0.25, 0.5]


# ------------------------------------------------------- report surface
def test_report_unifies_incidents_as_spt3xx_json():
    def scenario(pkg):
        res = _res(pkg, retry=dict(max_retries=0),
                   admission=dict(max_pending_per_matrix=1))
        svc, clock = make_svc(pkg, resilience=res, max_batch=8)
        fail_n_times(svc, "numpy", 1)
        rng = np.random.default_rng(14)
        svc.submit("a", rng.standard_normal(64))
        svc.submit("a", rng.standard_normal(64))
        svc.submit("b", rng.standard_normal(48), timeout=-1.0)
        clock.advance(1.1)
        svc.pump()
        rep = svc.report()
        assert {"SPT301", "SPT303", "SPT305"} <= rep.codes()
        d = json.loads(rep.to_json())
        assert d["name"] == "serve[numpy]" and d["meta"]["requests_shed"] == 1
        assert d["meta"]["breakers"]
        assert all(dd["code"] in {f"SPT30{i}" for i in range(1, 10)}
                   for dd in d["diagnostics"])
        assert "SPT30" in rep.render()
        return d, rep.render()
    _twin(scenario)


def test_report_surfaces_incident_log_saturation():
    def scenario(pkg):
        res = _res(pkg, retry=dict(max_retries=0), incident_cap=2)
        svc, clock = make_svc(pkg, resilience=res)
        fail_n_times(svc, "numpy", 99)
        rng = np.random.default_rng(15)
        for _ in range(4):
            svc.submit("a", rng.standard_normal(64))
            clock.advance(1.1)
            svc.pump()
        assert len(svc.incidents) == 2 and svc.incidents.dropped > 0
        assert "SPT309" in svc.report().codes()
        return svc.incidents.dropped, json.loads(svc.report().to_json())
    _twin(scenario)


def test_one_shared_incident_log_cache_and_service(tmp_path):
    """Disk-tier corruption and flush-path incidents land in ONE log."""
    def scenario(pkg):
        res = _res(pkg, retry=dict(max_retries=0))
        disk = tmp_path / pkg.serve.__name__
        cache = pkg.serve.ProgramCache(capacity=1, disk_dir=disk)
        clock = pkg.serve.ManualClock()
        svc = pkg.serve.SolveService(cache, max_batch=4, max_delay=1.0, clock=clock,
                                     backend="numpy", resilience=res)
        a, b = _mats(pkg)
        svc.register("a", a)
        svc.register("b", b)
        assert svc.incidents is cache.incidents
        rng = np.random.default_rng(16)
        tickets = [svc.submit("a", rng.standard_normal(64))]
        clock.advance(1.1)
        svc.pump()
        tickets.append(svc.submit("b", rng.standard_normal(48)))
        clock.advance(1.1)
        svc.pump()
        blob = next(disk.glob("*.prog"))
        raw = bytearray(blob.read_bytes())
        raw[50] ^= 0xFF
        blob.write_bytes(bytes(raw))
        fail_n_times(svc, "numpy", 1)
        tickets.append(svc.submit("a", rng.standard_normal(64)))
        clock.advance(1.1)
        svc.pump()
        assert tickets[-1].done and not tickets[-1].failed
        assert {"disk-corrupt", "exception"} <= {i.kind for i in svc.incidents}
        assert {"SPT306", "SPT301"} <= svc.report().codes()
        return _summary(svc, tickets)
    _twin(scenario)


# ------------------------------------------------------- chaos harness
@pytest.mark.parametrize("seed", range(5))
def test_service_chaos_matches_the_reference(seed):
    results = run_service_fault_injection(seed=seed, requests=14)
    assert {r["fault"] for r in results} == set(SERVICE_FAULT_CLASSES)
    assert not any(r["silent_wrong"] for r in results), results
    assert not any(r["deadlocked"] for r in results), results
    assert all(r["tickets"] == 14 for r in results)
    assert results == ref_robust.run_service_fault_injection(seed=seed, requests=14)


def test_chaos_sheds_and_typed_failures_actually_happen():
    total = {"shed": 0, "failed_typed": 0, "completed": 0}
    for seed in range(3):
        for r in run_service_fault_injection(seed=seed, requests=14):
            for k in total:
                total[k] += r[k]
    assert all(v > 0 for v in total.values()), total


# ---------------------------------------------- legacy path unaffected
def test_without_resilience_config_legacy_behavior_intact():
    def scenario(pkg):
        svc, clock = make_svc(pkg)
        assert svc.resilience is None and svc._breakers is None
        t = svc.submit("a", np.random.default_rng(17).standard_normal(64))
        clock.advance(1.0)
        svc.pump()
        assert t.done and not t.failed and not t.shed
        st = svc.stats.to_dict()
        assert st["requests_shed"] == st["retries"] == st["failed_flushes"] == 0
        return _summary(svc, [t])
    _twin(scenario)


def test_resilience_overhead_fault_free_accounting_is_clean():
    def scenario(pkg):
        svc, clock = make_svc(pkg, resilience=pkg.resilience.ResilienceConfig())
        rng = np.random.default_rng(18)
        tickets = []
        for _ in range(6):
            tickets.append(svc.submit("a", rng.standard_normal(64)))
            clock.advance(1.1)
            svc.pump()
        assert len(svc.incidents) == 0
        st = svc.stats
        assert st.retries == st.degraded_flushes == st.failed_flushes == 0
        assert all(f.stage == "numpy" for f in st.flushes)
        states = svc._breakers.states()
        assert states and all(s == BREAKER_CLOSED for s in states.values())
        return _summary(svc, tickets), states
    _twin(scenario)


# --------------------------------------------- random fault interleavings
# (tenant, n_cols, fault, advance_s, rhs_seed): the property suite's steps,
# replayed from fixed seeds; the fault applies to the entry ("numpy") rung
# of the flush that next consumes the solver.
_FAULTS = ["none", "none", "exc", "exc-exc", "nan"]


def _steps(seed, n):
    rng = np.random.default_rng(seed)
    return [(["a", "b"][int(rng.integers(2))], int(rng.integers(1, 6)),
             _FAULTS[int(rng.integers(5))], [0.0, 0.05, 0.2, 0.6, 1.5][int(rng.integers(5))],
             int(rng.integers(2 ** 16))) for _ in range(n)]


def _interleaving(pkg, steps):
    mats = {"a": pkg.matrices.banded(40, 6, 0.6, 101, "prop_res_a"),
            "b": pkg.matrices.banded(32, 4, 0.5, 102, "prop_res_b")}
    clock = pkg.serve.ManualClock()
    res = _res(pkg, retry=dict(max_retries=1, base_delay_s=0.001, jitter=0.0),
               breaker=dict(window_s=30.0, min_samples=3, failure_threshold=0.6,
                            cooldown_s=2.0),
               admission=dict(max_pending_per_matrix=8, max_pending_total=12))
    svc = pkg.serve.SolveService(pkg.serve.ProgramCache(), max_batch=3, max_delay=0.5,
                                 clock=clock, backend="numpy", resilience=res)
    for mid, m in mats.items():
        svc.register(mid, m)
    feed = [f for (_, _, f, _, _) in steps]
    orig = svc._stage_solver

    def wrapped(stage, prog, k, mat):
        fn = orig(stage, prog, k, mat)
        if stage != "numpy":
            return fn

        def chaotic(bmat):
            action = feed.pop(0) if feed else "none"
            if action.startswith("exc"):
                if action == "exc-exc":
                    feed.insert(0, "exc")
                raise RuntimeError("injected backend fault")
            x = np.asarray(fn(bmat))
            return np.full_like(x, np.nan) if action == "nan" else x
        return chaotic
    svc._stage_solver = wrapped

    tickets = []
    for mid, k, _, adv, seed in steps:
        rng = np.random.default_rng(seed)
        n = mats[mid].n
        rhs = (rng.standard_normal(n) if k == 1
               else rng.standard_normal((n, k))).astype(np.float32)
        tickets.append((svc.submit(mid, rhs), rhs))
        clock.advance(adv)
        svc.pump()
    clock.advance(10.0)
    svc.pump()
    svc.drain()

    flush_by_index = {r.index: r for r in svc.stats.flushes if r.index >= 0}
    for ticket, rhs in tickets:
        assert ticket.done, "ticket left pending after drain (deadlock)"
        if ticket.shed or ticket.failed:
            assert isinstance(ticket.error, pkg.errors.RobustnessError)
            continue
        stages = {flush_by_index[i].stage for i in ticket.flush_indices}
        got = np.asarray(ticket.result())
        if stages == {"numpy"}:
            want = pkg.executor.execute_numpy(svc.cache.get(mats[ticket.matrix_id]), rhs)
            np.testing.assert_array_equal(got, want)
        else:
            assert pkg.robust.relative_residual(mats[ticket.matrix_id], got, rhs) <= 1e-3
    assert svc.stats.requests == len(steps)
    return _summary(svc, [t for t, _ in tickets])


@pytest.mark.parametrize("seed", range(6))
def test_random_fault_interleavings_match_the_reference(seed):
    """Every ticket terminates (completed, typed-failed or shed), every
    completed one is bit-identical to its stage's oracle, and the port's
    run equals the reference's: outcomes, stats and incident trail."""
    steps = _steps(seed, 12)
    port = _interleaving(PORT, steps)
    assert port == _interleaving(REF, steps)
    assert port == _interleaving(PORT, steps)  # replays deterministically
