"""The port's solve service and program cache against the JAX package's.

Twins tests/test_serve.py and tests/test_serve_property.py: every
scheduling branch of the micro-batcher on an injectable clock (the flush
log, completion order and routing equal to the reference's; every routed
column bit-identical to the port's own per-request solve and within 1e-5
of the reference's jax answer), the executor-cache discipline (one staging
per program and padded width), and the `ProgramCache` tiers — LRU order,
capacity-1 thrash, disk rehydrate, corruption degrading to a recompile,
values-only refresh — with the reference's counters.  The cross-package
contract: `pattern_fingerprint` equal on every suite matrix, the disk tier
written by either package rehydrating in the other without a compile.

The port's own rules: a flush whose solver returns a device tensor (one
that refuses ``np.asarray``, as a CUDA tensor does) delivers without an
incident, a machine without CUDA raises when a service is constructed, and
``mesh=`` takes only a `shard.BatchMesh` and no ``device=`` beside it
(tests/test_torch_shard.py runs the sharded streams).  All on the CPU
(``device="cpu"``).
"""

import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import executor as ref_executor
from repro.core import matrices as ref_matrices
from repro.core import serve as ref_serve
from repro_torch.core import api, executor, matrices, serve, shard
from repro_torch.core.csr import from_coo
from repro_torch.core.errors import ProgramCorruptionError
from repro_torch.core.matrices import generate, suite_names
from repro_torch.core.resilience import ResilienceConfig, RetryPolicy
from repro_torch.core.serve import (
    FLUSH_DEADLINE,
    FLUSH_DRAIN,
    FLUSH_FULL,
    ManualClock,
    ProgramCache,
    SolveService,
    pattern_fingerprint,
)

TOL = dict(rtol=1e-5, atol=1e-5)  # torch against jax, both float32
CPU = {"device": "cpu"}
PORT = SimpleNamespace(serve=serve, api=api, matrices=matrices, backend="torch", opts=CPU)
REF = SimpleNamespace(serve=ref_serve, api=ref_api, matrices=ref_matrices,
                      backend="jax", opts={})


def _mats(pkg):
    return {"a": pkg.matrices.generate("band_cz"), "b": pkg.matrices.generate("chem_bp")}


@pytest.fixture(scope="module")
def mats():
    return _mats(PORT)


def make_svc(pkg, clock, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_delay", 1.0)
    if kw.get("backend", pkg.backend) != "numpy":
        kw = {**pkg.opts, **kw}
    svc = pkg.serve.SolveService(pkg.serve.ProgramCache(), clock=clock, **kw)
    for mid, m in _mats(pkg).items():
        svc.register(mid, m)
    return svc


def oracle(svc, mid, b):
    """The port's per-request solve of ``b`` through the service's backend."""
    prog = svc.cache.get(svc._mats[mid])
    return np.asarray(api.solve(prog, np.asarray(b, np.float32), device="cpu"))


def _log(svc, tickets):
    """The schedule a scenario produced, comparable across the packages."""
    flushes = [(f.index, f.matrix_id, f.reason, f.columns, f.padded, f.at, f.stage)
               for f in svc.stats.flushes]
    return flushes, [(t.done, t.completed_at, t.flush_indices) for t in tickets]


def _twin(scenario):
    """``scenario(pkg)`` -> (schedule, results) in both packages: equal
    schedules, results within `TOL`."""
    (log, xs), (ref_log, ref_xs) = scenario(PORT), scenario(REF)
    assert log == ref_log
    for x, rx in zip(xs, ref_xs, strict=True):
        np.testing.assert_allclose(x, np.asarray(rx), **TOL)
    return log


# ---------------------------------------------------------------- batcher
def test_deadline_flush_not_before_deadline():
    def scenario(pkg):
        clock = pkg.serve.ManualClock()
        svc = make_svc(pkg, clock)
        t = svc.submit("a", np.random.default_rng(0).standard_normal(628))
        assert not t.done
        clock.advance(0.999)
        assert svc.pump() == 0 and not t.done
        clock.advance(0.001)
        assert svc.pump() == 1 and t.done
        assert svc.stats.flushes_deadline == 1 and svc.stats.flushes_full == 0
        assert svc.stats.flushes[0].reason == FLUSH_DEADLINE
        return _log(svc, [t]), [t.result()]
    _twin(scenario)
    clock = ManualClock()
    svc = make_svc(PORT, clock)
    b = np.random.default_rng(0).standard_normal(628)
    t = svc.submit("a", b)
    clock.advance(1.0)
    svc.pump()
    np.testing.assert_array_equal(t.result(), oracle(svc, "a", b))


def test_bucket_full_flush_is_immediate_no_clock_motion(mats):
    rng = np.random.default_rng(1)
    bs = [rng.standard_normal(mats["a"].n) for _ in range(4)]

    def scenario(pkg):
        svc = make_svc(pkg, pkg.serve.ManualClock())
        tickets = [svc.submit("a", b) for b in bs]
        assert all(t.done for t in tickets)
        assert svc.stats.flushes_full == 1 and svc.stats.flushes_deadline == 0
        rec = svc.stats.flushes[0]
        assert (rec.reason, rec.columns, rec.padded) == (FLUSH_FULL, 4, 8)
        if pkg is PORT:
            for t, b in zip(tickets, bs):
                np.testing.assert_array_equal(t.result(), oracle(svc, "a", b))
        return _log(svc, tickets), [t.result() for t in tickets]
    _twin(scenario)


def test_out_of_order_completion_across_matrices(mats):
    def scenario(pkg):
        clock = pkg.serve.ManualClock()
        svc = make_svc(pkg, clock)
        rng = np.random.default_rng(2)
        slow = svc.submit("a", rng.standard_normal(mats["a"].n))
        fast = [svc.submit("b", rng.standard_normal(mats["b"].n)) for _ in range(4)]
        assert all(t.done for t in fast) and not slow.done
        clock.advance(1.0)
        svc.pump()
        assert slow.done and slow.completed_at == 1.0 and fast[0].completed_at == 0.0
        return _log(svc, [slow] + fast), [t.result() for t in [slow] + fast]
    _twin(scenario)


def test_deadline_order_is_deterministic_oldest_first(mats):
    def scenario(pkg):
        clock = pkg.serve.ManualClock()
        svc = make_svc(pkg, clock)
        rng = np.random.default_rng(3)
        ta = svc.submit("a", rng.standard_normal(mats["a"].n))
        clock.advance(0.5)
        tb = svc.submit("b", rng.standard_normal(mats["b"].n))
        clock.advance(1.0)
        assert svc.pump() == 2 and ta.done and tb.done
        assert [f.matrix_id for f in svc.stats.flushes] == ["a", "b"]
        return _log(svc, [ta, tb]), [ta.result(), tb.result()]
    _twin(scenario)


def test_submit_pumps_due_buckets_before_enqueueing(mats):
    def scenario(pkg):
        clock = pkg.serve.ManualClock()
        svc = make_svc(pkg, clock)
        rng = np.random.default_rng(4)
        old = svc.submit("a", rng.standard_normal(mats["a"].n))
        clock.advance(5.0)
        new = svc.submit("a", rng.standard_normal(mats["a"].n))
        assert old.done and not new.done and svc.stats.flushes[0].columns == 1
        return _log(svc, [old, new]), [old.result()]
    _twin(scenario)


def test_wide_request_spans_flushes_and_routes_all_columns(mats):
    n = mats["a"].n
    bmat = np.random.default_rng(5).standard_normal((n, 10))

    def scenario(pkg):
        svc = make_svc(pkg, pkg.serve.ManualClock())
        t = svc.submit("a", bmat)
        assert not t.done and svc.pending_columns("a") == 2
        assert svc.stats.flushes_full == 2
        assert svc.drain() == 1
        assert t.done and t.flush_indices == [0, 1, 2]
        assert svc.stats.flushes[2].reason == FLUSH_DRAIN
        got = t.result()
        assert got.shape == (n, 10)
        if pkg is PORT:
            for j in range(10):
                np.testing.assert_array_equal(got[:, j], oracle(svc, "a", bmat[:, j]))
        return _log(svc, [t]), [got]
    _twin(scenario)


def test_per_request_result_routing_distinct_rhs(mats):
    rng = np.random.default_rng(6)
    bs = [rng.standard_normal(mats["b"].n) for _ in range(8)]

    def scenario(pkg):
        svc = make_svc(pkg, pkg.serve.ManualClock(), max_batch=8)
        tickets = [svc.submit("b", b) for b in bs]
        if pkg is PORT:
            for t, b in zip(tickets, bs):
                np.testing.assert_array_equal(t.result(), oracle(svc, "b", b))
        return _log(svc, tickets), [t.result() for t in tickets]
    _twin(scenario)


def test_zero_column_request_completes_immediately(mats):
    svc = make_svc(PORT, ManualClock())
    t = svc.submit("a", np.zeros((mats["a"].n, 0)))
    assert t.done and t.result().shape == (mats["a"].n, 0)
    assert svc.pending_columns() == 0


def test_submit_errors(mats):
    svc = make_svc(PORT, ManualClock())
    with pytest.raises(KeyError, match="unknown matrix_id"):
        svc.submit("nope", np.zeros(4))
    with pytest.raises(ValueError, match="expected b of shape"):
        svc.submit("a", np.zeros(mats["a"].n + 1))
    with pytest.raises(ValueError, match="already registered"):
        svc.register("a", mats["a"])
    t = svc.submit("a", np.zeros(mats["a"].n))
    with pytest.raises(RuntimeError, match="pump\\(\\) or drain\\(\\)"):
        t.result()


def test_core_never_reads_wall_clock(mats):
    calls = []

    def clock():
        calls.append(1)
        return 0.0

    svc = make_svc(PORT, clock)
    svc.submit("a", np.zeros(mats["a"].n), now=0.0)
    svc.pump(now=2.0)
    svc.drain(now=3.0)
    assert calls == []
    svc.submit("a", np.zeros(mats["a"].n))
    assert len(calls) == 1


def test_numpy_backend_and_servestats(mats):
    rng = np.random.default_rng(7)
    bs = [rng.standard_normal(mats["a"].n) for _ in range(4)]

    def scenario(pkg):
        svc = make_svc(pkg, pkg.serve.ManualClock(), backend="numpy")
        before = executor.trace_count()
        tickets = [svc.submit("a", b) for b in bs]
        assert executor.trace_count() == before  # numpy path never stages
        prog = svc.cache.get(svc._mats["a"])
        for t, b in zip(tickets, bs):
            np.testing.assert_array_equal(t.result(), pkg.api.solve_numpy(prog, b))
        st = svc.stats
        assert (st.requests, st.columns, st.completed_columns) == (4, 4, 4)
        assert st.batched_columns == 4 and st.solver_calls == 1 and st.cache["entries"]
        d = st.to_dict()
        assert d["flushes"][0]["reason"] == FLUSH_FULL and json.dumps(d)
        d.pop("cache")
        return d, [t.result() for t in tickets]

    (d, xs), (rd, rxs) = scenario(PORT), scenario(REF)
    assert d == rd
    for x, rx in zip(xs, rxs):
        np.testing.assert_array_equal(x, rx)


def test_service_arg_validation():
    with pytest.raises(ValueError, match="max_batch"):
        SolveService(max_batch=0, **CPU)
    with pytest.raises(ValueError, match="max_delay"):
        SolveService(max_delay=-1.0, **CPU)
    with pytest.raises(ValueError, match="numpy"):
        SolveService(backend="numpy", mesh=object())
    with pytest.raises(ValueError):
        SolveService(backend="bogus", **CPU)
    for backend in ("torch", "cuda"):
        with pytest.raises(TypeError, match="mesh"):
            SolveService(backend=backend, mesh=object(), **CPU)
        with pytest.raises(TypeError, match="mesh"):
            api.make_service(backend=backend, mesh=object(), **CPU)
        mesh = shard.batch_mesh(devices=("cpu",))
        with pytest.raises(ValueError, match="mesh"):
            SolveService(backend=backend, mesh=mesh, **CPU)
        assert SolveService(backend=backend, mesh=mesh).device.type == "cpu"


# ------------------------------------------------------ executor contract
def test_executor_cache_key_contract_asserted(mats):
    prog = ProgramCache().get(mats["a"])
    with pytest.raises(AssertionError, match="padded width"):
        executor._cached_executor(prog, 3, torch.device("cpu"))
    executor.make_torch_executor(prog, batch=3, **CPU)  # pads to 8 internally
    entries = executor.cached_entries(prog)
    assert entries and all(e[1] == executor.pad_batch(e[1]) for e in entries)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_service_stages_once_per_program_and_padded_width(mats, backend):
    """Flush widths 1..max_batch bucket with the executor cache's own
    rounding (1, 8, 16): a (program, rung) stages once per padded width,
    however many flushes, and a rehydrated program is staged anew."""
    svc = make_svc(PORT, ManualClock(), max_batch=16, backend=backend)
    rng = np.random.default_rng(8)
    before = executor.trace_count()
    for width in (1, 3, 5, 16, 2, 1, 9, 16, 7):
        svc.submit("a", rng.standard_normal((mats["a"].n, width)))
        svc.drain()
    widths = {f.padded for f in svc.stats.flushes}
    assert widths == {1, 8, 16}
    assert executor.trace_count() - before == len(widths)
    prog = svc.cache.get(svc._mats["a"])
    assert {e[1] for e in executor.cached_entries(prog)} == widths


# ---------------------------------------------------------- program cache
def _pattern_variant(mat, seed):
    """Same shape/nnz as ``mat``, different pattern (one edge moved)."""
    rng = np.random.default_rng(seed)
    rows, cols, vals = [], [], []
    for i in range(mat.n):
        for j in range(mat.rowptr[i], mat.rowptr[i + 1] - 1):
            rows.append(i)
            cols.append(int(mat.colidx[j]))
            vals.append(float(mat.values[j]))
    for k in range(len(cols)):
        i, c = rows[k], cols[k]
        taken = {cols[q] for q in range(len(cols)) if rows[q] == i}
        options = [c2 for c2 in range(i) if c2 != c and c2 not in taken]
        if options:
            cols[k] = int(rng.choice(options))
            break
    diag = np.asarray([float(mat.values[mat.rowptr[i + 1] - 1]) for i in range(mat.n)])
    return from_coo(mat.n, np.asarray(rows), np.asarray(cols), np.asarray(vals), diag,
                    name=mat.name + "_variant")


def test_fingerprint_structure_only_and_distinguishes_patterns(mats):
    m = mats["a"]
    fp = pattern_fingerprint(m)
    assert pattern_fingerprint(dataclasses.replace(m, values=m.values * 2.0)) == fp
    m3 = _pattern_variant(m, 0)
    assert m3.n == m.n and m3.nnz == m.nnz and pattern_fingerprint(m3) != fp
    assert pattern_fingerprint(m, "auto") != fp


@pytest.mark.parametrize("name", suite_names())
def test_fingerprint_equals_the_reference_on_the_suite(name):
    mat, ref = generate(name), ref_matrices.generate(name)
    for schedule in ("paper", "auto"):
        assert pattern_fingerprint(mat, schedule) == \
            ref_serve.pattern_fingerprint(ref, schedule)
    assert serve._values_crc(mat) == ref_serve._values_crc(ref)


def _cache_counts(cache):
    return {e.name: (e.hits, e.disk_hits, e.compiles, e.value_refreshes, e.disk_corrupt)
            for e in cache.entries.values()}, (cache.hits, cache.misses, cache.evictions)


def test_lru_eviction_order_and_hits():
    def scenario(pkg):
        g = pkg.matrices.generate
        a, b, c = g("band_cz"), g("chem_bp"), g("ckt_fpga")
        fp = pkg.serve.pattern_fingerprint
        cache = pkg.serve.ProgramCache(capacity=2)
        pa, pb = cache.get(a), cache.get(b)
        assert cache.fingerprints() == [fp(a), fp(b)]
        assert cache.get(a) is pa
        cache.get(c)
        assert cache.fingerprints() == [fp(a), fp(c)] and cache.evictions == 1
        assert cache.get(b) is not pb
        assert cache.entries[fp(b)].compiles == 2 and cache.entries[fp(b)].hits == 0
        ea = cache.entries[fp(a)]
        assert ea.hits == 1 and ea.compiles == 1 and ea.compile_seconds > 0.0
        return _cache_counts(cache), cache.fingerprints()
    assert scenario(PORT) == scenario(REF)


def test_capacity_one_thrash_memory_only():
    def scenario(pkg):
        a, b = pkg.matrices.generate("band_cz"), pkg.matrices.generate("chem_bp")
        cache = pkg.serve.ProgramCache(capacity=1)
        for _ in range(2):
            cache.get(a)
            cache.get(b)
        assert len(cache) == 1 and cache.evictions == 3
        assert cache.hits == 0 and cache.misses == 4
        return _cache_counts(cache)
    assert scenario(PORT) == scenario(REF)


def test_capacity_one_thrash_disk_tier_rehydrates(tmp_path):
    def scenario(pkg):
        a, b = pkg.matrices.generate("band_cz"), pkg.matrices.generate("chem_bp")
        cache = pkg.serve.ProgramCache(capacity=1, disk_dir=tmp_path / pkg.serve.__name__)
        for _ in range(3):
            cache.get(a)
            cache.get(b)
        counts = _cache_counts(cache)
        assert counts[0] == {"band_cz": (0, 2, 1, 0, 0), "chem_bp": (0, 2, 1, 0, 0)}
        return counts, sorted(p.name for p in (tmp_path / pkg.serve.__name__).iterdir())
    assert scenario(PORT) == scenario(REF)


def test_disk_rehydrate_equals_in_memory_program(tmp_path):
    a = generate("band_cz")
    cache = ProgramCache(capacity=1, disk_dir=tmp_path)
    pa = cache.get(a)
    cache.get(generate("chem_bp"))
    ra = cache.get(a)
    assert ra is not pa
    assert (ra.n, ra.num_slots, ra.config) == (pa.n, pa.num_slots, pa.config)
    for f in ("instr", "val_idx", "stream"):
        np.testing.assert_array_equal(getattr(ra, f), getattr(pa, f))
    bb = np.random.default_rng(9).standard_normal(a.n)
    np.testing.assert_array_equal(api.solve(ra, bb, **CPU), api.solve(pa, bb, **CPU))


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_disk_tier_cross_loads_between_the_packages(tmp_path, writer, reader):
    """A disk tier written by one package rehydrates in the other: the same
    file names, no compile, the same program arrays."""
    names = ("band_cz", "chem_bp")
    wcache = writer.serve.ProgramCache(disk_dir=tmp_path)
    wprogs = [wcache.get(writer.matrices.generate(n)) for n in names]
    files = sorted(p.name for p in tmp_path.iterdir())
    rcache = reader.serve.ProgramCache(disk_dir=tmp_path)
    for name, wp in zip(names, wprogs):
        mat = reader.matrices.generate(name)
        fp = reader.serve.pattern_fingerprint(mat)
        assert f"{fp}.{reader.serve._values_crc(mat):08x}.prog" in files
        rp = rcache.get(mat)
        ent = rcache.entries[fp]
        assert (ent.disk_hits, ent.compiles) == (1, 0)
        for f in ("instr", "val_idx", "stream", "row_lo", "row_hi", "stream_src"):
            np.testing.assert_array_equal(getattr(rp, f), getattr(wp, f))
    assert sorted(p.name for p in tmp_path.iterdir()) == files


def test_corrupt_disk_entry_degrades_to_recompile_with_incident(tmp_path):
    def scenario(pkg):
        disk = tmp_path / pkg.serve.__name__
        a = pkg.matrices.generate("band_cz")
        cache = pkg.serve.ProgramCache(capacity=1, disk_dir=disk)
        cache.get(a)
        (blob,) = disk.glob("*.prog")
        raw = bytearray(blob.read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        blob.write_bytes(bytes(raw))
        cache.get(pkg.matrices.generate("chem_bp"))
        prog = cache.get(a)
        ent = cache.entries[pkg.serve.pattern_fingerprint(a)]
        assert ent.disk_corrupt == 1 and ent.compiles == 2
        inc = cache.incidents[-1]
        assert (inc.stage, inc.kind, inc.error) == \
            ("program-cache", "disk-corrupt", "ProgramCorruptionError")
        if pkg is PORT:
            b = np.random.default_rng(10).standard_normal(a.n)
            np.testing.assert_allclose(api.solve(prog, b, **CPU), api.reference_solve(a, b),
                                       rtol=1e-4, atol=1e-4)
        cache.get(pkg.matrices.generate("chem_bp"))
        assert cache.get(a) is not prog and ent.disk_corrupt == 1
        return _cache_counts(cache), inc.message.split(": ", 1)[1]
    assert scenario(PORT) == scenario(REF)


def test_same_pattern_new_values_is_a_values_refresh(tmp_path):
    a = generate("band_cz")
    a2 = dataclasses.replace(a, values=a.values * 1.5)
    cache = ProgramCache(capacity=2, disk_dir=tmp_path)
    p1 = cache.get(a)
    p2 = cache.get(a2)
    assert p1 is not p2
    fp = pattern_fingerprint(a)
    assert cache.entries[fp].compiles == 1 and cache.entries[fp].value_refreshes == 1
    assert cache.misses == 2 and cache.value_refreshes == 1
    assert p2.instr is p1.instr and p2.stream is not p1.stream
    assert len(list(tmp_path.glob(f"{fp}.*.prog"))) == 2
    b = np.random.default_rng(11).standard_normal(a.n)
    np.testing.assert_allclose(api.solve(p2, b, **CPU), api.reference_solve(a2, b),
                               rtol=1e-4, atol=1e-4)
    ref_a2 = dataclasses.replace(ref_matrices.generate("band_cz"), values=a2.values)
    np.testing.assert_array_equal(p2.stream, ref_api.compile(ref_a2).stream)


def test_values_refresh_disk_blob_rehydrates(tmp_path):
    a = generate("band_cz")
    a2 = dataclasses.replace(a, values=a.values * 2.0)
    cache = ProgramCache(capacity=2, disk_dir=tmp_path)
    cache.get(a)
    cache.get(a2)
    cold = ProgramCache(capacity=2, disk_dir=tmp_path)
    cold.get(a2)
    fp = pattern_fingerprint(a)
    assert cold.entries[fp].compiles == 0 and cold.entries[fp].disk_hits == 1


def test_cache_rejects_zero_capacity():
    with pytest.raises(ValueError, match="capacity"):
        ProgramCache(capacity=0)


def test_load_program_corruption_error_type(tmp_path):
    path = tmp_path / "junk.prog"
    path.write_bytes(b"not a program")
    with pytest.raises(ProgramCorruptionError):
        api.load_program(path)


# ------------------------------------------------------- api.make_service
def test_make_service_defaults_and_disk_tier(tmp_path):
    def scenario(pkg):
        mats = _mats(pkg)
        clock = pkg.serve.ManualClock()
        svc = pkg.api.make_service(mats, capacity=1, disk_dir=tmp_path / pkg.serve.__name__,
                                   max_batch=2, max_delay=0.5, clock=clock, **pkg.opts)
        assert svc.backend == pkg.backend
        rng = np.random.default_rng(12)
        ta = svc.submit("a", rng.standard_normal((mats["a"].n, 2)))
        tb = svc.submit("b", rng.standard_normal((mats["b"].n, 2)))
        assert ta.done and tb.done
        tc = svc.submit("a", rng.standard_normal(mats["a"].n))
        clock.advance(0.5)
        svc.pump()
        assert tc.done
        ent = svc.cache.entries[pkg.serve.pattern_fingerprint(mats["a"])]
        assert (ent.disk_hits, ent.compiles) == (1, 1)
        return _log(svc, [ta, tb, tc]), [t.result() for t in (ta, tb, tc)]
    _twin(scenario)


# --------------------------------------------------- the port's own rules
class DeviceOnly(torch.Tensor):
    """A tensor that, like one on a CUDA device, refuses ``np.asarray``."""

    def __array__(self, *args, **kwargs):
        raise TypeError("can't convert cuda:0 device type tensor to numpy")


@pytest.mark.parametrize("resilient", [False, True])
def test_device_tensor_answers_cross_to_the_host(mats, resilient):
    """Every flush's answer crosses to the host explicitly: a solver that
    returns a device tensor delivers, with no incident and on the entry
    rung — not a failed rung per flush and answers from numpy."""
    clock = ManualClock()
    res = ResilienceConfig(retry=RetryPolicy(max_retries=0)) if resilient else None
    svc = make_svc(PORT, clock, backend="cuda", resilience=res)
    if resilient:
        orig = svc._stage_solver
        svc._stage_solver = lambda *a: (lambda fn: lambda b: fn(b).as_subclass(
            DeviceOnly))(orig(*a))
    else:
        orig = svc._solver
        svc._solver = lambda *a: (lambda fn: lambda b: fn(b).as_subclass(DeviceOnly))(
            orig(*a))
    with pytest.raises(TypeError, match="cuda"):
        np.asarray(torch.zeros(2).as_subclass(DeviceOnly))
    b = np.random.default_rng(13).standard_normal((mats["a"].n, 3))
    t = svc.submit("a", b)
    svc.drain()
    assert t.done and not t.failed and len(svc.incidents) == 0
    assert svc.stats.flushes[-1].stage == ("cuda-blocked" if resilient else "")
    assert type(t.result()) is np.ndarray
    prog = svc.cache.get(mats["a"])
    np.testing.assert_array_equal(t.result(), api.solve_batch(prog, b, backend="cuda",
                                                              **CPU))


def test_no_cuda_raises_at_construction(mats):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    for backend in ("cuda", "torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            SolveService(backend=backend)
        with pytest.raises(RuntimeError, match="CUDA"):
            api.make_service(mats, backend=backend, resilience=ResilienceConfig())
    svc = SolveService(backend="numpy", resilience=ResilienceConfig())
    assert svc.device is None and svc._ladder == ("numpy", "reference")


def test_resilient_ladder_by_entry_rung():
    assert SolveService(backend="cuda", resilience=ResilienceConfig(), **CPU)._ladder == \
        ("cuda-blocked", "cuda-resident", "torch", "numpy", "reference")
    assert SolveService(backend="torch", resilience=ResilienceConfig(), **CPU)._ladder == \
        ("torch", "numpy", "reference")


# ------------------------------------------------------------ interleavings
_TINY = [(40, 6, 0.6, 101, "tiny_a"), (56, 8, 0.5, 102, "tiny_b"),
         (64, 5, 0.5, 103, "tiny_c")]
_IDS = ["m0", "m1", "m2", "m0dup"]


def _interleaving(pkg, backend, steps, cache):
    mats = [pkg.matrices.banded(*spec) for spec in _TINY]
    by_id = {"m0": mats[0], "m1": mats[1], "m2": mats[2], "m0dup": mats[0]}
    clock = pkg.serve.ManualClock()
    opts = pkg.opts if backend != "numpy" else {}
    svc = pkg.serve.SolveService(cache, max_batch=8, max_delay=1.0, clock=clock,
                                 backend=backend, **opts)
    for mid in _IDS:
        svc.register(mid, by_id[mid])
    submitted = []
    for tenant, width, advance, seed in steps:
        clock.advance(advance)
        mid = _IDS[tenant]
        bmat = np.random.default_rng(seed).standard_normal((by_id[mid].n, width))
        submitted.append((svc.submit(mid, bmat), mid, bmat))
    svc.drain()
    return svc, by_id, submitted


def _steps(seed, n):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(4)), int(rng.integers(1, 34)),
             [0.0, 0.4, 1.2][int(rng.integers(3))], int(rng.integers(2 ** 31)))
            for _ in range(n)]


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("seed", range(8))
def test_interleavings_match_per_request_oracle(backend, seed):
    """Every routed result equals the per-request solve of the same column
    through the same backend, bit for bit; the executor cache stages at
    most once per (program, padded width); the flush log equals the
    reference's on the same interleaving."""
    steps = _steps(seed, 6)
    cache = ProgramCache(capacity=8)
    before = executor.trace_count()
    svc, by_id, submitted = _interleaving(PORT, backend, steps, cache)
    total = 0
    for ticket, mid, bmat in submitted:
        prog = svc.cache.get(by_id[mid])
        got = ticket.result()
        assert ticket.done and got.shape == bmat.shape
        want = (api.solve_numpy(prog, bmat) if backend == "numpy" else
                api.solve_batch(prog, np.asarray(bmat, np.float32), **CPU))
        assert np.array_equal(got, want), mid
        total += bmat.shape[1]
    assert svc.stats.completed_columns == total == svc.stats.columns
    assert sum(f.columns for f in svc.stats.flushes) == total
    pairs = {(id(svc.cache.get(by_id[f.matrix_id])), f.padded) for f in svc.stats.flushes}
    pairs |= {(id(svc.cache.get(by_id[mid])), executor.pad_batch(b.shape[1]))
              for _, mid, b in submitted}
    assert all(f.padded == executor.pad_batch(f.columns) for f in svc.stats.flushes)
    delta = executor.trace_count() - before
    assert delta == 0 if backend == "numpy" else delta <= len(pairs)
    # the duplicate tenant shares m0's compile
    assert cache.entries[pattern_fingerprint(by_id["m0"])].compiles <= 1
    ref_svc, _, ref_submitted = _interleaving(
        REF, {"torch": "jax"}.get(backend, backend), steps, ref_serve.ProgramCache(capacity=8))
    assert _log(svc, [t for t, _, _ in submitted]) == \
        _log(ref_svc, [t for t, _, _ in ref_submitted])
    for (t, _, _), (rt, _, _) in zip(submitted, ref_submitted):
        np.testing.assert_allclose(t.result(), np.asarray(rt.result()), **TOL)


def test_batched_columns_bit_identical_to_single_solves(mats):
    """No executor mixes columns: a column solved in a padded batch of 16
    equals its solve alone, on the torch and the cuda backend."""
    prog = ProgramCache().get(mats["b"])
    b = np.random.default_rng(14).standard_normal((mats["b"].n, 13))
    for backend in ("torch", "cuda"):
        x = api.solve_batch(prog, b, backend=backend, **CPU)
        for j in (0, 6, 12):
            np.testing.assert_array_equal(
                x[:, j], api.solve_batch(prog, b[:, j], backend=backend, **CPU)[:, 0])
    assert ref_executor.pad_batch(13) == executor.pad_batch(13) == 16
