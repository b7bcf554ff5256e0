"""The port's column sharding (`repro_torch.core.shard`) on the CPU.

A `BatchMesh` may name one device more than once, so meshes of 1 to 3
``cpu`` entries run the whole split: padding to ``ndev * pad_batch(ceil(B
/ ndev))``, one column block per entry, one per-device executor each,
the gather onto the first entry.  Every sharded column is held within
1e-5 of the float64 program oracle (`execute_numpy`), as the reference's
`tests/test_sharded.py` does (the reference's own sharded path fails on
this tree, so it is not the yardstick); both backends run, ``"cuda"`` on
its plain twins.  `sharded_widths` is a pure function and is compared
with the reference's directly.
"""

import types

import numpy as np
import pytest
import torch

from repro.core import shard as ref_shard
from repro_torch.core import api, executor, shard
from repro_torch.core.executor import execute_numpy
from repro_torch.core.serve import ManualClock, SolveService

CPU = {"device": "cpu"}
BACKENDS = {"torch": {}, "cuda": {"placement": "resident"},
            "cuda-blocked": {"placement": "blocked", "cycles_per_block": 64}}


def _kind(backend):
    return backend.split("-")[0]


def _mesh(n):
    return shard.batch_mesh(devices=("cpu",) * n)


def _rel_close(got, ref, tol=1e-5):
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * np.abs(ref).max())


@pytest.fixture(scope="module")
def prog():
    return api.compile(api.matrix("band_cz"))


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("ndev", [1, 2, 3])
@pytest.mark.parametrize("B", [1, 5, 8])
def test_sharded_columns_match_numpy_oracle(prog, backend, ndev, B):
    bmat = np.random.default_rng(B + 10 * ndev).standard_normal((prog.n, B))
    got = api.solve_batch(prog, bmat, mesh=_mesh(ndev), backend=_kind(backend),
                          **BACKENDS[backend])
    assert got.shape == (prog.n, B)
    ref = execute_numpy(prog, bmat)
    for j in range(B):
        _rel_close(got[:, j], ref[:, j])


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_sharded_columns_equal_the_unsharded_solve(prog, backend):
    """Columns are independent, so the split changes no bit."""
    bmat = np.random.default_rng(1).standard_normal((prog.n, 7)).astype(np.float32)
    opts = BACKENDS[backend]
    want = api.make_solver(prog, batch=7, backend=_kind(backend), **opts, **CPU)(bmat)
    got = api.make_solver(prog, batch=7, mesh=_mesh(3), backend=_kind(backend),
                          **opts)(bmat)
    assert got.device.type == "cpu"
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("ndev", [1, 2, 3, 5])
@pytest.mark.parametrize("B", [0, 1, 2, 5, 7, 8, 9, 16, 17, 40])
def test_sharded_widths_equal_the_reference(ndev, B):
    mesh = _mesh(ndev)
    want = ref_shard.sharded_widths(B, types.SimpleNamespace(size=ndev))
    assert shard.sharded_widths(B, mesh) == want
    w_local, width = want
    blocks = shard.rhs_blocks(width, mesh)
    assert [b.stop - b.start for b in blocks] == [w_local] * ndev
    assert blocks[-1].stop == width


def test_sharded_cache_is_reused_not_restaged(prog):
    mesh = _mesh(2)
    rng = np.random.default_rng(2)
    # B = 9..16 all pad to 8 columns a device: one sharded solver, one
    # staged executor for the device both entries name
    assert len({shard.sharded_widths(b, mesh) for b in (9, 12, 16)}) == 1
    api.solve_batch(prog, rng.standard_normal((prog.n, 9)), mesh=mesh)
    before = executor.trace_count()
    entries = len(shard._SHARD_CACHE[prog])
    for b in (9, 12, 16):
        api.solve_batch(prog, rng.standard_normal((prog.n, b)), mesh=mesh)
        api.make_solver(prog, batch=b, mesh=mesh)
    assert executor.trace_count() == before
    assert len(shard._SHARD_CACHE[prog]) == entries
    # another mesh is another cache entry, over the same staged executor
    api.solve_batch(prog, rng.standard_normal((prog.n, 9)), mesh=_mesh(1))
    assert len(shard._SHARD_CACHE[prog]) == entries + 1
    assert executor.trace_count() == before + 1   # width 16 on the one device


def test_make_solver_mesh_requires_a_batch(prog):
    with pytest.raises(ValueError, match="explicit batch size"):
        api.make_solver(prog, mesh=_mesh(2))
    with pytest.raises(ValueError, match="explicit batch size"):
        api.make_solver(prog, mesh=_mesh(1), backend="cuda")


def test_mesh_argument_rules(prog):
    with pytest.raises(TypeError, match="BatchMesh"):
        api.make_solver(prog, batch=2, mesh=("cpu", "cpu"))
    with pytest.raises(ValueError, match="device="):
        api.make_solver(prog, batch=2, mesh=_mesh(2), device="cpu")
    with pytest.raises(ValueError, match="negative"):
        shard.make_sharded_solver(prog, -1, _mesh(1))
    with pytest.raises(ValueError, match="at least one"):
        shard.batch_mesh(devices=())
    with pytest.raises(ValueError, match="not both"):
        shard.batch_mesh(2, devices=("cpu",))
    solver = api.make_solver(prog, batch=3, mesh=_mesh(2))
    with pytest.raises(ValueError, match="shape"):
        solver(np.zeros((prog.n, 4)))
    assert solver(np.zeros((prog.n, 3))).shape == (prog.n, 3)
    assert api.make_solver(prog, batch=0, mesh=_mesh(2))(
        np.zeros((prog.n, 0))).shape == (prog.n, 0)


def test_batch_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        assert shard.batch_mesh().size == torch.cuda.device_count()
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        shard.batch_mesh()


def test_mesh_is_hashable_and_keeps_order():
    a = shard.batch_mesh(devices=("cpu", torch.device("cpu")))
    assert a == shard.BatchMesh((torch.device("cpu"),) * 2) and hash(a) == hash(
        shard.BatchMesh(("cpu", "cpu")))
    assert a.size == 2 and all(isinstance(d, torch.device) for d in a.devices)


def test_sharded_placement_attribute(prog):
    s = api.make_solver(prog, batch=4, mesh=_mesh(2), backend="cuda",
                        placement="blocked", cycles_per_block=64)
    assert s.placement == "blocked"
    assert api.make_solver(prog, batch=4, mesh=_mesh(2)).placement is None


def test_uneven_padding_roundtrip(prog):
    mesh = _mesh(3)
    bmat = np.random.default_rng(4).standard_normal((prog.n, 7))
    got = api.solve_batch(prog, bmat, mesh=mesh)
    _rel_close(got, execute_numpy(prog, bmat))
    sub = api.solve_batch(prog, bmat[:, :3], mesh=mesh)
    np.testing.assert_array_equal(sub, got[:, :3])


def test_workloads_take_the_mesh():
    from repro_torch.core.csr import serial_solve, serial_solve_upper, transpose_upper

    mat = api.matrix("hub_small")
    prog, split = api.compile_split(mat, max_indegree=48)
    bmat = np.random.default_rng(5).standard_normal((mat.n, 6))
    got = api.solve_split(prog, split, bmat, mesh=_mesh(2), backend="cuda")
    ref = np.stack([serial_solve(mat, bmat[:, i]) for i in range(6)], axis=1)
    _rel_close(got, ref, 5e-4)
    u = transpose_upper(api.matrix("band_cz"))
    cw = api.compile_upper(u)
    b = np.random.default_rng(6).standard_normal((u.n, 5))
    got = cw.solve(b, mesh=_mesh(3))
    ref = np.stack([serial_solve_upper(u, b[:, i]) for i in range(5)], axis=1)
    _rel_close(got, ref)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_service_stream_on_a_mesh_equals_the_unsharded_one(backend):
    mats = {"a": api.matrix("band_cz"), "b": api.matrix("ckt_rajat04")}
    rng = np.random.default_rng(8)
    stream = [(("a", "b")[int(rng.integers(2))], int(rng.integers(1, 4)))
              for _ in range(20)]
    rhs = [rng.standard_normal((mats[m].n, k)) for m, k in stream]

    def run(**where):
        clock = ManualClock()
        svc = SolveService(backend=backend, clock=clock, max_batch=8, **where)
        for m, mat in mats.items():
            svc.register(m, mat)
        tickets = []
        for (m, _), b in zip(stream, rhs):
            tickets.append(svc.submit(m, b))
            clock.advance(4e-4)
            svc.pump()
        svc.drain()
        return svc, [t.result() for t in tickets]

    svc, got = run(mesh=_mesh(2))
    _, want = run(**CPU)
    assert svc.mesh == _mesh(2) and svc.device == torch.device("cpu")
    assert svc.stats.flush_count() > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    made = api.make_service(mats, backend=backend, mesh=_mesh(3), clock=ManualClock())
    t = made.submit("a", rhs[0] if stream[0][0] == "a" else np.ones(mats["a"].n))
    made.drain()
    assert t.done and np.isfinite(t.result()).all()


def test_resilient_service_on_a_mesh():
    from repro_torch.core.resilience import ResilienceConfig

    mat = api.matrix("band_cz")
    svc = SolveService(backend="cuda", mesh=_mesh(2), resilience=ResilienceConfig(),
                       clock=ManualClock())
    svc.register("a", mat)
    b = np.random.default_rng(9).standard_normal((mat.n, 5))
    t = svc.submit("a", b)
    svc.drain()
    _rel_close(t.result(), np.stack([api.reference_solve(mat, b[:, i])
                                     for i in range(5)], 1), 5e-5)
    assert svc.stats.flushes[-1].stage == "cuda-blocked"
