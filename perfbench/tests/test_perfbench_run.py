"""Whole runs of the harness on the CPU (the kernels' plain versions, the
small configurations of ``data/``): the result line, what the process
loads and opens, and ``correct`` coming out false with the timed path
broken underneath or the control in the program's place."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, reference
from perfbench.tests.helpers import cells, cpu_spec, run_cpu
from repro_torch.core import api
from repro_torch.core.serve import SolveService
from repro_torch.kernels.sptrsv import ops

ROOT = harness.ROOT
# every cell of BENCHMARK.json; the loop-specific faults go to the cells
# whose traffic that loop runs
CELLS = cells()
SOLVE1 = cells("solve1")
SERVE = cells("serve")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_untraced(cell):
    r = run_cpu(cell)
    assert list(r) == KEYS + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"]: m["unit"]
            for m in harness.cell_metrics(harness.load_spec(), cell, False)}
    assert {k: v["unit"] for k, v in r["metrics"].items()} == want
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_traced(cell):
    r = run_cpu(cell, trace=True)
    assert list(r) == KEYS + ["breakdown", "checks"]
    names = {m["name"] for m in harness.cell_metrics(harness.load_spec(),
                                                     cell, True)}
    assert set(r["metrics"]) <= names
    # on the CPU no device operation runs: the device's readers are silent
    assert "compile_s" in r["metrics"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    bd = r["breakdown"]
    assert set(bd) == {"device_ops", "idle_gaps"}
    assert len(bd["device_ops"]) <= 10 and 1 <= len(bd["idle_gaps"]) <= 10


def _break_kernels(monkeypatch, fn):
    """Route both SpTRSV kernels' answers through ``fn(b, x)``."""
    for name in ("sptrsv_cuda", "sptrsv_cuda_blocked"):
        orig = getattr(ops, name)
        monkeypatch.setattr(ops, name, lambda *a, _o=orig, **k: fn(a[2], _o(*a, **k)))


@pytest.mark.parametrize("cell", CELLS)
def test_state_unchanged_is_not_correct(cell, monkeypatch):
    _break_kernels(monkeypatch, lambda b, x: b.clone())
    r = run_cpu(cell)
    assert r["correct"] is False
    assert r["checks"]["max_rel_err"]["value"] > r["checks"]["max_rel_err"]["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_altered_answer_is_not_correct(cell, monkeypatch):
    def alter(b, x):
        x = x.clone()
        x[x.shape[0] // 2] += 1e-3 * x.abs().amax(dim=0)
        return x

    _break_kernels(monkeypatch, alter)
    r = run_cpu(cell)
    assert r["correct"] is False
    assert r["checks"]["max_rel_err"]["value"] > r["checks"]["max_rel_err"]["limit"]


@pytest.mark.parametrize("cell", SERVE)
def test_an_unanswered_request_is_not_correct(cell, monkeypatch):
    # flushes only when a bucket fills: the last columns are never answered
    monkeypatch.setattr(SolveService, "pump", lambda self, now=None: 0)
    r = run_cpu(cell, traffic={"tail_wait_s": 0.1})
    assert r["correct"] is False
    assert r["checks"]["missing"]["value"] > 0
    assert r["checks"]["missing"]["value"] > r["checks"]["missing"]["limit"]


@pytest.mark.parametrize("cell", SOLVE1)
def test_an_answer_kept_from_an_earlier_call_is_not_correct(cell, monkeypatch):
    # a result cache keyed on the right-hand side's address
    orig = api.make_solver

    def cached(*a, **kw):
        solve, memo = orig(*a, **kw), {}

        def f(b):
            key = np.asarray(b).__array_interface__["data"][0]
            if key not in memo:
                memo[key] = solve(b).clone()
            return memo[key]

        return f

    monkeypatch.setattr(api, "make_solver", cached)
    r = run_cpu(cell)
    assert r["correct"] is False
    assert r["checks"]["max_rel_err"]["value"] > r["checks"]["max_rel_err"]["limit"]


@pytest.mark.parametrize("cell", SERVE)
def test_half_of_a_flush_left_out_is_not_correct(cell, monkeypatch):
    orig = SolveService._solver

    def half(self, prog, k):
        solve = orig(self, prog, k)

        def f(bmat):
            x = solve(bmat).clone()
            x[:, k // 2:] = 0.0
            return x

        return f

    monkeypatch.setattr(SolveService, "_solver", half)
    r = run_cpu(cell)
    assert r["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_bfloat16_control_in_the_programs_place_is_not_correct(cell, monkeypatch):
    spec = cpu_spec()
    parts = harness.resolve(spec, cell)
    system = harness.load_module(parts["builder"]).build(parts["config"], 7)

    def control(prog, batch=None, **kw):
        def solve(b):
            b = np.asarray(b, dtype=np.float64)
            x = reference.solve_lowered(*system.ref, b)
            return torch.from_numpy(x.astype(np.float32))

        return solve

    monkeypatch.setattr(api, "make_solver", control)
    r = run_cpu(cell, seed=7, spec=spec)
    assert r["correct"] is False
    assert r["checks"]["max_rel_err"]["value"] > r["checks"]["max_rel_err"]["limit"]


DRY_RUN = r"""
import json, sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0]))
                 if ev == "open" and isinstance(args[0], str) else None)
from perfbench import harness
from perfbench.tests.helpers import cells, run_cpu
for cell in cells():
    for trace in (False, True):
        run_cpu(cell, trace=trace, seconds=0.2)
print(json.dumps({"forbidden": harness.forbidden_modules(),
                  "top": sorted({m.split(".")[0] for m in sys.modules}),
                  "opened": opened}))
"""


def test_dry_run_loads_no_jax_and_reads_no_reference_benchmark():
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(ROOT), str(ROOT / "src")])}
    out = subprocess.run([sys.executable, "-c", DRY_RUN], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert "repro_torch" in got["top"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["top"])
    for path in got["opened"]:
        p = Path(path)
        rel = p.resolve().relative_to(ROOT) if p.resolve().is_relative_to(
            ROOT) else None
        if rel is not None:
            assert rel.parts[0] not in ("benchmarks", "chip_smoke.py"), path
            assert not rel.name.startswith("BENCH_"), path


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    # a stand-in module table: other test files of this process load jax
    names = {"repro_torch.core.api": sys, "repro_torch": sys,
             "jaxtyping_like.sub": sys, "numpy": sys}
    monkeypatch.setattr(sys, "modules", dict(names))
    assert harness.forbidden_modules() == []
    monkeypatch.setattr(sys, "modules", {**names, "repro.core": sys,
                                         "jax._src": sys})
    assert harness.forbidden_modules() == ["jax", "repro"]


def test_without_a_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cmd = [sys.executable, "perfbench/run.py", "--workload", "band64k.solve1",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "ckt32k.serve",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_band64k_solve1_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cmd = [sys.executable, "perfbench/run.py", "--workload", "band64k.solve1",
           "--seed", str(2**31 + 77), "--seconds", "2", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True and r["device"]["platform"] == "gpu"
    assert {"setup_s", "latency_p50_ms.solve_band", "latency_p95_ms.solve_band",
            "columns_per_s.solve_band"} == set(r["metrics"])
