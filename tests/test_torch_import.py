"""The port stands alone: `repro_torch` imports neither jax nor `repro`.

Also pins the device rule: with no ``device`` argument the port runs on
CUDA, so a machine without CUDA raises instead of running on the CPU.
"""

import ast
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
ENTRY_POINTS = [REPO / "examples" / f"torch_{name}.py"
                for name in ("ssm_as_sptrsv", "serve_batch", "train_lm")] + [
    REPO / "scripts" / "torch_lint_program.py"]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "examples" / "torch_quickstart.py",
    REPO / "tests" / "test_torch_cuda.py", REPO / "tests" / "torch_strategies.py",
] + ENTRY_POINTS
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "from repro_torch.core import api, executor\n"
        "from repro_torch.core import analysis, fine, robust, serialize, transform\n"
        "from repro_torch.core import resilience, serve\n"
        "from repro_torch.core.frontends import dagcirc, upper\n"
        "from repro_torch.kernels.sptrsv import kernel, ops, ref\n"
        "from repro_torch.kernels.ssd_scan import kernel, ops, ref\n"
        "from repro_torch.kernels.flash_attention import kernel, ops, ref\n"
        "import repro_torch.models, repro_torch.models.convert\n"
        "import repro_torch.launch.serve, repro_torch.configs\n"
        "import repro_torch.launch.train, repro_torch.launch.steps\n"
        "from repro_torch import optim, data, distributed, checkpoint\n"
        "from repro_torch.optim import adamw, clip, schedules\n"
        "from repro_torch.distributed import elastic, fault_tolerance, sharding\n"
        "from repro_torch.launch import dryrun, hlo_analysis, mesh, roofline, shapes\n"
        "import torch.distributed as dist\n"
        "assert not dist.is_initialized()  # importing them starts no process group\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(source: str) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path.read_text()) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"kernel.py", "ops.py", "executor.py", "api.py", "chip_smoke.py",
            "mamba2.py", "model.py", "convert.py", "serve.py", "serialize.py",
            "robust.py", "transform.py", "fine.py", "dagcirc.py", "upper.py",
            "contracts.py", "hazards.py", "resilience.py",
            "torch_quickstart.py", "adamw.py", "clip.py", "schedules.py",
            "pipeline.py", "elastic.py", "fault_tolerance.py", "checkpoint.py",
            "steps.py", "train.py", "sharding.py", "mesh.py", "shapes.py", "dryrun.py",
            "hlo_analysis.py", "roofline.py", "torch_ssm_as_sptrsv.py",
            "torch_serve_batch.py", "torch_train_lm.py", "torch_lint_program.py",
            "test_torch_cuda.py", "torch_strategies.py"} <= names


def _smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_conformance_step_needs_the_card_and_no_reference(monkeypatch):
    """`chip_smoke.py` step 35's process imports neither jax nor `repro`
    (its source, and what it loaded while pytest ran the card's tests), and
    a run in which the tests skip, as they do here, fails the step."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the tests run instead of skipping")
    smoke = _smoke()
    assert not _imported_roots(smoke.CONFORMANCE) & set(FORBIDDEN)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", smoke.CONFORMANCE], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["reference_modules"] == []
    assert (summary["rc"], summary["passed"], summary["failed"]) == (0, 0, 0)
    assert summary["skipped"] > 100
    assert set(summary["launches"].values()) == {0}
    assert set(summary["worst"]) == set(summary["launches"])
    monkeypatch.setattr(smoke.subprocess, "run", lambda *a, **kw: out)
    with pytest.raises(AssertionError, match="skipped"):
        smoke.conformance_phase()


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device runs")
    from repro_torch.core import api
    from repro_torch.kernels.common import resolve_device

    prog = api.compile(api.matrix("band_cz"))
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_solver(prog, batch=4, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        api.make_solver(prog, batch=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.solve(prog, np.zeros(prog.n))
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)

    from repro_torch.launch import serve

    with pytest.raises(RuntimeError, match="CUDA"):
        serve.setup(serve.parse_args(["--reduced"]))

    from repro_torch.launch import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1"])


def test_reused_library_keeps_its_compiler_output(tmp_path, monkeypatch):
    """A library built once and reused in a later process still reports the
    compiler's output (ptxas registers and spills), read from its ``.log``."""
    from repro_torch.kernels import common

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "echo lib > \"$2\"\n"
                    "echo \"ptxas info    : Used 40 registers\"\n")
    fake.chmod(0o755)
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    monkeypatch.setattr(common, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(common, "BUILD_LOGS", {})
    path = common.build_library("k", src)
    assert path.exists() and "Used 40 registers" in common.BUILD_LOGS["k"]
    common.BUILD_LOGS.clear()  # a later process: the library is reused, not built
    monkeypatch.setattr(common, "_nvcc", lambda: pytest.fail("rebuilt"))
    assert common.build_library("k", src) == path
    assert "Used 40 registers" in common.BUILD_LOGS["k"]


def test_build_seconds_count_builds_that_overlap_once(tmp_path, monkeypatch):
    """Two libraries built in one call share the call's wall time: their
    `BUILD_SECONDS` add up to no more than it, though each ``nvcc`` took
    about all of it."""
    from repro_torch.kernels import common

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nsleep 1\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "echo lib > \"$2\"\n")
    fake.chmod(0o755)
    srcs = {}
    for name in ("a", "b"):
        srcs[name] = tmp_path / f"{name}.cu"
        srcs[name].write_text(f"// kernel {name}\n")
    monkeypatch.setattr(common, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(common, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(common, "BUILD_LOGS", {})
    monkeypatch.setattr(common, "BUILD_SECONDS", {})
    t0 = time.perf_counter()
    common.build_libraries(srcs)
    wall = time.perf_counter() - t0
    secs = dict(common.BUILD_SECONDS)
    assert secs.keys() == {"a", "b"} and min(secs.values()) >= 0.0
    assert 1.0 <= sum(secs.values()) <= wall
    common.build_libraries(srcs)               # found built: keeps its seconds
    assert common.BUILD_SECONDS == secs


def test_quickstart_runs_on_the_cpu():
    """`examples/torch_quickstart.py` needs only the port: with jax blocked
    and ``--device cpu`` it walks compile → make_solver → robust_solver →
    make_service on the kernels' plain versions."""
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.argv = ['torch_quickstart.py', '--device', 'cpu']\n"
        "runpy.run_path('examples/torch_quickstart.py', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "robust_solver: answered on cuda-blocked, incidents []" in out.stdout
    assert "make_service: 1 flush of 8 columns (full)" in out.stdout
    assert "row-blocked solve: window=" in out.stdout
    assert "cycles: coarse=398 fine=555 medium=254" in out.stdout


# each entry point's run with jax blocked: its argv, and what it must print
ENTRY_RUNS = {
    "torch_ssm_as_sptrsv.py": (["--device", "cpu"], "fine   == coarse: True"),
    "torch_serve_batch.py": (["--device", "cpu"], "OK"),
    "torch_train_lm.py": (["--tiny", "--device", "cpu", "--ckpt-dir", "{tmp}"],
                          "OK: loss decreased"),
    "torch_lint_program.py": (["--matrix", "ckt_rajat04", "--schedule", "paper",
                               "--frontier"], "SPT208"),
}


@pytest.mark.parametrize("path", ENTRY_POINTS, ids=lambda p: p.name)
def test_entry_point_runs_with_jax_blocked(path, tmp_path):
    """Each new example and the lint CLI need only the port: imported from
    its path with jax blocked and its ``main`` called on the CPU (the SSM
    example at a small size), it finishes and imports nothing of `repro`."""
    argv, want = ENTRY_RUNS[path.name]
    code = (
        "import importlib.util, sys\n"
        "sys.modules['jax'] = None\n"
        f"spec = importlib.util.spec_from_file_location('entry', {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "if hasattr(mod, 'SIZES'):\n"
        "    mod.SIZES = (2, 256, 2, 8, 8)\n"
        f"out = mod.main({[a.format(tmp=tmp_path) for a in argv]!r})\n"
        "assert out == 0 or isinstance(out, dict), out\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
    )
    # one thread: the suite's workers share the cores, and these models are tiny
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert want in out.stdout
