"""The port stands alone: `repro_torch` imports neither jax nor `repro`.

Also pins the device rule: with no ``device`` argument the port runs on
CUDA, so a machine without CUDA raises instead of running on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def test_import_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "from repro_torch.core import api, executor\n"
        "from repro_torch.core import analysis, fine, robust, serialize, transform\n"
        "from repro_torch.core.frontends import dagcirc, upper\n"
        "from repro_torch.kernels.sptrsv import kernel, ops, ref\n"
        "from repro_torch.kernels.ssd_scan import kernel, ops, ref\n"
        "from repro_torch.kernels.flash_attention import kernel, ops, ref\n"
        "import repro_torch.models, repro_torch.models.convert\n"
        "import repro_torch.launch.serve, repro_torch.configs\n"
        "bad = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = _imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"kernel.py", "ops.py", "executor.py", "api.py", "chip_smoke.py",
            "mamba2.py", "model.py", "convert.py", "serve.py", "serialize.py",
            "robust.py", "transform.py", "fine.py", "dagcirc.py", "upper.py",
            "contracts.py", "hazards.py"} <= names


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
