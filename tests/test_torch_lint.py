"""The source lint guard (`scripts/check_lint.py`) over the port.

The counterpart of `tests/test_lint.py`, which covers ``src/repro/core``
and ``scripts``: the same rules (F401/E501/W291/W293/E722) over the whole
of ``src/repro_torch``, and over the port's files outside it (the card's
smoke, the examples, the port's tests and their helpers).
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import check_lint  # noqa: E402

OUTSIDE_SRC = sorted(
    [REPO / "chip_smoke.py", REPO / "tests" / "torch_strategies.py",
     REPO / "tests" / "torch_mesh_workers.py"]
    + list((REPO / "examples").glob("torch_*.py"))
    + list((REPO / "scripts").glob("torch_*.py"))
    + list((REPO / "tests").glob("test_torch_*.py")))


def test_port_sources_lint_clean(capsys):
    rc = check_lint.main([str(REPO / "src" / "repro_torch")])
    out = capsys.readouterr().out
    assert rc == 0, f"lint problems:\n{out}"


@pytest.mark.parametrize("path", OUTSIDE_SRC, ids=lambda p: str(p.relative_to(REPO)))
def test_port_files_outside_src_lint_clean(path, capsys):
    rc = check_lint.main([str(path)])
    assert rc == 0, f"lint problems:\n{capsys.readouterr().out}"
