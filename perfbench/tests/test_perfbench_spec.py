"""BENCHMARK.json keeps to the benchmark's contract, and every cell finds
its configuration, traffic, loop, builder and metric files by name.

Each check takes the spec and the checkout's root as defaulted arguments
(pytest passes no fixture for them), so that a test can hold a spec with
entries added, in another directory, to the same checks
(`test_perfbench_new_config.py`)."""

import json
import re
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests import helpers

ROOT = harness.ROOT
SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
CONFIGS = [c["name"] for c in SPEC["configs"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(spec=SPEC, root=ROOT):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert (root / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_command_and_paths_stay_in_the_benchmark(spec=SPEC, root=ROOT):
    cmd, paths = spec["command"], spec["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert (root / p).is_dir()
    for word in cmd[1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in paths)


def test_names_units_and_enums(spec=SPEC):
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            assert (group, e["name"]) not in seen
            seen.add((group, e["name"]))
    metrics = spec["end_to_end"] + spec["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e


def test_configs_and_cells(spec=SPEC, root=ROOT):
    used = {w["config"] for w in spec["workloads"]}
    files = set()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        cfg = json.loads((root / c["file"]).read_text())
        assert cfg["name"] == c["name"] and len(c["reduced"]) <= 16
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs) <= 24
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(
        1, len(spec["workloads"]) // 4)


@pytest.mark.parametrize("config", CONFIGS)
def test_config_has_its_small_copy(config, spec=SPEC, root=ROOT):
    """``tests/data/<config>.json``, which the CPU tests run in the
    configuration's place: the same builder, generator kind and limits at
    a smaller ``n``."""
    entry = next(c for c in spec["configs"] if c["name"] == config)
    path = helpers.small_copy(config, root / helpers.DATA.relative_to(ROOT))
    assert path.is_file(), f"{config!r} has no small copy: add {path}"
    full = json.loads((root / entry["file"]).read_text())
    small = json.loads(path.read_text())
    assert small["name"] == config
    assert small["builder"] == full["builder"]
    assert small["generator"]["kind"] == full["generator"]["kind"]
    assert small["generator"]["args"]["n"] < full["generator"]["args"]["n"]
    assert small["limits"] == full["limits"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_every_file_by_name(cell, spec=SPEC, root=ROOT):
    parts = harness.resolve(spec, cell, root)
    for key in ("builder", "loop"):
        assert Path(parts[key]).is_file()
        harness.load_module(parts[key])
    for trace in (False, True):
        for m in harness.cell_metrics(spec, cell, trace):
            mod = harness.load_module(harness.reader_path(m["name"]))
            assert callable(mod.read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_what_the_contract_asks(cell, spec=SPEC):
    e2e = [m["name"] for m in harness.cell_metrics(spec, cell, False)]
    layer = harness.cell_metrics(spec, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e, (cell, m["name"])


def test_listed_workloads_exist(spec=SPEC):
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_shares_of_a_peak_are_percent(spec=SPEC):
    for m in spec["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"
