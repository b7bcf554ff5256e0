"""A configuration and its cell enter the benchmark as new files and new
entries of `BENCHMARK.json` alone.

In a copy of the benchmark's files a new configuration (``ckt_add20_32k``
under another name) gets its configuration file, its small copy for the CPU
tests and a ``solve1`` cell with qualified metrics of its own.  No file that
was there changes but `BENCHMARK.json`, which only gains entries; the
spec's contract holds, and the CPU tests' helpers find and run the new cell
by name."""

import inspect
import json
import shutil
from pathlib import Path

import pytest

from perfbench import harness
from perfbench.tests import helpers
from perfbench.tests import test_perfbench_spec as contract

ROOT = harness.ROOT
CONFIG = "ckt_copy_probe"
CELL = "cktcopy.solve1"
DATA = helpers.DATA.relative_to(ROOT)


def _add_config(root):
    """Copy the benchmark into ``root`` and add the new configuration and
    cell there; returns the spec as added."""
    shutil.copy(ROOT / "BENCHMARK.json", root)
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = harness.load_spec(root)
    for rel in (f"perfbench/configs/{CONFIG}.json", f"{DATA}/{CONFIG}.json"):
        src = (root / rel).with_name("ckt_add20_32k.json")
        cfg = json.loads(src.read_text())
        cfg["name"] = CONFIG
        (root / rel).write_text(json.dumps(cfg, indent=2))
    base = next(c for c in spec["configs"] if c["name"] == "ckt_add20_32k")
    spec["configs"].append({**base, "name": CONFIG,
                            "file": f"perfbench/configs/{CONFIG}.json"})
    spec["workloads"].append({
        "name": CELL, "config": CONFIG, "traffic": "solve1", "chips": 1,
        "why": "a copy of ckt32k.solve1 under a new configuration"})
    only = {"workloads": [CELL]}
    spec["end_to_end"].append({
        "name": "latency_p50_ms.solve_probe", "unit": "ms", "better": "lower",
        "bound": 0.05, "source": "host_clock", **only})
    spec["per_layer"] += [
        {"name": "program_cycles.solve_probe", "unit": "cycles",
         "better": "lower", "source": "program_counter", "layer": "compiler",
         "moves": "latency_p50_ms.solve_probe", **only},
        {"name": "sptrsv_cuda_roofline.solve_probe", "unit": "%",
         "better": "higher", "source": "device_trace", "layer": "kernels",
         "moves": "latency_p50_ms.solve_probe", **only}]
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return spec


def _files(root):
    return {p.relative_to(root): p.read_bytes()
            for p in [root / "BENCHMARK.json",
                      *(root / "perfbench").rglob("*")]
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_configuration_enters_as_new_files(tmp_path):
    spec = _add_config(tmp_path)
    old, new = _files(ROOT), _files(tmp_path)
    assert set(new) - set(old) == {Path(f"perfbench/configs/{CONFIG}.json"),
                                   DATA / f"{CONFIG}.json"}
    assert [k for k in old if old[k] != new[k]] == [Path("BENCHMARK.json")]
    parent = harness.load_spec()
    for key, value in parent.items():
        if key in ("configs", "workloads", "end_to_end", "per_layer"):
            assert spec[key][:len(value)] == value, key
        else:
            assert spec[key] == value, key

    # the spec's contract, every check of it, on the spec as added
    checks = [f for name, f in vars(contract).items()
              if name.startswith("test_")]
    for check in checks:
        params = inspect.signature(check).parameters
        kw = {"spec": spec, **({"root": tmp_path} if "root" in params else {})}
        if "cell" in params:
            for w in spec["workloads"]:
                check(w["name"], **kw)
        elif "config" in params:
            for c in spec["configs"]:
                check(c["name"], **kw)
        else:
            check(**kw)

    assert helpers.cells("solve1", spec) == helpers.cells("solve1") + [CELL]
    data = tmp_path / DATA
    for trace in (False, True):
        r = helpers.run_cpu(CELL, trace=trace, spec=spec, data=data)
        assert r["correct"] is True and r["attempted"] > 0
        names = {m["name"] for m in harness.cell_metrics(spec, CELL, trace)}
        if trace:
            # on the CPU no device operation runs: the device's readers
            # are silent
            assert {"compile_s", "program_cycles.solve_probe"} <= set(
                r["metrics"]) <= names
        else:
            assert set(r["metrics"]) == names == {
                "setup_s", "latency_p50_ms.solve_probe"}


def test_a_missing_small_copy_is_named(tmp_path):
    spec = _add_config(tmp_path)
    missing = tmp_path / DATA / f"{CONFIG}.json"
    missing.unlink()
    with pytest.raises(AssertionError, match=CONFIG):
        contract.test_config_has_its_small_copy(CONFIG, spec=spec,
                                                root=tmp_path)
    with pytest.raises(FileNotFoundError, match=str(missing)):
        helpers.run_cpu(CELL, spec=spec, data=tmp_path / DATA)
    # the cells of the other configurations still run
    r = helpers.run_cpu("ckt32k.solve1", spec=spec, data=tmp_path / DATA)
    assert r["correct"] is True
