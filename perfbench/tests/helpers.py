"""Shared by the benchmark's CPU tests: the benchmark's own spec with its
configurations swapped for small copies, so that a whole run drives the
kernels' plain versions on the CPU in about a second.

Test data is found by name, as the harness finds its run files:

* ``data/<config>.json``: the small copy of configuration ``<config>``
  (the same builder, generator kind and limits, a smaller ``n``);
* ``data/light/<loop>.json``: keys of a traffic file overridden for the
  plain versions, for every traffic that loop ``<loop>`` runs; a loop
  without one runs its traffic as written.

A configuration therefore enters the CPU tests as new files alone.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path

from perfbench import harness

DATA = Path(__file__).resolve().parent / "data"


def small_copy(config: str, data: Path = DATA) -> Path:
    return data / f"{config}.json"


def light_load(loop: str, data: Path = DATA) -> dict:
    path = data / "light" / f"{loop}.json"
    return json.loads(path.read_text()) if path.is_file() else {}


def cells(loop: str | None = None, spec: dict | None = None) -> list[str]:
    """The spec's cells (`BENCHMARK.json`'s by default), in its order;
    with ``loop``, those whose traffic that loop runs."""
    spec = spec or harness.load_spec()
    return [w["name"] for w in spec["workloads"]
            if loop is None or json.loads(
                (harness.HERE / "traffic" / f"{w['traffic']}.json")
                .read_text())["loop"] == loop]


def cpu_spec(spec: dict | None = None, data: Path = DATA) -> dict:
    """A copy of ``spec`` (`BENCHMARK.json` by default) in which each
    configuration that has a small copy under ``data`` points at it."""
    spec = copy.deepcopy(spec or harness.load_spec())
    for c in spec["configs"]:
        path = small_copy(c["name"], data)
        if path.is_file():
            c["file"] = str(path)
    return spec


def run_cpu(workload: str, seed: int = 7, trace: bool = False,
            seconds: float = 0.3, spec: dict | None = None,
            traffic: dict | None = None, data: Path = DATA) -> dict:
    """One run of ``workload`` on the CPU at its configuration's small copy
    and its loop's light load (``traffic`` overrides keys of the load)."""
    spec = cpu_spec(spec, data)
    config = {w["name"]: w["config"] for w in spec["workloads"]}[workload]
    small = small_copy(config, data)
    if not small.is_file():
        raise FileNotFoundError(
            f"cell {workload!r}: configuration {config!r} has no small copy "
            f"for the CPU tests; add {small}")
    parts = harness.resolve(spec, workload)
    light = {**light_load(parts["traffic"]["loop"], data), **(traffic or {})}
    return harness.run_cell(spec, workload, seed, seconds, trace,
                            device="cpu", traffic=light,
                            log=lambda msg: None)
