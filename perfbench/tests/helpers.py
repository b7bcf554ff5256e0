"""Shared by the benchmark's CPU tests: the benchmark's own spec with its
configurations swapped for small copies (``data/``), so that a whole run
drives the kernels' plain versions on the CPU in about a second."""

from __future__ import annotations

from pathlib import Path

from perfbench import harness

DATA = Path(__file__).resolve().parent / "data"
SMALL = {"band_jagmesh64k": "band_tiny", "ckt_add20_32k": "ckt_tiny"}
# light loads for the plain versions on the CPU
LIGHT = {"solve1": {"warm_calls": 2, "sample": 8},
         "serve": {"rate_rps": 40, "warm_widths": [1, 9], "sample": 6,
                   "tail_wait_s": 5}}


def cpu_spec() -> dict:
    spec = harness.load_spec()
    for c in spec["configs"]:
        c["file"] = str((DATA / f"{SMALL[c['name']]}.json")
                        .relative_to(harness.ROOT))
    return spec


def run_cpu(workload: str, seed: int = 7, trace: bool = False,
            seconds: float = 0.3, spec: dict | None = None,
            traffic: dict | None = None) -> dict:
    spec = spec or cpu_spec()
    parts = harness.resolve(spec, workload)
    light = {**LIGHT[parts["traffic"]["loop"]], **(traffic or {})}
    return harness.run_cell(spec, workload, seed, seconds, trace,
                            device="cpu", traffic=light,
                            log=lambda msg: None)
