"""Run one cell of the benchmark once and print its result line.

Everything that belongs to one configuration, traffic mix, loop, builder or
metric sits in a file of its own, found by the name `BENCHMARK.json` gives:
``configs/<config>.json`` (its ``builder`` names ``builders/<builder>.py``),
``traffic/<traffic>.json`` (its ``loop`` names ``loops/<loop>.py``) and
``metrics/<metric>.py`` (``read(record) -> number or None``).  A metric
split by cell, ``<metric>.<qualifier>``, is read by ``metrics/<metric>.py``
where no file of its full name exists: one reader serves every split.

A run: build the system from the seed, warm up (set-up ends here), drive
the window, read the metrics, free the program's state, compare the sampled
answers with the reference, and print one JSON line.  With ``--trace 1``
the window runs under ``torch.profiler`` and the line carries the
per-layer metrics, the device's busy and window seconds and a breakdown;
with ``--trace 0`` it carries the end-to-end metrics.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")

__all__ = ["load_spec", "resolve", "load_module", "reader_path",
           "cell_metrics", "run_cell", "forbidden_modules", "main"]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def resolve(spec: dict, workload: str, root: Path = ROOT) -> dict:
    """The cell's entries and files: ``{"cell", "config", "traffic",
    "builder", "loop"}`` (the last two as paths)."""
    cell = _by_name(spec["workloads"], workload, "workload")
    centry = _by_name(spec["configs"], cell["config"], "config")
    config = json.loads((root / centry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    return {"cell": cell, "config": config, "traffic": traffic,
            "builder": HERE / "builders" / f"{config['builder']}.py",
            "loop": HERE / "loops" / f"{traffic['loop']}.py"}


def load_module(path: Path):
    """Import ``perfbench/<kind>/<name>.py`` by its path (names may hold
    dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"{path} is not a file of the benchmark")
    modname = "perfbench._" + "_".join(path.relative_to(HERE).with_suffix("")
                                       .parts).replace(".", "_")
    if modname in sys.modules:
        return sys.modules[modname]
    mspec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(mspec)
    sys.modules[modname] = mod
    mspec.loader.exec_module(mod)
    return mod


def reader_path(metric: str) -> Path:
    """``metrics/<metric>.py``, or the file of the longest name that
    ``metric`` extends by dotted qualifiers."""
    name = metric
    while True:
        path = HERE / "metrics" / f"{name}.py"
        if path.is_file() or "." not in name:
            return path
        name = name.rsplit(".", 1)[0]


def cell_metrics(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: the end-to-end ones
    without tracing, the per-layer ones with it."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack's or the
    reference package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(v):
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def _card_note() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({type(e).__name__})"
    return out


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, t_start: float | None = None, device=None,
             traffic: dict | None = None, log=None,
             on_answers=None) -> dict:
    """One run of one cell; returns the result line as a dict.

    ``device=None`` is the CUDA device (its absence is the caller's to
    refuse); the tests pass ``"cpu"`` to drive the same path on the
    kernels' plain versions.  ``traffic`` overrides keys of the cell's
    traffic file (the tests' light loads for those plain versions).
    ``on_answers(answers, system)`` sees the sampled answers before they
    are compared (`perfbench/control.py` solves their right-hand sides
    again with the control).
    """
    import torch

    from perfbench.check import compare
    from perfbench.common import annotator

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    parts = resolve(spec, workload)
    config = parts["config"]
    traffic = {**parts["traffic"], **(traffic or {})}
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    on_cuda = dev.type == "cuda"

    system = load_module(parts["builder"]).build(config, seed)
    loop = load_module(parts["loop"]).Loop(system, traffic, seed, dev)
    loop.warm()
    if on_cuda:
        torch.cuda.synchronize()
    # set-up's objects (imports, the compiled program) leave the collector's
    # care, so that a full collection in the window walks only the window's
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start

    span = annotator(trace)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_cuda else [])
        prof = profile(activities=acts)
        prof.__enter__()
    loop.run(seconds, span)
    if on_cuda:
        torch.cuda.synchronize()
    gc.unfreeze()
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0

    rec = loop.record()
    rec.update(setup_s=setup_s, n=system.n, nnz=system.nnz,
               compile_s=system.compile_s,
               program_cycles=system.program_cycles, trace=None)
    device_info = {"platform": "gpu" if on_cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_cuda
                   else dev.type,
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    breakdown = None
    if prof is not None:
        from perfbench.devtrace import from_profiler

        t0 = time.perf_counter()
        rec["trace"] = tr = from_profiler(prof)
        prof = None
        device_info["busy_s"] = tr.busy_s()
        device_info["window_s"] = tr.window[1] - tr.window[0]
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        log(f"trace: {len(tr.spans)} spans, {len(tr.device)} device "
            f"operations, reduced in {time.perf_counter() - t0:.2f} s")

    metrics = {}
    for m in cell_metrics(spec, workload, trace):
        reader = load_module(reader_path(m["name"]))
        v = reader.read(rec)
        if v is None or not math.isfinite(v):
            log(f"metric {m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    if "late_s" in rec:
        import numpy as np

        late = np.asarray(rec["late_s"], dtype=float)
        late = late[np.isfinite(late)]
        if late.size:
            log(f"generator lateness: p50 {np.median(late) * 1e3:.4f} ms, "
                f"max {late.max() * 1e3:.4f} ms over {late.size} requests")
        log(f"offered {rec['offered_columns_per_s']:.2f} columns/s, "
            f"completed {rec['completed_columns_per_s']:.2f} columns/s, "
            f"backlog first/last quarter {rec['backlog_columns']}")
    log(f"window: {rec['attempted']} requests, {rec['columns']} columns in "
        f"{rec['window_s']:.3f} s; setup {setup_s:.3f} s (compile "
        f"{system.compile_s} s, {system.program_cycles} cycles)")
    if on_cuda:
        log(f"card: {_card_note()}; peaks 67 TFLOP/s f32, 3.35 TB/s")

    attempted, failed = int(rec["attempted"]), int(rec["failed"])
    missing = int(rec["missing"])
    answers = loop.answers()
    loop.close()
    del loop, rec
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if on_answers is not None:
        on_answers(answers, system)
    correct, numbers = compare(answers, system.ref, config["limits"], failed,
                               missing)
    log(f"reference: {len(answers)} sampled answers compared in "
        f"{time.perf_counter() - t0:.2f} s")
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(float(v)), "limit": lim}
                        for k, (v, lim) in numbers.items()}
    return result


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_spec()
    cell = _by_name(spec["workloads"], args.workload, "workload")
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" available", file=sys.stderr)
        return 3
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"modules of {bad} were loaded in the benchmark's process",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
