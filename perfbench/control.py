"""Readings that a cell's correctness limit is set from.

    python3 perfbench/control.py --workload band64k.solve1 --seconds 2 \\
        --seeds 11 12 13 --control-seeds 11 12 13

For each seed: a run of the cell (`perfbench.harness.run_cell`, its own
values, ``--seconds`` at the cell's own load, the sampled answers compared
with the float64 reference): that is the program's reading of
``max_rel_err``.  For the ``--control-seeds`` the same sampled
right-hand sides (at most ``--control-columns`` of them) are also solved by
the control, the reference put in the program's place in bfloat16, the
precision below the configurations' float32
(`perfbench.reference.solve_lowered`), and held to the same float64
reference: the control's reading.  The limit lies between the largest
program reading and the smallest control reading.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def readings(workload: str, seed: int, seconds: float, control: bool,
             control_columns: int) -> dict:
    from perfbench import harness, reference

    seen = {}
    res = harness.run_cell(
        harness.load_spec(), workload, seed, seconds, False,
        log=lambda msg: None,
        on_answers=lambda answers, system: seen.update(answers=answers,
                                                       ref=system.ref))
    checks = res["checks"]
    out = {"seed": seed, "correct": res["correct"],
           "attempted": res["attempted"],
           "program_max_rel_err": checks["max_rel_err"]["value"],
           "missing": checks["missing"]["value"],
           "failed": checks["failed"]["value"]}
    if control:
        b = np.concatenate([np.asarray(b, dtype=np.float64).reshape(
            b.shape[0], -1) for b, _ in seen["answers"]],
            axis=1)[:, :control_columns]
        t0 = time.perf_counter()
        x_low = reference.solve_lowered(*seen["ref"], b)
        x_ref = reference.solve(*seen["ref"], b)
        out["control_max_rel_err"] = float(reference.rel_err(x_low, x_ref)
                                           .max())
        out["control_columns"] = int(b.shape[1])
        out["control_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-columns", type=int, default=64)
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        r = readings(args.workload, seed, args.seconds,
                     seed in args.control_seeds, args.control_columns)
        rows.append(r)
        print(json.dumps(r), flush=True)
    prog = [r["program_max_rel_err"] for r in rows]
    ctrl = [r["control_max_rel_err"] for r in rows
            if "control_max_rel_err" in r]
    print(json.dumps({"workload": args.workload,
                      "program_largest": max(prog),
                      "control_smallest": min(ctrl) if ctrl else None,
                      "seeds": len(prog), "control_seeds": len(ctrl)}))
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]
    sys.exit(main())
