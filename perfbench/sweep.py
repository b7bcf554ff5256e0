"""Knee sweep of a serve cell: the highest offered rate it sustains.

    python3 perfbench/sweep.py --workload ckt32k.serve --seed 7 \\
        --seconds 10 --rates 100 150 200 250 --orders 1 2 3

Builds the cell once (one compile, values from ``--seed``), then runs its
loop for ``--seconds`` at each rate, once for each arrival order
(``--orders``, the schedule's seeds), and prints, per run: requests/s and
columns/s offered, columns/s completed and their ratio, the mean backlog
(columns due and not done) in the window's first and last quarter, and the
latency p50/p95.  A rate holds where, in every order, completed columns/s
stay at or above 98% of offered, the mean backlog in the first and in the
last quarter stays within one flush of ``max_batch`` columns, and the p95
stays within ``TAIL`` times the p50: a queue that built up early and never
drained, or a tail that swings out, is past the knee even where the
backlog does not grow.  The knee is the highest rate that holds, with every rate below
it holding too.  The cell's rate is set by hand to 80% of it in its
traffic file; the benchmark never searches.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
TAIL = 3.0  # p95 over p50 where the service keeps up: 1.8-2.1 (30-s runs)


def holds(row: dict, max_batch: int) -> bool:
    """Whether one run of the sweep kept up with its offered rate."""
    return (row["completed_cols_s"] >= 0.98 * row["offered_cols_s"]
            and max(row["backlog_first"], row["backlog_last"]) <= max_batch
            and row["p95_ms"] <= TAIL * row["p50_ms"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--orders", type=int, nargs="+", default=None)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness
    from perfbench.common import annotator, percentile

    if not torch.cuda.is_available():
        print("the sweep needs a CUDA device", file=sys.stderr)
        return 3
    parts = harness.resolve(harness.load_spec(), args.workload)
    traffic = parts["traffic"]
    system = harness.load_module(parts["builder"]).build(parts["config"],
                                                         args.seed)
    # past the knee the queue only grows: wait little for its tail
    loop = harness.load_module(parts["loop"]).Loop(
        system, {**traffic, "tail_wait_s": 2.0}, args.seed,
        torch.device("cuda", 0))
    loop.warm()
    span = annotator(False)
    rows = []
    print("rate_rps order offered_cols_s completed_cols_s ratio "
          "backlog_first backlog_last p50_ms p95_ms ok")
    held = {}
    for rate in args.rates:
        held[rate] = True
        for order in args.orders or [args.seed]:
            loop.rate, loop.seed = rate, order
            loop.run(args.seconds, span)
            rec = loop.record()
            off = rec["offered_columns_per_s"]
            done = rec["completed_columns_per_s"]
            first, last = rec["backlog_columns"]
            row = {"rate_rps": rate, "order": order, "offered_cols_s": off,
                   "completed_cols_s": done, "ratio": done / off,
                   "backlog_first": first, "backlog_last": last,
                   "p50_ms": percentile(rec["latency_s"], 50) * 1e3,
                   "p95_ms": percentile(rec["latency_s"], 95) * 1e3}
            row["ok"] = ok = holds(row, traffic["max_batch"])
            rows.append(row)
            held[rate] &= ok
            print(" ".join(f"{v:.4f}" if isinstance(v, float) else str(v)
                           for v in row.values()), flush=True)
            loop.svc.drain()
        if not held[rate]:
            break
    knee = None
    for rate in args.rates:
        if not held.get(rate):
            break
        knee = rate
    print(json.dumps({"workload": args.workload, "knee_rps": knee,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path[:0] = [str(HERE.parent), str(HERE.parent / "src")]
    sys.exit(main())
