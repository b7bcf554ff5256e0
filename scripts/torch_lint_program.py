#!/usr/bin/env python
"""CLI over the PyTorch port's static analyzer: lint compiled programs.

The port's counterpart of `scripts/lint_program.py`, with the same flags,
output and exit status, built on `repro_torch` alone (no jax).  It analyzes
one or more compiled `Program`s — loaded from the checksummed on-disk
format (the JAX package's `SPTRSVPG` files load too) or compiled on the fly
from named suite matrices — with the full hazard detector plus performance
linter, and renders the `AnalysisReport`s as text (default) or JSON
(``--json``).  It runs on the host only: no device is needed.

    python scripts/torch_lint_program.py ckt.prog other.prog
    python scripts/torch_lint_program.py --matrix ckt_rajat04 --matrix band_cz
    python scripts/torch_lint_program.py --suite --max-n 3000 --json
    python scripts/torch_lint_program.py --matrix hub_mid --verify-ir
    python scripts/torch_lint_program.py --matrix ckt_add20 --schedule paper \
        --frontier   # SPT208 when a better strategy exists

``--schedule`` compiles ``--matrix``/``--suite`` entries with a specific
scheduler strategy (or ``auto``); ``--frontier`` additionally computes
every strategy's predicted cost for the matrix and attaches it to the
program's stats, arming the SPT208 "cycles left on the table" lint for
non-auto compiles.

Exit status is 1 when any report carries an error-severity diagnostic
(warn/info lints alone exit 0), so the CLI slots into CI gates.  The
reports equal the JAX package's, except where SPT205's message and SPT114's
hint name the port's memories (shared and device memory, not VMEM).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.core import api, matrices  # noqa: E402
from repro_torch.core.analysis import LintConfig, analyze_program  # noqa: E402


def _reports(args):
    lc = LintConfig(cycles_per_block=args.cycles_per_block)
    names = list(args.matrix)
    if args.suite:
        names += matrices.suite_names(max_n=args.max_n)
    for path in args.programs:
        prog = api.load_program(path, verify=False)
        yield analyze_program(prog, lint=not args.no_lint, lint_cfg=lc)
    for name in names:
        mat = matrices.generate(name)
        prog = api.compile(mat, schedule=args.schedule,
                           verify_ir=args.verify_ir)
        if args.frontier and prog.stats.schedule_costs is None:
            from repro_torch.core.compiler import strategies
            from repro_torch.core.frontends.sptrsv import lower_tri

            prog.stats.schedule_costs = strategies.frontier_costs(
                lower_tri(mat), prog.config)
        yield analyze_program(prog, lint=not args.no_lint, lint_cfg=lc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("programs", nargs="*", type=Path,
                    help="serialized program files (api.save_program)")
    ap.add_argument("--matrix", action="append", default=[],
                    help="suite matrix name to compile and lint "
                         "(repeatable)")
    ap.add_argument("--suite", action="store_true",
                    help="lint every suite matrix up to --max-n rows")
    ap.add_argument("--max-n", type=int, default=3000,
                    help="row cap for --suite (default 3000)")
    ap.add_argument("--verify-ir", action="store_true",
                    help="also run the per-pass IR contract verifiers "
                         "while compiling --matrix/--suite entries")
    ap.add_argument("--schedule", default="paper",
                    help="scheduler strategy for --matrix/--suite "
                         "compiles: a strategies.STRATEGIES name or "
                         "'auto' (default paper)")
    ap.add_argument("--frontier", action="store_true",
                    help="compute every strategy's predicted cost and "
                         "attach it to stats.schedule_costs, arming the "
                         "SPT208 frontier lint for non-auto compiles")
    ap.add_argument("--no-lint", action="store_true",
                    help="hazard/contract diagnostics only, skip the "
                         "SPT2xx performance lints")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit one JSON document instead of text")
    ap.add_argument("--cycles-per-block", type=int, default=128,
                    help="block granularity for the SPT205 placement "
                         "feasibility lint (default 128)")
    args = ap.parse_args(argv)
    if not args.programs and not args.matrix and not args.suite:
        ap.error("nothing to lint: pass program files, --matrix, or "
                 "--suite")

    reports = list(_reports(args))
    if args.as_json:
        print(json.dumps([r.to_dict() for r in reports], indent=2))
    else:
        print("\n\n".join(r.render() for r in reports))
    return 1 if any(not r.ok() for r in reports) else 0


if __name__ == "__main__":
    raise SystemExit(main())
