"""Quickstart of the PyTorch/CUDA port: compile once, solve many on the H100.

    PYTHONPATH=src python examples/torch_quickstart.py                 # CUDA
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu    # plain versions

Walks the port's public API on a suite matrix: compile it into a VLIW
`Program`, solve a batch of right-hand sides through the hand-written
kernels (`make_solver(backend="cuda")`), solve again through the
health-checked ladder (`robust_solver`), and serve a short stream of
requests through the micro-batching service (`make_service`).  Every answer
is held against the serial forward substitution.  Without ``--device`` it
runs on CUDA and raises on a machine without a card; ``--device cpu`` runs
the kernels' plain PyTorch versions.
"""

import argparse
import time

import numpy as np

from repro_torch.core import api
from repro_torch.core.serve import ManualClock


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", default="ckt_add20", help="a suite matrix name")
    ap.add_argument("--device", default=None, help="torch device (CUDA by default)")
    args = ap.parse_args(argv)

    # 1. a suite matrix, compiled with the medium-granularity dataflow
    mat = api.matrix(args.matrix)
    prog = api.compile(mat)
    rep = api.report(prog)
    print(f"matrix {mat.name}: n={mat.n} nnz={mat.nnz}, {rep['cycles']} cycles, "
          f"compiled in {rep['compile_s']} s")

    rng = np.random.default_rng(0)
    b = rng.standard_normal((mat.n, 8))
    x_ref = np.stack([api.reference_solve(mat, b[:, j]) for j in range(8)], axis=1)

    # 2. the hand-written kernels: one launch solves all eight columns
    solver = api.make_solver(prog, batch=8, backend="cuda", device=args.device)
    x = solver(b).cpu().numpy()
    print(f"make_solver(backend='cuda'): placement {solver.placement}, "
          f"max err {np.abs(x - x_ref).max():.2e}")

    # 3. the health-checked ladder: input and residual checks, incidents
    rs = api.robust_solver(prog, mat, backend="cuda", device=args.device)
    x = rs(b)
    print(f"robust_solver: answered on {rs.last_stage}, incidents "
          f"{[(i.stage, i.kind) for i in rs.last_incidents]}, "
          f"max err {np.abs(x - x_ref).max():.2e}")

    # 4. the service: requests micro-batch into the kernels' padded widths
    clock = ManualClock()
    svc = api.make_service({mat.name: mat}, backend="cuda", device=args.device,
                           clock=clock, timer=time.perf_counter, max_batch=8)
    tickets = [svc.submit(mat.name, b[:, j]) for j in range(8)]
    err = max(np.abs(t.result() - x_ref[:, j]).max() for j, t in enumerate(tickets))
    print(f"make_service: {svc.stats.flush_count()} flush of "
          f"{svc.stats.flushes[0].columns} columns "
          f"({svc.stats.flushes[0].reason}), max err {err:.2e}")


if __name__ == "__main__":
    main()
