"""Quickstart of the PyTorch/CUDA port: compile once, solve many on the H100.

    PYTHONPATH=src python examples/torch_quickstart.py                 # CUDA
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu    # plain versions

Walks the port's public API on a suite matrix: compile it into a VLIW
`Program`, solve a batch of right-hand sides through the hand-written
kernels (`make_solver(backend="cuda")`), split the columns over devices
(`make_solver(mesh=...)`: every CUDA card, or two blocks on the one card
of a one-card machine), solve again through the health-checked ladder
(`robust_solver`), and serve a short stream of requests through the
micro-batching service (`make_service`), force the row-blocked kernel on a
small band (`placement="blocked"`: x and b in device memory behind a
sliding shared-memory window, which "auto" picks by itself from
band_big16k up), and compare the paper's three dataflows in cycles (coarse,
fine and medium; Fig. 6 / Fig. 9a).  Every answer is held against the
serial forward substitution.  Without ``--device`` it runs on CUDA and
raises on a machine without a card; ``--device cpu`` runs the kernels'
plain PyTorch versions (the mesh then names the CPU twice).  `main`
returns what steps 6 and 7 found.
"""

import argparse
import time

import numpy as np

from repro_torch.core import api, shard
from repro_torch.core.serve import ManualClock
from repro_torch.kernels.sptrsv import kernel


def main(argv=None) -> dict:
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

    # 3. the columns split over devices: each solves its own block of four
    if args.device is None:
        mesh = shard.batch_mesh()
        if mesh.size == 1:
            mesh = shard.batch_mesh(devices=mesh.devices * 2)
    else:
        mesh = shard.batch_mesh(devices=(args.device,) * 2)
    sharded = api.make_solver(prog, batch=8, mesh=mesh, backend="cuda")
    xs = sharded(b).cpu().numpy()
    print(f"make_solver(mesh=...): {mesh.size} column blocks on "
          f"{sorted({str(d) for d in mesh.devices})}, bit-identical to the "
          f"unsharded solve: {np.array_equal(xs, x)}, max err {np.abs(xs - x_ref).max():.2e}")

    # 4. the health-checked ladder: input and residual checks, incidents
    rs = api.robust_solver(prog, mat, backend="cuda", device=args.device)
    x = rs(b)
    print(f"robust_solver: answered on {rs.last_stage}, incidents "
          f"{[(i.stage, i.kind) for i in rs.last_incidents]}, "
          f"max err {np.abs(x - x_ref).max():.2e}")

    # 5. the service: requests micro-batch into the kernels' padded widths
    clock = ManualClock()
    svc = api.make_service({mat.name: mat}, backend="cuda", device=args.device,
                           clock=clock, timer=time.perf_counter, max_batch=8)
    tickets = [svc.submit(mat.name, b[:, j]) for j in range(8)]
    err = max(np.abs(t.result() - x_ref[:, j]).max() for j, t in enumerate(tickets))
    print(f"make_service: {svc.stats.flush_count()} flush of "
          f"{svc.stats.flushes[0].columns} columns "
          f"({svc.stats.flushes[0].reason}), max err {err:.2e}")

    # 6. large n: past the shared-memory budget the blocked kernel keeps x
    #    and b in device memory and slides a window of rows over them (flush
    #    and refill at cycle-block boundaries).  Forced here on a small band
    #    so it runs quickly; on band_big16k and up placement="auto" picks it.
    band = api.matrix("band_cz")
    solver_big = api.make_solver(api.compile(band), batch=8, backend="cuda",
                                 placement="blocked", device=args.device)
    plan = solver_big.plan
    print(f"row-blocked solve: window={plan.window} rows (of n={band.n}), "
          f"stride={plan.stride}, {plan.num_blocks} cycle blocks")
    bb = rng.standard_normal((band.n, 8))
    refs_b = np.stack([api.reference_solve(band, bb[:, j]) for j in range(8)], axis=1)
    before = (kernel.sptrsv_cuda.launches, kernel.sptrsv_cuda_blocked.launches)
    x_blk = solver_big(bb).cpu().numpy()
    launches = {"sptrsv_cuda": kernel.sptrsv_cuda.launches - before[0],
                "sptrsv_cuda_blocked": kernel.sptrsv_cuda_blocked.launches - before[1]}
    blocked_err = float(np.abs(x_blk - refs_b).max())
    print(f"row-blocked      max err: {blocked_err:.2e} (placement "
          f"{solver_big.placement}, launches {launches})")

    # 7. compare the three dataflows of the paper (Fig. 6 / Fig. 9a)
    cycles = {"coarse": api.baseline_coarse(mat).stats.cycles,
              "fine": api.baseline_fine(mat).effective_cycles,
              "medium": prog.stats.cycles}
    print(f"cycles: coarse={cycles['coarse']} fine={cycles['fine']:.0f} "
          f"medium={cycles['medium']}  (lower is better)")
    return {"blocked": {"placement": solver_big.placement, "window": plan.window,
                        "stride": plan.stride, "num_blocks": plan.num_blocks,
                        "max_err": blocked_err, "max_ref": float(np.abs(refs_b).max()),
                        "launches": launches},
            "cycles": cycles}


if __name__ == "__main__":
    main()
