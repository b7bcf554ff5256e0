#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a with nvcc,
into build/).  It drives the port's main path, matrix -> compile ->
make_solver(backend="cuda") -> the hand-written kernels, on the suite's
largest matrices with 16 right-hand sides:

  1. the card's name and power limit, and the kernels' build time;
  2. band_huge64k (n = 65,536): placement "auto" must take the row-blocked
     kernel; the solve is held against the float64 program oracle
     (execute_numpy) and the serial forward substitution;
  3. ckt_huge32k (n = 32,768, no feasible window): "auto" must take the
     resident kernel; the same checks;
  4. each kernel against its plain PyTorch version on the card, on the
     staged inputs of step 2/3 (rtol 1e-5, atol 1e-5 * max|plain|);
  5. times: each kernel (CUDA events over repeated launches after a
     warm-up), its plain version (one run), cuSPARSE's triangular solve on
     the same matrix (torch.triangular_solve on a sparse CSR tensor, a
     yardstick the port never calls), and the bound of the card for the
     same bytes and flops.

Launch counters are set to 0 right before each main-path solve and read
right after it.  It prints one {"kernels": [...]} line and, last,
{"ok": true, "device": {...}}; any failed check raises and exits non-zero.
Without a CUDA device, or without the repository beside it, it exits
non-zero before printing a result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 16
SEED = 0
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
RTOL = 1e-5
REPLACES = {
    "sptrsv_cuda": "src/repro/kernels/sptrsv/kernel.py:200",
    "sptrsv_cuda_blocked": "src/repro/kernels/sptrsv/kernel.py:410",
}
SOURCE = "src/repro_torch/kernels/sptrsv/csrc/sptrsv.cu"


def _close(got, ref, what):
    """assert |got - ref| <= rtol*|ref| + rtol*max|ref|; return max abs err."""
    import numpy as np

    err = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref).max()),
                               err_msg=what)
    return err


def _event_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.core import api
    from repro_torch.core.executor import _psum_slots, execute_numpy
    from repro_torch.kernels.sptrsv import kernel, ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    kernel.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    print(kernel.build.log.strip())

    wrappers = {"sptrsv_cuda": kernel.sptrsv_cuda,
                "sptrsv_cuda_blocked": kernel.sptrsv_cuda_blocked}
    plains = {"sptrsv_cuda": kernel.sptrsv_plain,
              "sptrsv_cuda_blocked": kernel.sptrsv_blocked_plain}
    entries = []
    for name, placement, kname in (("band_huge64k", "blocked", "sptrsv_cuda_blocked"),
                                   ("ckt_huge32k", "resident", "sptrsv_cuda")):
        # -- main path -------------------------------------------------------
        mat = api.matrix(name)
        t0 = time.perf_counter()
        prog = api.compile(mat)
        t_compile = time.perf_counter() - t0
        solver = api.make_solver(prog, batch=B, backend="cuda")
        assert solver.placement == placement, (name, solver.placement)
        bmat = np.random.default_rng(SEED).standard_normal((mat.n, B)).astype(np.float32)
        for w in wrappers.values():
            w.launches = 0
        x = solver(bmat)
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items()}
        assert launches[kname] > 0, (name, launches)
        x = x.cpu().numpy()
        assert x.shape == (mat.n, B) and np.isfinite(x).all(), name
        err_prog = _close(x, execute_numpy(prog, bmat), f"{name} vs execute_numpy")
        serial = np.stack([api.reference_solve(mat, bmat[:, i]) for i in range(B)], 1)
        err_serial = _close(x, serial, f"{name} vs serial_solve")
        t0 = time.perf_counter()
        for _ in range(5):  # numpy in, tensor out, through the entry point
            solver(bmat)
        torch.cuda.synchronize()
        solve_ms = (time.perf_counter() - t0) * 1e3 / 5
        print(f"{name}: n={mat.n} nnz={mat.nnz} emitted_cycles={prog.cycles} "
              f"compile {t_compile:.2f} s, placement {solver.placement}, "
              f"launches {launches}, max abs err vs float64 program "
              f"{err_prog:.3e}, vs serial_solve {err_serial:.3e}, "
              f"solve through make_solver {solve_ms:.4f} ms", flush=True)

        # -- kernel vs its plain version, on the main path's staged inputs ----
        core = ops.build_solver_cols(prog, B, device="cuda")
        instr, values = core.staged
        n_rows = prog.n + 1 if placement == "resident" else core.plan.n_hbm
        bp = torch.zeros((n_rows, B), dtype=torch.float32, device="cuda")
        bp[:prog.n] = torch.from_numpy(bmat).cuda()
        kw = {"num_slots": _psum_slots(prog)}
        if placement == "blocked":
            kw.update(window=core.plan.window, stride=core.plan.stride,
                      cycles_per_block=128)
        kernel_kw = dict(kw, x_in_smem=core.x_in_smem) if placement == "resident" else kw
        xk = wrappers[kname](instr, values, bp, **kernel_kw)
        t0 = time.perf_counter()
        xp = plains[kname](instr, values, bp, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        max_err = _close(xk[:prog.n].cpu().numpy(), xp[:prog.n].cpu().numpy(),
                         f"{kname} vs its plain version")
        if placement == "resident":
            # the same kernel with x in device memory (as for a vector too
            # large for shared memory) and two columns per CTA
            xg = wrappers[kname](instr, values, bp,
                                 **dict(kw, x_in_smem=False, cols_per_cta=2))
            err_g = _close(xg[:prog.n].cpu().numpy(), xp[:prog.n].cpu().numpy(),
                           f"{kname} (x in device memory) vs its plain version")
            print(f"{kname} with x in device memory, 2 columns per CTA: "
                  f"max abs err vs plain {err_g:.3e}")

        # -- times -----------------------------------------------------------
        for _ in range(2):
            wrappers[kname](instr, values, bp, **kernel_kw)
        ms = _event_ms(lambda: wrappers[kname](instr, values, bp, **kernel_kw), 10)
        lib = torch.sparse_csr_tensor(
            torch.from_numpy(mat.rowptr), torch.from_numpy(mat.colidx),
            torch.from_numpy(mat.values.astype(np.float32)), size=(mat.n, mat.n),
        ).cuda()
        bdev = bp[:prog.n].contiguous()
        xl = torch.triangular_solve(bdev, lib, upper=False).solution
        _close(xl.cpu().numpy(), serial, f"{name} library solve vs serial_solve")
        library_ms = _event_ms(lambda: torch.triangular_solve(bdev, lib, upper=False), 10)
        nbytes = (prog.cycles * prog.num_cus * prog.instr_bytes_per_lane_cycle()
                  + 2 * mat.n * B * 4)
        flops = 2 * mat.nnz * B
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "matrix": name, "B": B,
            "placement": placement, "emitted_cycles": prog.cycles,
            "solve_ms": solve_ms,
            "us_per_cycle": ms * 1e3 / prog.cycles,
        })
        print(f"{kname} on {name}: {ms:.4f} ms ({ms * 1e3 / prog.cycles:.4f} us per "
              f"emitted cycle), plain {plain_ms:.1f} ms, library {library_ms:.4f} ms, "
              f"bound {max(t_bytes, t_ops):.6f} ms", flush=True)

    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
