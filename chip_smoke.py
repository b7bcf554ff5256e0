#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels are built for sm_90a with nvcc,
into build/, one nvcc per source, all started together).  It drives the
port's two paths.  First the SpTRSV solve, matrix -> compile ->
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
     same bytes and flops; the kernel's microseconds and SM clocks per
     emitted cycle, at the SM clock nvidia-smi reads while the card runs
     a queue of the kernel's launches, and the time make_solver adds to
     the kernel (solve_ms - ms);
  6. ptxas: registers, spills and static shared memory of every SpTRSV
     kernel instance, from the build's log (kept beside a reused library;
     a spill, or a log without the 16 resident and 8 blocked instances,
     fails the smoke), and the dynamic shared memory the two main-path
     launches ask for.

Then the rest of the solve API through the same kernels, at 16 right-hand
sides, placement "auto" and backend "cuda" (no path can fall back to the
CPU or to a plain version), each held against its float64 oracle at RTOL
and its launch counts asserted:

  7. an incomplete-Cholesky preconditioner application on band_huge64k,
     api.compile_pair then pair.solve: the forward sweep Ly=b row-blocked,
     the backward sweep L^T x=y resident with x in device memory (the
     reversed schedule leaves no window that fits), one launch of each
     kernel; oracle serial_solve then serial_solve_upper;
  8. the same on ckt_huge32k: both sweeps resident, x in shared memory;
  9. a DPU-v2-style circuit at the paper's largest node count, 85,392
     (random_circuit as benchmarks/dag_workloads.py builds it),
     api.compile_circuit then solve, against circ.eval: one resident
     launch with x in device memory;
 10. node splitting on hub_wall_big, api.compile_split(max_indegree=64)
     then api.solve_split, against serial_solve of the unsplit matrix;
 11. compile once, load, serve: the band backward program saved, loaded
     with verification (load_program(verify=True), timed) and solved to
     the same bits as the compiled program; api.analyze_program on it
     finds no error (its lint codes are printed).

For every sweep of steps 7-10 it prints the kernel's time (CUDA events),
its microseconds and SM clocks per emitted cycle, the time the entry point
adds (solve_ms - ms), the bound, cuSPARSE's triangular solve on the same
triangle (upper=True for the backward sweep) and where x sat; they go to
the "paths" list of the kernels line.  The plain versions are not run
again on these paths: step 4 holds each SpTRSV kernel against its own.

Then Zamba2-2.7B serving at full width (54 Mamba2 layers, d_model 2560,
vocab 32,000, bf16, seeded random weights), through launch/serve.py:
8 requests x 1000 prompt tokens, then 32 greedy decode steps:

  12. the same prefill on the kernels and on the plain path
     (use_kernels=False): in bf16 the last position's logits may differ by
     no more than twice the rounding floor (the plain path against itself
     with attention summed in the twin's order), and in f32 (the same
     seed's weights unrounded) by 1e-4 relative L2 at most; the first scan
     and attention launch's inputs are kept for step 14;
  13. serving: the launch counts of prefill (54 scan, 9 attention) and of
     decode (none), tokens inside the vocabulary, finite logits, and the
     server's prefill and decode tokens/s over SERVE_RUNS runs (the first
     is the counted one);
  14. each kernel against its plain twin on the first layer's real inputs
     (scan f32: 2e-4 of max|plain|; attention bf16: 2e-2 of max|plain|),
     its time (CUDA events), its plain twin's (one run), the bound of the
     card for the same bytes and flops (the scan's also as 3xTF32 on the
     tensor cores, the way its kernel computes), the P variant the
     attention kernel ran, and for attention PyTorch's
     scaled_dot_product_attention on the same tensors (a yardstick the
     port never calls).

Launch counters are set to 0 right before each main-path run (and each
path of steps 7-11) and read right after it.  It prints one
{"kernels": [...], "paths": [...]} line and, last,
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
BF16_FLOPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
TF32_FLOPS_PER_S = 495e12    # H100 SXM TF32 tensor cores, dense
RTOL = 1e-5
REPLACES = {
    "sptrsv_cuda": "src/repro/kernels/sptrsv/kernel.py:200",
    "sptrsv_cuda_blocked": "src/repro/kernels/sptrsv/kernel.py:410",
    "chunked_scan_cuda": "src/repro/kernels/ssd_scan/kernel.py:96",
    "flash_attention_cuda": "src/repro/kernels/flash_attention/kernel.py:100",
}
SOURCE = "src/repro_torch/kernels/sptrsv/csrc/sptrsv.cu"
SOURCES = {
    "sptrsv": SOURCE,
    "ssd_scan": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
    "flash_attention": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
}
SERVE_ARGV = ["--arch", "zamba2-2.7b", "--requests", "8", "--prefill-len", "1000",
              "--decode-steps", "32"]
SCAN_REL, ATTN_REL = 2e-4, 2e-2
PATH_REL_L2_F32 = 1e-4       # ~12x the 8.4e-6 read on the H100 (PERF.md)
SERVE_RUNS = 3


def _close(got, ref, what):
    """assert |got - ref| <= rtol*|ref| + rtol*max|ref|; return max abs err."""
    import numpy as np

    err = float(np.abs(got - ref).max())
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(ref).max()),
                               err_msg=what)
    return err


def _sm_clock_under_load(fn, launches):
    """``clocks.sm`` (MHz) and ``power.limit`` from nvidia-smi, read while
    ``launches`` calls of ``fn`` queued on the card run."""
    import torch

    for _ in range(launches):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.limit", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    mhz, limit = (float(v) for v in out.split(","))
    return mhz, limit


def _ptxas_summary(log):
    """[(kernel, registers, spill store bytes, spill load bytes, smem bytes)]
    from ``nvcc -Xptxas -v`` output; a kernel is its name and template
    arguments (planes, lanes per thread[, x in shared memory])."""
    import re

    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            mangled = m.group(1)
            name = re.search(r"(resident_kernel|blocked_kernel)", mangled)
            args = re.findall(r"L[ib](\d+)E", mangled)
            cur = [f"{name.group(1) if name else mangled}<{','.join(args)}>", 0, 0, 0, 0]
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur[2], cur[3] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur[1] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur[4] = int(m.group(1)) if m else 0
    return [tuple(r) for r in rows]


def _event_ms(fn, reps):
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _staged_launch(prog, core, bmat):
    """The kernel launch that ``core`` (a `ops.build_solver_cols` closure)
    makes, on its staged instruction tensors and ``bmat`` padded as it pads
    it: ``(name, launch, plain, bp, kw)``, with ``plain`` the kernel's plain
    version on the same inputs and ``kw`` the keywords both take."""
    import torch

    from repro_torch.core.executor import _psum_slots
    from repro_torch.kernels.sptrsv import kernel, ops

    instr, values = core.staged
    blocked = core.placement == "blocked"
    bp = torch.zeros((core.plan.n_hbm if blocked else prog.n + 1, bmat.shape[1]),
                     dtype=torch.float32, device=instr.device)
    bp[:prog.n] = torch.as_tensor(bmat, dtype=torch.float32).to(instr.device)
    kw = {"num_slots": _psum_slots(prog)}
    if blocked:
        kw.update(window=core.plan.window, stride=core.plan.stride, cycles_per_block=128)
        name, wrapper, plain = ("sptrsv_cuda_blocked", kernel.sptrsv_cuda_blocked,
                                kernel.sptrsv_blocked_plain)
        kernel_kw = dict(kw, cols_per_cta=ops.COLS_PER_CTA)
    else:
        name, wrapper, plain = "sptrsv_cuda", kernel.sptrsv_cuda, kernel.sptrsv_plain
        kernel_kw = dict(kw, cols_per_cta=ops.COLS_PER_CTA, x_in_smem=core.x_in_smem)
    return (name, lambda: wrapper(instr, values, bp, **kernel_kw),
            lambda: plain(instr, values, bp, **kw), bp, kw)


def _sptrsv_bound_ms(prog, nb):
    """(bound ms, "bytes" or "operations") of a solve of ``nb`` columns: the
    instruction stream read once, b read and x written once, 2 flops per
    non-zero and column (the diagonal's included)."""
    nbytes = prog.cycles * prog.num_cus * prog.instr_bytes_per_lane_cycle() + 2 * prog.n * nb * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * prog.stats.nnz * nb / FP32_FLOPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _library_solve(rowptr, colidx, values, bdev, upper):
    """cuSPARSE's triangular solve (torch.triangular_solve on a sparse CSR
    tensor; a yardstick the port never calls): (x, ms by CUDA events)."""
    import numpy as np
    import torch

    n = len(rowptr) - 1
    a = torch.sparse_csr_tensor(
        torch.from_numpy(np.asarray(rowptr, np.int64)),
        torch.from_numpy(np.asarray(colidx, np.int64)),
        torch.from_numpy(np.asarray(values, np.float32)), size=(n, n)).cuda()
    x = torch.triangular_solve(bdev, a, upper=upper).solution
    return x, _event_ms(lambda: torch.triangular_solve(bdev, a, upper=upper), 10)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.core import api, dag
    from repro_torch.core.executor import execute_numpy
    from repro_torch.kernels import common
    from repro_torch.kernels.flash_attention import kernel as attn_kernel
    from repro_torch.kernels.sptrsv import kernel, ops
    from repro_torch.kernels.ssd_scan import kernel as scan_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    common.build_libraries({n: os.path.join(ROOT, p) for n, p in SOURCES.items()})
    for family in (kernel, scan_kernel, attn_kernel):
        family.build()
    print(f"kernels built in {time.perf_counter() - t0:.2f} s")
    for name in SOURCES:
        if name != "sptrsv":
            print(f"[{name}] {common.BUILD_LOGS.get(name, 'reused').strip()}")
    ptxas = _ptxas_summary(common.BUILD_LOGS.get("sptrsv", ""))
    for kname_, regs, st, ld, sm in ptxas:
        print(f"[sptrsv ptxas] {kname_}: {regs} registers, spill stores {st} B, "
              f"spill loads {ld} B, static smem {sm} B")
    # 2 planes x 4 lane widths x (x in shared or device memory), and 2 x 4
    families = [k.split("<")[0] for k, *_ in ptxas]
    assert (families.count("resident_kernel"), families.count("blocked_kernel")) == (16, 8), \
        f"ptxas reported {len(ptxas)} SpTRSV kernels, not the 16 resident and 8 blocked"
    assert all(st == 0 and ld == 0 for _, _, st, ld, _ in ptxas), "ptxas spilled"

    wrappers = {"sptrsv_cuda": kernel.sptrsv_cuda,
                "sptrsv_cuda_blocked": kernel.sptrsv_cuda_blocked}
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
        levels = int(dag.compute_levels(mat).max()) + 1
        print(f"{name}: n={mat.n} nnz={mat.nnz} emitted_cycles={prog.cycles} "
              f"DAG levels {levels}, compile {t_compile:.2f} s, placement {solver.placement}, "
              f"launches {launches}, max abs err vs float64 program "
              f"{err_prog:.3e}, vs serial_solve {err_serial:.3e}, "
              f"solve through make_solver {solve_ms:.4f} ms", flush=True)

        # -- kernel vs its plain version, on the main path's staged inputs ----
        core = ops.build_solver_cols(prog, B, device="cuda")
        assert core.placement == placement, (name, core.placement)
        _, launch, plain, bp, kw = _staged_launch(prog, core, bmat)
        smem = ops.state_bytes(prog, placement=placement, plan=core.plan)
        xk = launch()
        t0 = time.perf_counter()
        xp = plain()
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        max_err = _close(xk[:prog.n].cpu().numpy(), xp[:prog.n].cpu().numpy(),
                         f"{kname} vs its plain version")
        if placement == "resident":
            # the same kernel with x in device memory (as for a vector too
            # large for shared memory) and two columns per CTA
            instr, values = core.staged
            xg = wrappers[kname](instr, values, bp,
                                 **dict(kw, x_in_smem=False, cols_per_cta=2))
            err_g = _close(xg[:prog.n].cpu().numpy(), xp[:prog.n].cpu().numpy(),
                           f"{kname} (x in device memory) vs its plain version")
            print(f"{kname} with x in device memory, 2 columns per CTA: "
                  f"max abs err vs plain {err_g:.3e}")

        # -- times -----------------------------------------------------------
        for _ in range(2):
            launch()
        ms = _event_ms(launch, 10)
        sm_mhz, power_limit = _sm_clock_under_load(launch, max(20, int(600 / ms)))
        xl, library_ms = _library_solve(mat.rowptr, mat.colidx, mat.values,
                                        bp[:prog.n].contiguous(), upper=False)
        _close(xl.cpu().numpy(), serial, f"{name} library solve vs serial_solve")
        bound_ms, bound_by = _sptrsv_bound_ms(prog, B)
        entries.append({
            "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "matrix": name, "B": B,
            "placement": placement, "emitted_cycles": prog.cycles, "dag_levels": levels,
            "solve_ms": solve_ms, "make_solver_overhead_ms": solve_ms - ms,
            "us_per_cycle": ms * 1e3 / prog.cycles,
            "sm_clock_mhz": sm_mhz, "power_limit_w": power_limit,
            "sm_clocks_per_cycle": ms * 1e3 / prog.cycles * sm_mhz,
            "cols_per_cta": ops.COLS_PER_CTA, "smem_bytes_per_cta": smem,
        })
        print(f"{kname} on {name}: {ms:.4f} ms ({ms * 1e3 / prog.cycles:.4f} us, "
              f"{ms * 1e3 / prog.cycles * sm_mhz:.1f} SM clocks per emitted cycle at "
              f"clocks.sm {sm_mhz:.0f} MHz under load, power.limit {power_limit:.0f} W), "
              f"{ops.COLS_PER_CTA} columns per CTA, shared memory per CTA {smem}, "
              f"plain {plain_ms:.1f} ms, library {library_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms, make_solver adds {solve_ms - ms:.4f} ms",
              flush=True)

    paths, launches_by_path = solve_api_phase(wrappers)
    for e in entries:
        e["launches_by_path"] = {path: n[e["name"]] for path, n in launches_by_path.items()}
    entries += serve_phase()
    print(json.dumps({"kernels": entries, "paths": paths}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _drive(wrappers, what, fn):
    """``fn()`` with every SpTRSV launch count set to 0 just before and read
    just after: (its result, {kernel: launches})."""
    import torch

    for w in wrappers.values():
        w.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"{what}: launches {launches}", flush=True)
    return out, launches


def _sweep_entry(path, prog, solver, sweep_input, library, library_ref, rows=slice(None)):
    """Times of one sweep's kernel on its staged inputs, as the path's
    solver launches it: CUDA events over 10 launches after a warm-up, the
    SM clock under load, the bound, and cuSPARSE on the same triangle
    (``library`` = rowptr, colidx, values, b on the card, upper), whose x
    (rows ``rows``) is held against ``library_ref``, the path's x."""
    import numpy as np

    from repro_torch.kernels.sptrsv import ops

    core = ops.build_solver_cols(prog, B, device="cuda")
    assert (core.placement, core.x_in_smem) == (solver.placement, solver.x_in_smem)
    kname, launch, _, _, _ = _staged_launch(prog, core, sweep_input)
    for _ in range(2):
        launch()
    ms = _event_ms(launch, 10)
    sm_mhz, power_limit = _sm_clock_under_load(launch, max(20, int(600 / ms)))
    *csr, bdev, upper = library
    xl, library_ms = _library_solve(*csr, bdev, upper)
    bound_ms, bound_by = _sptrsv_bound_ms(prog, B)
    where = "shared" if core.x_in_smem else "device"
    print(f"{kname} on {path}: {ms:.4f} ms ({ms * 1e3 / prog.cycles:.4f} us, "
          f"{ms * 1e3 / prog.cycles * sm_mhz:.1f} SM clocks per emitted cycle at "
          f"clocks.sm {sm_mhz:.0f} MHz under load, power.limit {power_limit:.0f} W), "
          f"{prog.cycles} emitted cycles, placement {core.placement}, x in {where} "
          f"memory, library (upper={upper}) {library_ms:.4f} ms, bound {bound_ms:.6f} ms",
          flush=True)
    return {
        "path": path, "name": kname, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[kname], "ms": ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms, "library_upper": upper,
        "library_max_abs_err": float(np.abs(xl.cpu().numpy()[rows] - library_ref).max()),
        "n": prog.n, "nnz": prog.stats.nnz, "B": B, "emitted_cycles": prog.cycles,
        "placement": core.placement, "x_in_smem": core.x_in_smem,
        "smem_bytes_per_cta": ops.state_bytes(prog, placement=core.placement,
                                              plan=core.plan),
        "us_per_cycle": ms * 1e3 / prog.cycles,
        "sm_clock_mhz": sm_mhz, "power_limit_w": power_limit,
        "sm_clocks_per_cycle": ms * 1e3 / prog.cycles * sm_mhz,
    }


def _timed_solve_ms(fn, reps=3):
    """Host ms of ``fn()`` (numpy in, numpy out, so synchronised), after a
    warm-up call."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def solve_api_phase(wrappers):
    """The rest of the solve API through the SpTRSV kernels at full size
    (steps 7-11): transpose pairs, a circuit, a split solve, a program saved
    and loaded with verification, and its static analysis.  Returns the
    paths' entries and {path: {kernel: launches}}."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import api
    from repro_torch.core.csr import serial_solve, serial_solve_upper, transpose_upper
    from repro_torch.core.frontends import random_circuit

    paths, launches_by_path = [], {}
    cuda = dict(backend="cuda", placement="auto")

    def finish(path, fn, launches, want, entries, x, ref, what, t_compile):
        """Hold the path's x against its float64 oracle and its launches
        against ``want``; time the path through its entry point."""
        launches_by_path[path] = launches
        assert launches == want, (path, launches, want)
        err = _close(x, ref, what)
        solve_ms = _timed_solve_ms(fn)
        for e in entries:
            e.update(launches=launches[e["name"]], max_abs_err_vs_float64=err,
                     solve_ms=solve_ms, compile_s=t_compile,
                     solve_overhead_ms=solve_ms - sum(f["ms"] for f in entries))
        paths.extend(entries)
        print(f"{path}: compile {t_compile:.2f} s, through the entry point "
              f"{solve_ms:.4f} ms, max abs err vs float64 {err:.3e}", flush=True)

    # -- 7-8. IC preconditioner application: Ly=b then Lᵀx=y ----------------
    for name, sweeps in (("band_huge64k", [("blocked", True), ("resident", False)]),
                         ("ckt_huge32k", [("resident", True), ("resident", True)])):
        mat = api.matrix(name)
        t0 = time.perf_counter()
        pair = api.compile_pair(mat)
        t_compile = time.perf_counter() - t0
        solvers = [api.make_solver(cw.program, batch=B, **cuda)
                   for cw in (pair.forward, pair.backward)]
        assert [(s.placement, s.x_in_smem) for s in solvers] == sweeps, name
        bmat = np.random.default_rng(SEED).standard_normal((mat.n, B)).astype(np.float32)
        path = f"{name} pair"
        x, launches = _drive(wrappers, path, lambda: pair.solve(bmat, **cuda))
        assert x.shape == (mat.n, B) and np.isfinite(x).all(), path
        u = transpose_upper(mat)
        y = np.stack([serial_solve(mat, bmat[:, i]) for i in range(B)], 1)
        ref = np.stack([serial_solve_upper(u, y[:, i]) for i in range(B)], 1)
        y_k = pair.forward.solve(bmat, **cuda)
        _close(y_k, y, f"{path}: forward sweep vs serial_solve")
        entries = [
            _sweep_entry(f"{path} forward", pair.forward.program, solvers[0], bmat,
                         (mat.rowptr, mat.colidx, mat.values,
                          torch.from_numpy(bmat).cuda(), False), y_k),
            _sweep_entry(f"{path} backward", pair.backward.program, solvers[1],
                         y_k[pair.backward.perm], (u.rowptr, u.colidx, u.values,
                                                   torch.from_numpy(y_k).cuda(), True), x),
        ]
        want = ({"sptrsv_cuda": 1, "sptrsv_cuda_blocked": 1} if name == "band_huge64k"
                else {"sptrsv_cuda": 2, "sptrsv_cuda_blocked": 0})
        finish(path, lambda: pair.solve(bmat, **cuda), launches, want, entries, x, ref,
               f"{path} vs serial_solve + serial_solve_upper", t_compile)
        if name == "band_huge64k":
            band_backward, band_backward_in = pair.backward.program, y_k[pair.backward.perm]

    # -- 9. a DPU-v2-style circuit at the paper's largest node count ----------
    n = 85392
    circ = random_circuit(n, max_fan_in=6, seed=n, locality=max(32, n // 16),
                          name=f"circ_{n}")
    t0 = time.perf_counter()
    cw = api.compile_circuit(circ)
    t_compile = time.perf_counter() - t0
    solver = api.make_solver(cw.program, batch=B, **cuda)
    assert (solver.placement, solver.x_in_smem) == ("resident", False), solver.placement
    umat = np.random.default_rng(SEED).standard_normal((n, B)).astype(np.float32)
    path = f"circuit n={n}"
    x, launches = _drive(wrappers, path, lambda: cw.solve(umat, **cuda))
    assert x.shape == (n, B) and np.isfinite(x).all(), path
    # the circuit as the lower-triangular system its program solves:
    # 1 / scale on the diagonal, the negated weights below it
    rowptr = circ.ptr + np.arange(n + 1)
    diag = rowptr[1:] - 1
    off = np.ones(rowptr[-1], bool)
    off[diag] = False
    colidx, values = np.empty(rowptr[-1], np.int64), np.empty(rowptr[-1])
    colidx[off], values[off] = circ.src, -circ.weight
    colidx[diag], values[diag] = np.arange(n), 1.0 / circ.scale
    entry = _sweep_entry(path, cw.program, solver, umat,
                         (rowptr, colidx, values, torch.from_numpy(umat).cuda(), False), x)
    finish(path, lambda: cw.solve(umat, **cuda), launches,
           {"sptrsv_cuda": 1, "sptrsv_cuda_blocked": 0}, [entry], x, circ.eval(umat),
           f"{path} vs circ.eval", t_compile)

    # -- 10. node splitting on the suite's hub matrix -------------------------
    mat = api.matrix("hub_wall_big")
    t0 = time.perf_counter()
    prog, split = api.compile_split(mat, max_indegree=64)
    t_compile = time.perf_counter() - t0
    assert split.n_aux > 0, "hub_wall_big has no heavy rows to split"
    solver = api.make_solver(prog, batch=B, **cuda)
    assert (solver.placement, solver.x_in_smem) == ("resident", True), solver.placement
    bmat = np.random.default_rng(SEED).standard_normal((mat.n, B)).astype(np.float32)
    path = f"hub_wall_big split (max in-degree 64, {split.n_aux} auxiliary rows)"
    x, launches = _drive(wrappers, path, lambda: api.solve_split(prog, split, bmat, **cuda))
    assert x.shape == (mat.n, B) and np.isfinite(x).all(), path
    eb, sm = split.expand_rhs(bmat), split.mat
    entry = _sweep_entry(path, prog, solver, eb,
                         (sm.rowptr, sm.colidx, sm.values, torch.from_numpy(eb).cuda(), False),
                         x, rows=split.orig_index)
    ref = np.stack([serial_solve(mat, bmat[:, i]) for i in range(B)], 1)
    finish(path, lambda: api.solve_split(prog, split, bmat, **cuda), launches,
           {"sptrsv_cuda": 1, "sptrsv_cuda_blocked": 0}, [entry], x, ref,
           f"{path} vs serial_solve of the unsplit matrix", t_compile)

    # -- 11. compile once, save, load with verification, serve ---------------
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        blob = os.path.join(tmp, "band_huge64k_backward.prog")
        api.save_program(band_backward, blob)
        t0 = time.perf_counter()
        loaded = api.load_program(blob, verify=True)
        t_load = time.perf_counter() - t0
    path = "band_huge64k pair backward, loaded"
    x, launches = _drive(wrappers, path,
                         lambda: api.solve_batch(loaded, band_backward_in, **cuda))
    launches_by_path[path] = launches
    assert launches == {"sptrsv_cuda": 1, "sptrsv_cuda_blocked": 0}, launches
    assert np.array_equal(x, api.solve_batch(band_backward, band_backward_in, **cuda)), \
        "the loaded program solved to other bits than the compiled one"
    t0 = time.perf_counter()
    report = api.analyze_program(band_backward)
    t_analyze = time.perf_counter() - t0
    assert report.ok(), report.render()
    codes = sorted(report.codes())
    print(f"{path}: load_program(verify=True) {t_load:.3f} s; x bit-identical to the "
          f"compiled program's; analyze_program {t_analyze:.3f} s, no error, lint codes "
          f"{codes}", flush=True)
    paths.append({"path": path, "name": "sptrsv_cuda", "launches": 1,
                  "load_verify_s": t_load, "analyze_s": t_analyze, "lint_codes": codes,
                  "bit_identical": True})
    return paths, launches_by_path


def _rel_l2(got, ref):
    return ((got.float() - ref.float()).norm() / ref.float().norm()).item()


def _tap(calls, fn):
    """``fn`` that also keeps a copy of its first call's arguments."""
    def tapped(*args, **kw):
        if not calls:
            calls.append(([a.clone() for a in args], dict(kw)))
        return fn(*args, **kw)
    return tapped


def serve_phase():
    """Zamba2-2.7B served at full width on the kernels (steps 12-14)."""
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention import kernel as attn_kernel
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.ssd_scan import kernel as scan_kernel
    from repro_torch.kernels.ssd_scan import ops as scan_ops
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_params, prefill

    t0 = time.perf_counter()
    srv = serve.setup(serve.parse_args(SERVE_ARGV))
    torch.cuda.synchronize()
    cfg = srv.cfg
    n_params = sum(p.numel() for p in srv.model.parameters())
    print(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab {cfg.vocab}, "
          f"{cfg.dtype}, {n_params / 1e9:.3f} B parameters, set up in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # -- 12. kernel path vs plain path; keeps the first launches' inputs -----
    scan_calls, attn_calls = [], []
    scan_ops.chunked_scan_cuda = _tap(scan_calls, scan_kernel.chunked_scan_cuda)
    attn_ops.flash_attention_cuda = _tap(attn_calls, attn_kernel.flash_attention_cuda)
    try:
        logits_k, cache = prefill(srv.model, srv.tokens, cfg, srv.flags, pad_to=srv.max_seq)
    finally:
        scan_ops.chunked_scan_cuda = scan_kernel.chunked_scan_cuda
        attn_ops.flash_attention_cuda = attn_kernel.flash_attention_cuda
    assert logits_k.shape == (8, 1, cfg.vocab) and torch.isfinite(logits_k).all()
    tok = logits_k[:, -1].argmax(-1, keepdim=True)
    for _ in range(2):
        logits_d, cache = decode_step(srv.model, tok, cache, cfg, srv.flags)
        assert torch.isfinite(logits_d).all(), "decode logits"
        tok = logits_d[:, -1].argmax(-1, keepdim=True)
    del cache
    plain_flags = dataclasses.replace(srv.flags, use_kernels=False)
    logits_p, _ = prefill(srv.model, srv.tokens, cfg, plain_flags, pad_to=srv.max_seq)
    path_err = _rel_l2(logits_k[:, -1], logits_p[:, -1])
    # the bf16 rounding floor of this 63-block stack: the plain path again,
    # with attention summed in another exact order (the kernel's twin)
    exact = attn_ops.attention_ref
    attn_ops.attention_ref = attn_kernel.flash_attention_plain
    try:
        logits_f, _ = prefill(srv.model, srv.tokens, cfg, plain_flags, pad_to=srv.max_seq)
    finally:
        attn_ops.attention_ref = exact
    floor = _rel_l2(logits_f[:, -1], logits_p[:, -1])
    print(f"bf16 prefill, relative L2 of the last position's logits: kernels vs "
          f"plain path {path_err:.3e}; plain path with the attention twin vs plain "
          f"path (rounding floor) {floor:.3e}", flush=True)
    assert path_err <= 2 * floor, (path_err, floor)
    del logits_p, logits_f
    # the same check in f32 at full width, where rounding does not mask a fault
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = init_params(torch.Generator(device="cuda").manual_seed(serve.SEED), cfg32,
                          device="cuda")
    l32k, _ = prefill(model32, srv.tokens, cfg32, srv.flags)
    l32p, _ = prefill(model32, srv.tokens, cfg32, plain_flags)
    path_err32 = _rel_l2(l32k[:, -1], l32p[:, -1])
    print(f"f32 prefill: relative L2 of the last position's logits, kernels vs "
          f"plain path {path_err32:.3e} (limit {PATH_REL_L2_F32})", flush=True)
    assert path_err32 <= PATH_REL_L2_F32, path_err32
    del model32, l32k, l32p
    torch.cuda.empty_cache()

    # -- 13. the main path: serve.run -----------------------------------------
    wrappers = {"chunked_scan_cuda": scan_kernel.chunked_scan_cuda,
                "flash_attention_cuda": attn_kernel.flash_attention_cuda}
    for w in wrappers.values():
        w.launches = 0
    result = serve.run(srv)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"serve: {result}", flush=True)
    assert result["launches"]["prefill"] == {"chunked_scan_cuda": 54,
                                             "flash_attention_cuda": 9}, result
    assert result["launches"]["decode"] == {"chunked_scan_cuda": 0,
                                            "flash_attention_cuda": 0}, result
    assert launches == {"chunked_scan_cuda": 54, "flash_attention_cuda": 9}, launches
    assert all(0 <= t < cfg.vocab for t in result["sample_output"])
    # more runs for the spread of the server's rates; launches are not counted
    runs = [result] + [serve.run(srv) for _ in range(SERVE_RUNS - 1)]
    rates = {key: [r[key] for r in runs]
             for key in ("prefill_tokens_per_s", "decode_tokens_per_s")}

    # -- 14. each kernel vs its plain twin on the first layer's inputs; times -
    entries = []
    (q, k, v, w, s0), kw = scan_calls[0]
    y, sf = scan_kernel.chunked_scan_cuda(q, k, v, w, s0, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    yp, sfp = scan_kernel.chunked_scan_plain(q, k, v, w, s0, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max((y - yp).abs().max().item(), (sf - sfp).abs().max().item())
    scale = max(yp.abs().max().item(), sfp.abs().max().item())
    assert err <= SCAN_REL * scale, (err, scale)
    ms = _event_ms(lambda: scan_kernel.chunked_scan_cuda(q, k, v, w, s0, **kw), 10)
    bh, seq, kdim = q.shape
    vdim = v.shape[2]
    # the work this input needs: per 64-row tile only the causal pairs of the
    # scores (K) and of A.v (V), and per real row the two K x V state products
    t = scan_kernel.TILE
    rows = [min(t, seq - t0) for t0 in range(0, seq, t)]
    pairs = sum(r * (r + 1) // 2 if kw["inclusive"] else r * (r - 1) // 2 for r in rows)
    nbytes = 4 * (3 * bh * seq * kdim + 2 * bh * seq * vdim + 2 * bh * kdim * vdim)
    flops = bh * (2 * pairs * (kdim + vdim) + 4 * seq * kdim * vdim)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    entries.append({
        "name": "chunked_scan_cuda", "route": "cuda", "source": SOURCES["ssd_scan"],
        "replaces": REPLACES["chunked_scan_cuda"], "launches": launches["chunked_scan_cuda"],
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "shape": [bh, seq, kdim, vdim], "flops": flops,
        "peak": "67 TFLOP/s f32 (inputs f32), 3.35 TB/s",
        # the kernel runs each product as three TF32 products (3xTF32)
        "bound_ms_tf32x3": max(t_bytes, 3 * flops / TF32_FLOPS_PER_S * 1e3),
    })
    print(f"chunked_scan_cuda [BH={bh}, L={seq}, K={kdim}, V={vdim}]: "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, {flops / 1e9:.3f} GFLOP, bound "
          f"{max(t_bytes, t_ops):.4f} ms, max abs err vs plain {err:.3e} "
          f"(max |plain| {scale:.3e})", flush=True)

    (qf, kf, vf), kw = attn_calls[0]
    o = attn_kernel.flash_attention_cuda(qf, kf, vf, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    op = attn_kernel.flash_attention_plain(qf, kf, vf, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = (o.float() - op.float()).abs().max().item()
    scale = op.float().abs().max().item()
    assert err <= ATTN_REL * scale, (err, scale)
    ms = _event_ms(lambda: attn_kernel.flash_attention_cuda(qf, kf, vf, **kw), 10)
    bh, lq, d = qf.shape
    heads = cfg.n_heads
    q4, k4, v4 = (a.reshape(bh // heads, heads, -1, d) for a in (qf, kf, vf))
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=kw["causal"], scale=kw["scale"])
    lib_err = (sdpa().reshape(bh, lq, d).float() - op.float()).abs().max().item()
    assert lib_err <= ATTN_REL * scale, lib_err
    sdpa()
    library_ms = _event_ms(sdpa, 10)
    lk = kf.shape[1]
    pairs = lq * (lq + 1) // 2 if kw["causal"] else lq * lk
    nbytes = qf.element_size() * bh * d * (2 * lq + 2 * lk)
    flops = 4 * bh * d * pairs
    bf16 = qf.dtype == torch.bfloat16
    peak = BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S
    # P in the PV product of the bf16 kernel (the f32 kernel keeps f32 P)
    p_variant = attn_kernel.P_VARIANT if bf16 else "f32"
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    entries.append({
        "name": "flash_attention_cuda", "route": "cuda", "source": SOURCES["flash_attention"],
        "replaces": REPLACES["flash_attention_cuda"],
        "launches": launches["flash_attention_cuda"], "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms, "shape": [bh, lq, lk, d], "causal": kw["causal"],
        "peak": ("989 TFLOP/s bf16" if bf16 else "67 TFLOP/s f32") + " (the inputs' "
                "type), 3.35 TB/s",
        "bound_ms_f32_products": max(t_bytes, flops / FP32_FLOPS_PER_S * 1e3),
        "p_variant": p_variant,
    })
    print(f"flash_attention_cuda [BH={bh}, Lq={lq}, Lk={lk}, D={d}], {qf.dtype}, P as "
          f"{p_variant}: "
          f"{ms:.4f} ms, plain {plain_ms:.2f} ms, scaled_dot_product_attention "
          f"{library_ms:.4f} ms, bound {max(t_bytes, t_ops):.4f} ms, max abs err vs "
          f"plain {err:.3e} (max |plain| {scale:.3e}; library vs plain {lib_err:.3e})",
          flush=True)
    print(f"serve, {SERVE_RUNS} runs: prefill tokens/s {rates['prefill_tokens_per_s']}, "
          f"decode tokens/s {rates['decode_tokens_per_s']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    for e in entries:
        e.update(prefill_tokens_per_s=result["prefill_tokens_per_s"],
                 decode_tokens_per_s=result["decode_tokens_per_s"],
                 prefill_tokens_per_s_runs=rates["prefill_tokens_per_s"],
                 decode_tokens_per_s_runs=rates["decode_tokens_per_s"],
                 path_rel_l2_bf16=path_err, path_rel_l2_floor_bf16=floor,
                 path_rel_l2_f32=path_err32)
    return entries


if __name__ == "__main__":
    sys.exit(main())
