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

Then the hardened solve path and the solve service through the SpTRSV
kernels, over steps 2-3's programs (no compile of either matrix again):

  15. api.robust_solver(prog, mat, backend="cuda") on band_huge64k and
     ckt_huge32k at 16 right-hand sides: band answers on cuda-blocked with
     no incident, ckt on cuda-resident with only the blocked rung's typed
     PlacementInfeasibleError; one launch each; x bit-identical to
     make_solver at that placement and within RTOL of serial_solve; the
     robust solve's time and its overhead over make_solver (the input
     check and the scipy residual, on the host);
  16. faults on ckt_add20 (psum traffic, a window that fits): an exception
     in the cuda-blocked closure degrades to cuda-resident, to the bits of
     a direct resident solve; a scaled value plane (verify=False) raises
     residual incidents on both cuda rungs and returns an answer that passes
     the residual check; a poisoned b raises NumericalHealthError before any
     launch; run_fault_injection on the cuda rungs gives no silent wrong
     answer and run_ir_fault_injection catches every applicable class;
  17. api.make_service(backend="cuda", max_batch=16) over both tenants on a
     disk tier written from steps 2-3's programs (ProgramCache(compile_fn=
     ...)), a seeded stream of 200 requests of 1-4 columns on a virtual
     clock (full and deadline flushes): every column bit-identical to a
     direct one-column solve and within RTOL of a float64 solve, one launch
     per flush, one staging per (tenant, padded width); flushes by reason,
     p50/p99 of the flush solve time per tenant (each width's first flush,
     which stages, apart) and columns/s; a second service on the same disk
     tier rehydrates without compiling (timed against the compiles); a
     same-pattern tenant with new values is served after a timed
     recompile_values refresh;
  18. the same service with a ResilienceConfig, cuda-blocked raising on
     half its calls: no silent wrong answer (single-rung tickets bit-equal
     to a direct solve at their rung, every column within RTOL of float64),
     no deadlock, degraded flushes counted, breaker transitions in
     report().to_json() under SPT304.

Then the columns split over devices (core/shard.py), over steps 2-3's
programs:

  19. band_huge64k and ckt_huge32k through make_solver(batch=16, mesh=...,
     backend="cuda") on a mesh of one device and on one of two blocks
     (every card where there are more, the one card twice where there is
     one): placement as in steps 2-3, one launch per block, every column
     bit-identical to the unsharded solve and within RTOL of execute_numpy;
     then a make_service(mesh=...) stream of 50 requests, every column
     bit-identical to its direct solve, two launches a flush.

Then the other five model families served at full width and depth through
launch/serve.py (seeded random bf16 weights, 8 requests, 32 decode steps,
seeded normal vision / frames inputs in place of the server's zero stubs):

  20-24. smollm-360m, granite-moe-1b-a400m, rwkv6-1.6b, whisper-base (448
     prompt tokens, its decoder's context, over 1,500 frames) and
     llama-3.2-vision-11b (1,000 prompt tokens, 1,601 vision tokens): the
     bf16 prefill on the kernels against the plain path within twice the
     rounding floor (the plain path with attention summed by the kernel's
     twin and the scan by the sequential recurrence), the same in f32 at
     full depth within PATH_REL_L2_F32, the launch counts of serve.run's
     prefill and decode (FAMILIES), finite logits and tokens inside the
     vocabulary, tokens/s over SERVE_RUNS runs, and the first launch of
     every distinct attention shape (or the scan) of a prefill and a decode
     step held against its twin, timed beside scaled_dot_product_attention
     and the card's bound.

Then training (launch/train.py, launch/steps.py), which runs no kernel: the
reference trains on its plain paths (use_pallas=False) and no kernel of
either package has a backward pass:

  25. smollm-360m at full width and depth (32 layers, bf16 compute over f32
     master weights, remat, AdamW), B = 8, S = 256, 30 steps of
     train.main at the reference's lr 3e-3 and warmup 20 with a checkpoint
     every 10 steps into a fresh build/train_ckpt: the loss at steps 1 and
     30 (finite), the median step after 3, tokens/s, peak device memory and
     zero launches of the four kernels; then train.main again with --steps
     36 restores step 30 and takes 6 steps; then 10 steps on one fixed
     batch lower its loss by more than MEMO_DROP (the step learns; 30
     fresh batches at lr 3e-3 do not lower the loss, nor do they in the
     reference's trainer at full width and 2 layers, PERF.md);
  26. the gradient on the card against the CPU: smollm-360m at full width,
     f32, 2 layers, B = 2, S = 64, the same weights: loss within 1e-5
     relative, every gradient leaf within 1e-4 relative L2, one AdamW step's
     parameters within 1e-5 relative L2 (entries whose moments the two runs
     do not resolve, where AdamW's update is rounding over rounding, held
     to 2 lr); then one
     train step of granite-moe-1b-a400m (aux > 0), rwkv6-1.6b, zamba2-2.7b,
     whisper-base and llama-3.2-vision-11b at full width with the fewest
     layers (groups) that keep each structure, bf16 over f32 master
     weights: finite loss, finite grad norm > 0, no kernel launch.

Steps 12-26 run on plain tensors: on a world of one the launchers serve
and train without a mesh (mesh.launch_mesh).  Then the device mesh
(distributed/sharding.py, launch/mesh.py), on the card's world of one:
make_local_mesh() starts a one-rank NCCL process group in this process and
a (1, 1) ("data", "model") mesh, which steps 27-28 hand to the launchers;
the weights are DTensors placed by the sharding rules and the kernels run
on each rank's local rows:

  27. launch/serve.py on the mesh for zamba2-2.7b and the five families of
     steps 20-24 at full width and depth, as in steps 12-14 and 20-24 (8
     requests, 1000 prompt tokens, 448 for whisper-base, 32 decode steps,
     the same seeded weights and inputs): the prefill's last logits within
     those steps' bf16 limit (twice the rounding floor) of theirs, every
     greedy token equal, the same launches per phase, and prefill and
     decode tokens/s beside theirs;
  28. launch/train.py on the mesh for smollm-360m with step 25's arguments,
     MESH_TRAIN_STEPS steps: the losses equal step 25's first ones to
     MESH_LOSS_REL relative; the checkpoint (host_0.npz, meta.json,
     COMMITTED; a world of one takes the layout's one-host branch) is
     restored by a restart that continues on step 25's losses;
  29. the dry run, host only: launch/hlo_analysis.py's counts checked on a
     fake world of 4, then launch/dryrun.py for granite-8b x train_4k x pod
     on a fake process group of 256 ranks (meta tensors, its own process):
     per-device argument bytes against the card's memory (they must fit),
     per-device dot_flops, collective bytes and the roofline's terms at the
     H100's datasheet peaks.

Then the user entry points outside src/, each called as a user calls it
(its main(argv), on the card; counters set to 0 before it, read after):

  30. examples/torch_quickstart.py: steps 1-5 as before, then step 6 forces
     the row-blocked kernel on band_cz (placement "blocked", one launch of
     sptrsv_cuda_blocked, max error <= RTOL * max|x_ref| against
     serial_solve) and step 7 prints the three dataflows' cycles (coarse,
     fine, medium); step 6's launch is held against its plain version and
     timed beside cuSPARSE;
  31. examples/torch_ssm_as_sptrsv.py at the reference's sizes (n = 512, 8
     right-hand sides; B, L, H, K, V = 4, 4096, 8, 32, 32): every
     equivalence check True; medium makes one chunked_scan_cuda launch a
     call, agrees with the plain chunked path, and its launch with
     chunked_scan_plain on the same inputs (SCAN_REL), timed beside its
     bound; the three granularities' ms; the bidiagonal program through
     make_solver(batch=8, backend="cuda"), one sptrsv_cuda launch, against
     serial_solve at RTOL and its plain version;
  32. examples/torch_serve_batch.py (granite-moe-1b-a400m reduced, 8
     requests, 64 prompt tokens, 32 decode steps): decode tokens/s > 0,
     one attention launch per layer a prefill and none in decode, the
     first launch against its twin beside SDPA; a second run gives the warm
     rates (the first pays the process's first-use costs);
  33. examples/torch_train_lm.py: lm-100m at full width and depth, the
     reference example's 300 steps (B = 4, S = 256, lr 1e-3) into a fresh
     build/train_lm_ckpt: the example's own assertion (last loss below the
     first), checkpoints committed at steps 100, 200 and 300, no kernel
     launch; step ms (median after 3), tokens/s, peak GiB;
  34. scripts/torch_lint_program.py --matrix ckt_rajat04 --schedule paper
     --frontier, host only: exit 0 and SPT208 in its report.

Last, conformance: the kernels at their edges and on random inputs.

  35. every cuda test of tests/test_torch_cuda.py, through pytest in a
     process of its own (CONFORMANCE, at most CONFORMANCE_TIMEOUT_S):
     the SpTRSV kernels at P = 4 to 256 lanes, 1 to 8 columns per CTA, both
     word planes, blocks of 1 to 128 cycles and a stream cut off mid-chunk,
     on suite matrices and on the JAX package's property-test programs
     (random lower triangles under random configs, B = 1, 5, 16), bit for
     bit their plain twins; the scan and attention at ragged, empty and
     random shapes; the solve API, the service, the families and a train
     step on the card.  It must pass every test and skip none (a skip means
     the card was not seen); its launches go to the "conformance" path,
     and it prints each kernel's worst |kernel - twin| / max|twin|.

Launch counters are set to 0 right before each main-path run (and each
path of steps 7-11 and 15-34) and read right after it; step 35's process
starts its own at 0 and reports them.  It prints one
{"kernels": [...], "paths": [...], "training": [...], "mesh": [...],
"examples": [...], "conformance": {...}} line and, last,
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
    progs = {}  # steps 2-3's programs, reused by steps 15-18
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
        oracle = execute_numpy(prog, bmat)
        err_prog = _close(x, oracle, f"{name} vs execute_numpy")
        serial = np.stack([api.reference_solve(mat, bmat[:, i]) for i in range(B)], 1)
        err_serial = _close(x, serial, f"{name} vs serial_solve")
        progs[name] = {"mat": mat, "prog": prog, "placement": placement, "kernel": kname,
                       "bmat": bmat, "f64": serial, "oracle": oracle,
                       "compile_s": t_compile}
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
    entries += serve_phase()
    torch.cuda.empty_cache()
    more_paths, more_launches = hardened_phase(wrappers, progs)
    paths += more_paths
    launches_by_path.update(more_launches)
    more_paths, more_launches = shard_phase(wrappers, progs)
    paths += more_paths
    launches_by_path.update(more_launches)
    del progs
    torch.cuda.empty_cache()
    more_paths, model_launches = families_phase()
    paths += more_paths
    torch.cuda.empty_cache()
    training, train_launches = train_phase()
    model_launches.update(train_launches)
    mesh_records, mesh_launches = mesh_phase(smi)
    model_launches.update(mesh_launches)
    torch.cuda.empty_cache()
    example_records, more_paths, example_launches = examples_phase()
    paths += more_paths
    launches_by_path.update(example_launches)
    model_launches.update(example_launches)
    torch.cuda.empty_cache()
    conformance = conformance_phase()
    launches_by_path["conformance"] = model_launches["conformance"] = conformance["launches"]
    for e in entries:
        if e["name"] in wrappers:
            e["launches_by_path"] = {path: n[e["name"]] for path, n in launches_by_path.items()}
        else:
            e["launches_by_path"] = {path: n[e["name"]] for path, n in model_launches.items()}
    print(json.dumps({"kernels": entries, "paths": paths, "training": training,
                      "mesh": mesh_records, "examples": example_records,
                      "conformance": conformance}))
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
    UNSHARDED[cfg.name] = {"tokens": result["tokens"], "logits": logits_k[:, -1].cpu(),
                           "floor": floor, "rates": rates}

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


# -- steps 15-18: the hardened solve path and the solve service ---------------
PLACEMENT_REFUSED = ("cuda-blocked", "build-failed", "PlacementInfeasibleError")
FAULT_MATRIX = "ckt_add20"   # small, with psum traffic, and a window that fits
SERVICE_REQUESTS, RESILIENT_REQUESTS = 200, 60


def _f64_solve(mat, bmat):
    """float64 forward substitution of every column (scipy's triangular
    solve, independent of the compiled program)."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla

    a = sp.csr_matrix((mat.values, mat.colidx, mat.rowptr), shape=(mat.n, mat.n))
    return sla.spsolve_triangular(a, np.asarray(bmat, np.float64), lower=True)


def _request_stream(rng, tenants, count):
    """``count`` seeded requests ``(tenant, b[n, 1..4], gap)``: the virtual
    gap before the next is short (mean 0.05 ms, so a tenant's bucket mostly
    fills to 16 columns inside ``max_delay`` = 1 ms) 95% of the time and
    2-5 ms otherwise (so buckets also flush at their deadline)."""
    import numpy as np

    names = list(tenants)
    out = []
    for _ in range(count):
        name = names[int(rng.integers(len(names)))]
        b = rng.standard_normal((tenants[name].n, int(rng.integers(1, 5)))).astype(np.float32)
        gap = (float(rng.exponential(5e-5)) if rng.random() < 0.95
               else float(rng.uniform(2e-3, 5e-3)))
        out.append((name, b, gap))
    return out


def _play(svc, clock, stream):
    """Submit the stream on the service's virtual clock; pump after every
    gap, drain at the end.  Returns [(ticket, tenant, b)]."""
    tickets = []
    for name, b, gap in stream:
        tickets.append((svc.submit(name, b), name, b))
        clock.advance(gap)
        svc.pump()
    svc.drain()
    return tickets


def _service_ms(flushes):
    """The flush log's measured solve times (`FlushRecord.service_s`) per
    tenant: {tenant: ({width: ms of its first flush}, [(ms, columns) of
    the other flushes])}."""
    seen, out = set(), {}
    for f in flushes:
        first, rest = out.setdefault(f.matrix_id, ({}, []))
        if (f.matrix_id, f.padded) in seen:
            rest.append((f.service_s * 1e3, f.columns))
        else:
            first[f.padded] = f.service_s * 1e3
            seen.add((f.matrix_id, f.padded))
    return out


def hardened_phase(wrappers, progs):
    """The hardened solve path and the solve service through the SpTRSV
    kernels (steps 15-18), over steps 2-3's programs (``progs``: tenant ->
    mat, prog, placement, kernel, bmat, f64).  Returns the paths' entries
    and {path: {kernel: launches}}."""
    import collections
    import dataclasses
    import tempfile

    import numpy as np

    from repro_torch.core import api, executor
    from repro_torch.core.errors import NumericalHealthError, RobustnessError
    from repro_torch.core.resilience import BreakerConfig, ResilienceConfig, RetryPolicy
    from repro_torch.core.robust import (
        FaultInjector,
        RobustSolver,
        relative_residual,
        run_fault_injection,
        run_ir_fault_injection,
    )
    from repro_torch.core.serve import ManualClock, ProgramCache, pattern_fingerprint

    paths, launches_by_path = [], {}
    none = {k: 0 for k in wrappers}

    def drive(path, fn):
        out, launches = _drive(wrappers, path, fn)
        launches_by_path[path] = launches
        return out, launches

    # -- 15. robust solves at full size -----------------------------------------
    for name, p in progs.items():
        mat, prog, bmat = p["mat"], p["prog"], p["bmat"]
        stage = "cuda-" + p["placement"]
        t0 = time.perf_counter()
        rs = api.robust_solver(prog, mat, backend="cuda")  # verifies the program
        t_construct = time.perf_counter() - t0
        path = f"{name} robust_solver"
        x, launches = drive(path, lambda: rs(bmat))
        trail = [(i.stage, i.kind, i.error) for i in rs.last_incidents]
        assert rs.last_stage == stage, (path, rs.last_stage, trail)
        assert trail == ([] if p["placement"] == "blocked" else [PLACEMENT_REFUSED]), trail
        assert launches == dict(none, **{p["kernel"]: 1}), (path, launches)
        direct = api.make_solver(prog, batch=B, backend="cuda", placement=p["placement"])
        assert np.array_equal(x, direct(bmat).cpu().numpy()), \
            f"{path}: other bits than the direct {p['placement']} solve"
        err = _close(x, p["f64"], f"{path} vs serial_solve")
        p["x"] = x
        robust_ms = _timed_solve_ms(lambda: rs(bmat))
        assert rs.last_incidents == [] and rs.last_stage == stage
        direct_ms = _timed_solve_ms(lambda: direct(bmat).cpu().numpy())
        t0 = time.perf_counter()
        rs._check_input(bmat)
        check_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        rs.residual(x, bmat)
        residual_ms = (time.perf_counter() - t0) * 1e3
        print(f"{path}: answered on {rs.last_stage}, incidents {trail}, bit-identical to "
              f"make_solver(placement={p['placement']!r}), max abs err vs float64 {err:.3e}; "
              f"robust solve {robust_ms:.4f} ms, make_solver {direct_ms:.4f} ms, overhead "
              f"{robust_ms - direct_ms:.4f} ms (input check {check_ms:.4f} ms, scipy "
              f"residual {residual_ms:.4f} ms); construction with verify_program "
              f"{t_construct:.3f} s", flush=True)
        paths.append({"path": path, "name": p["kernel"], "launches": launches[p["kernel"]],
                      "stage": stage, "incidents": trail, "bit_identical": True,
                      "max_abs_err_vs_float64": err, "B": B, "robust_ms": robust_ms,
                      "make_solver_ms": direct_ms, "robust_overhead_ms": robust_ms - direct_ms,
                      "check_input_ms": check_ms, "residual_ms": residual_ms,
                      "construct_verify_s": t_construct})

    # -- 16. faults on the card --------------------------------------------------
    mat = api.matrix(FAULT_MATRIX)
    prog = api.compile(mat)
    bmat = np.random.default_rng(SEED).standard_normal((mat.n, B)).astype(np.float32)
    want_resident = api.make_solver(prog, batch=B, backend="cuda",
                                    placement="resident")(bmat).cpu().numpy()

    class Faulty(RobustSolver):
        def _solver_for(self, stage, batch):
            fn = super()._solver_for(stage, batch)
            if stage != "cuda-blocked":
                return fn

            def boom(b):
                raise RuntimeError("injected kernel fault")
            return boom

    rs = Faulty(prog, mat, backend="cuda")
    path = f"{FAULT_MATRIX} exception in cuda-blocked"
    x, launches = drive(path, lambda: rs(bmat))
    trail = [(i.stage, i.kind) for i in rs.last_incidents]
    assert rs.last_stage == "cuda-resident", (path, rs.last_stage)
    assert trail == [("cuda-blocked", "exception")] * 2, trail  # one retry
    assert launches == dict(none, sptrsv_cuda=1), launches
    assert np.array_equal(x, want_resident), f"{path}: not the resident solve's bits"
    faults = {"exception": {"stage": rs.last_stage, "incidents": trail, "launches": launches}}

    bad = FaultInjector(SEED).corrupt_stream(prog, k=2, mode="scale")
    rs = RobustSolver(bad, mat, backend="cuda", verify=False)
    path = f"{FAULT_MATRIX} corrupt value plane"
    x, launches = drive(path, lambda: rs(bmat))
    trail = [(i.stage, i.kind) for i in rs.last_incidents]
    assert trail[:2] == [("cuda-blocked", "residual"), ("cuda-resident", "residual")], trail
    assert launches == {"sptrsv_cuda": 1, "sptrsv_cuda_blocked": 1}, launches
    rel = relative_residual(mat, x, bmat)
    assert rel <= 1e-3, rel
    faults["value_plane_scale"] = {"stage": rs.last_stage, "incidents": trail,
                                   "launches": launches, "residual": rel}

    rs = RobustSolver(prog, mat, backend="cuda")
    poisoned = FaultInjector(SEED).poison_rhs(bmat, k=2)

    def solve_poisoned():
        try:
            rs(poisoned)
        except NumericalHealthError as e:
            return str(e)
        raise AssertionError("a poisoned right-hand side was solved")

    path = f"{FAULT_MATRIX} poisoned b"
    msg, launches = drive(path, solve_poisoned)
    assert launches == none, launches
    faults["poisoned_b"] = {"error": msg, "launches": launches}

    path = f"{FAULT_MATRIX} run_fault_injection"
    trials, launches = drive(path, lambda: run_fault_injection(
        mat, prog, trials_per_class=3, seed=SEED, backend="cuda", device="cuda"))
    assert not any(t["silent_wrong"] for t in trials), trials
    detected = collections.Counter((t["fault"], t["detected"], t["degraded_to"])
                                   for t in trials)
    ir = run_ir_fault_injection(mat, seed=SEED)
    assert all(r["caught"] for r in ir if r["applicable"]), ir
    faults["fault_injection"] = {"trials": len(trials), "silent_wrong": 0,
                                 "launches": launches,
                                 "outcomes": {"/".join(k): v for k, v in detected.items()}}
    faults["ir_fault_injection"] = {r["fault"]: r["caught"] if r["applicable"] else None
                                    for r in ir}
    print(f"step 16 on {FAULT_MATRIX} (n={mat.n}, {prog.cycles} cycles): "
          f"{json.dumps(faults)}", flush=True)
    paths.append({"path": f"{FAULT_MATRIX} faults", "n": mat.n, "B": B, **faults})

    # -- 17. the service ---------------------------------------------------------
    tenants = {name: p["mat"] for name, p in progs.items()}
    rng = np.random.default_rng(SEED)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as disk:
        # the disk tier, written through from steps 2-3's programs (no compile)
        seed_cache = ProgramCache(disk_dir=disk, compile_fn=lambda m: progs[m.name]["prog"])
        t0 = time.perf_counter()
        for m in tenants.values():
            seed_cache.get(m)
        t_write = time.perf_counter() - t0
        clock = ManualClock()
        svc = api.make_service(tenants, disk_dir=disk, backend="cuda", clock=clock,
                               timer=time.perf_counter, max_batch=16)
        rehydrate_s = {}
        for name, m in tenants.items():
            t0 = time.perf_counter()
            svc.cache.get(m)
            rehydrate_s[name] = time.perf_counter() - t0
        stream = _request_stream(rng, tenants, SERVICE_REQUESTS)
        traces = executor.trace_count()
        path = f"service: {SERVICE_REQUESTS} requests"
        tickets, stream_launches = drive(path, lambda: _play(svc, clock, stream))
        stagings = executor.trace_count() - traces
        st = svc.stats
        assert all(t.done and not t.failed for t, _, _ in tickets)
        assert svc.pending_columns() == 0 and len(svc.incidents) == 0, svc.incidents.to_list()
        assert all(e.compiles == 0 and e.disk_hits == 1 for e in svc.cache.entries.values())
        assert st.flushes_full > 0 and st.flushes_deadline > 0, st.to_dict()
        per_tenant = collections.Counter(f.matrix_id for f in st.flushes)
        want = dict(none)
        for name, p in progs.items():
            want[p["kernel"]] += per_tenant[name]
        assert stream_launches == want, (stream_launches, want)
        widths = {(f.matrix_id, f.padded) for f in st.flushes}
        assert stagings == len(widths), (stagings, sorted(widths))
        assert all(sum(t == name for t, _ in widths) <= 3 for name in tenants), widths
        errs = {}
        for name, p in progs.items():
            single = api.make_solver(svc.cache.get(tenants[name]), backend="cuda")
            assert single.placement == p["placement"], (name, single.placement)
            cols = [(t.result(), b) for t, nm, b in tickets if nm == name]
            for x, b in cols:
                for j in range(b.shape[1]):
                    assert np.array_equal(x[:, j], single(b[:, j]).cpu().numpy()), \
                        f"service column of {name} differs from its direct solve"
            xs = np.concatenate([x for x, _ in cols], axis=1)
            errs[name] = _close(xs, _f64_solve(tenants[name], np.concatenate(
                [b for _, b in cols], axis=1)), f"service columns of {name} vs float64")
        ms = _service_ms(st.flushes)
        solve_s = sum(f.service_s for f in st.flushes)
        columns = st.completed_columns
        steady = [(t, c) for _, rest in ms.values() for t, c in rest]
        steady = (sum(c for _, c in steady), sum(t for t, _ in steady) / 1e3)
        report = {name: {"flushes": per_tenant[name],
                         "columns": sum(f.columns for f in st.flushes if f.matrix_id == name),
                         "first_flush_ms_by_width": first,
                         "p50_ms": float(np.percentile([t for t, _ in rest], 50)),
                         "p99_ms": float(np.percentile([t for t, _ in rest], 99)),
                         "max_abs_err_vs_float64": errs[name]}
                  for name, (first, rest) in ms.items()}
        reasons = {"full": st.flushes_full, "deadline": st.flushes_deadline,
                   "drain": st.flushes_drain}
        print(f"{path}: {columns} columns in {st.flush_count()} flushes {reasons}, "
              f"launches {stream_launches}, {stagings} stagings over (tenant, padded width) "
              f"{sorted(widths)}; per tenant {json.dumps(report)}; "
              f"{columns / solve_s:.1f} columns/s over {solve_s * 1e3:.2f} ms "
              f"of solve time, {steady[0] / steady[1]:.1f} without each width's first "
              f"flush; every column bit-identical to its direct solve", flush=True)

        # a second service on the same disk tier rehydrates without compiling
        clock2 = ManualClock()
        svc2 = api.make_service(tenants, disk_dir=disk, backend="cuda", clock=clock2,
                                timer=time.perf_counter, max_batch=16)
        rehydrate2_s = {}
        for name, m in tenants.items():
            t0 = time.perf_counter()
            svc2.cache.get(m)
            rehydrate2_s[name] = time.perf_counter() - t0
        assert all(e.compiles == 0 and e.disk_hits == 1 for e in svc2.cache.entries.values())
        for name, p in progs.items():
            t = svc2.submit(name, p["bmat"])
            assert t.done and np.array_equal(t.result(), p["x"]), \
                f"the rehydrated {name} solved to other bits"
        compile_s = {name: p["compile_s"] for name, p in progs.items()}
        print(f"second service on the same disk tier: rehydrated in {rehydrate2_s} s "
              f"(first service {rehydrate_s} s) against compiles of {compile_s} s, "
              f"no compile; x bit-identical to step 15's; disk tier written in "
              f"{t_write:.3f} s", flush=True)

        # a same-pattern, new-values tenant: a values-only refresh, no compile
        name = next(n for n, p in progs.items() if p["placement"] == "resident")
        m2 = dataclasses.replace(tenants[name], values=tenants[name].values * 1.5)
        svc.register(f"{name} x1.5", m2)
        t0 = time.perf_counter()
        svc.cache.get(m2)
        refresh_s = time.perf_counter() - t0
        ent = svc.cache.entries[pattern_fingerprint(m2)]
        assert (ent.value_refreshes, ent.compiles) == (1, 0), ent
        path = f"service: {name} x1.5 after recompile_values"
        t, launches = drive(path, lambda: svc.submit(f"{name} x1.5", progs[name]["bmat"]))
        assert t.done and launches == dict(none, **{progs[name]["kernel"]: 1}), launches
        err = _close(t.result(), _f64_solve(m2, progs[name]["bmat"]),
                     f"{name} x1.5 vs float64")
        print(f"{path}: recompile_values refresh {refresh_s:.3f} s (compile "
              f"{compile_s[name]:.2f} s), max abs err vs float64 {err:.3e}", flush=True)
        paths.append({
            "path": "service", "requests": SERVICE_REQUESTS, "columns": columns,
            "flushes": reasons, "launches": stream_launches,
            "stagings": stagings, "widths": sorted(widths), "tenants": report,
            "columns_per_s": columns / solve_s, "solve_s": solve_s,
            "columns_per_s_after_staging": steady[0] / steady[1],
            "rehydrate_s": rehydrate_s, "rehydrate2_s": rehydrate2_s, "compile_s": compile_s,
            "disk_write_s": t_write, "refresh_s": refresh_s, "refresh_err": err,
            "bit_identical": True})

        # -- 18. the resilient service: cuda-blocked raises on half its calls --
        res = ResilienceConfig(
            retry=RetryPolicy(max_retries=1, base_delay_s=1e-3, seed=SEED),
            breaker=BreakerConfig(window_s=1.0, min_samples=4, failure_threshold=0.5,
                                  cooldown_s=0.01))
        clock3 = ManualClock()
        svc3 = api.make_service(tenants, disk_dir=disk, backend="cuda", clock=clock3,
                                timer=time.perf_counter, max_batch=16, resilience=res)
        frng = np.random.default_rng(SEED + 18)
        orig = svc3._stage_solver

        def chaotic(stage, prog, k, mat):
            fn = orig(stage, prog, k, mat)
            if stage != "cuda-blocked":
                return fn

            def wrapped(bm):
                if frng.random() < 0.5:
                    raise RuntimeError("injected cuda-blocked fault")
                return fn(bm)
            return wrapped

        svc3._stage_solver = chaotic
        stream = _request_stream(rng, tenants, RESILIENT_REQUESTS)
        traces = executor.trace_count()
        path = f"resilient service: {RESILIENT_REQUESTS} requests"
        tickets, launches = drive(path, lambda: _play(svc3, clock3, stream))
        stagings3 = executor.trace_count() - traces
        st3 = svc3.stats
        assert svc3.pending_columns() == 0 and all(t.done for t, _, _ in tickets), "deadlock"
        by_index = {f.index: f for f in st3.flushes if f.index >= 0}
        rungs = collections.Counter(f.stage for f in by_index.values())
        assert set(rungs) <= {"cuda-blocked", "cuda-resident"}, rungs
        assert launches == {"sptrsv_cuda_blocked": rungs["cuda-blocked"],
                            "sptrsv_cuda": rungs["cuda-resident"]}, (launches, rungs)
        silent_wrong = failed = mixed = 0
        answered = collections.defaultdict(list)
        for t, name, b in tickets:
            if t.failed:
                failed += 1
                silent_wrong += not isinstance(t.error, RobustnessError)
                continue
            stages = {by_index[i].stage for i in t.flush_indices}
            x = t.result()
            if len(stages) == 1:
                (stage,) = stages
                direct = api.make_solver(svc3.cache.get(tenants[name]), batch=b.shape[1],
                                         backend="cuda", placement=stage[len("cuda-"):])
                silent_wrong += not np.array_equal(x, direct(b).cpu().numpy())
            else:
                mixed += 1
                silent_wrong += not relative_residual(tenants[name], x, b) <= 1e-3
            answered[name].append((x, b))
        for name, cols in answered.items():
            _close(np.concatenate([x for x, _ in cols], axis=1),
                   _f64_solve(tenants[name], np.concatenate([b for _, b in cols], axis=1)),
                   f"resilient service columns of {name} vs float64")
        assert silent_wrong == 0, silent_wrong
        assert st3.degraded_flushes > 0, st3.to_dict()
        diag = json.loads(svc3.report().to_json())
        codes = collections.Counter(d["code"] for d in diag["diagnostics"])
        kinds = svc3.incidents.by_kind()
        assert codes["SPT304"] > 0 and all(c.startswith("SPT30") for c in codes), codes
        print(f"{path}: {st3.columns} columns, {st3.flush_count()} flushes by rung "
              f"{dict(rungs)}, {st3.degraded_flushes} degraded, {st3.retries} retries, "
              f"{failed} failed typed, {mixed} tickets across rungs, 0 silent wrong, "
              f"no deadlock; launches {launches}; {stagings3} stagings (rehydrated "
              f"programs are new objects); report codes {dict(codes)}, incident kinds "
              f"{kinds}, breakers {diag['meta']['breakers']}", flush=True)
        paths.append({"path": "resilient service", "requests": RESILIENT_REQUESTS,
                      "columns": st3.columns, "flushes_by_rung": dict(rungs),
                      "degraded_flushes": st3.degraded_flushes, "retries": st3.retries,
                      "failed_typed": failed, "mixed_tickets": mixed, "silent_wrong": 0,
                      "deadlocked": False, "launches": launches, "stagings": stagings3,
                      "report_codes": dict(codes), "incident_kinds": kinds,
                      "breakers": diag["meta"]["breakers"]})
    return paths, launches_by_path


# -- step 19: the columns of a solve split over devices -------------------------
SHARD_REQUESTS = 50


def _meshes():
    """A mesh of one device, and one of two blocks: every card where there
    are more, the one card twice where there is one."""
    import torch

    from repro_torch.core import shard

    one = shard.batch_mesh(1)
    two = (shard.batch_mesh() if torch.cuda.device_count() > 1
           else shard.batch_mesh(devices=one.devices * 2))
    return {"1 device": one, f"{two.size} blocks": two}


def shard_phase(wrappers, progs):
    """Steps 2-3's solves split over devices (step 19), through
    make_solver(mesh=...) and a make_service(mesh=...) stream.  Returns the
    paths' entries and {path: {kernel: launches}}."""
    import tempfile

    import numpy as np

    from repro_torch.core import api
    from repro_torch.core.serve import ManualClock, ProgramCache

    paths, launches_by_path = [], {}
    none = {k: 0 for k in wrappers}
    meshes = _meshes()
    for name, p in progs.items():
        prog, bmat = p["prog"], p["bmat"]
        unsharded = api.make_solver(prog, batch=B, backend="cuda")
        direct = unsharded(bmat).cpu().numpy()
        direct_ms = _timed_solve_ms(lambda: unsharded(bmat).cpu().numpy())
        for label, mesh in meshes.items():
            solver = api.make_solver(prog, batch=B, mesh=mesh, backend="cuda")
            assert solver.placement == p["placement"], (name, label, solver.placement)
            path = f"{name} sharded over {label} ({mesh.size} column blocks)"
            x, launches = _drive(wrappers, path, lambda: solver(bmat))
            launches_by_path[path] = launches
            assert launches == dict(none, **{p["kernel"]: mesh.size}), (path, launches)
            x = x.cpu().numpy()
            assert np.array_equal(x, direct), f"{path}: other bits than the unsharded solve"
            err = _close(x, p["oracle"], f"{path} vs execute_numpy")
            solve_ms = _timed_solve_ms(lambda: solver(bmat).cpu().numpy())
            print(f"{path}: placement {solver.placement}, launches {launches}, "
                  f"bit-identical to the unsharded solve, max abs err vs float64 "
                  f"program {err:.3e}; through the entry point, numpy in and out, "
                  f"{solve_ms:.4f} ms (unsharded {direct_ms:.4f} ms)", flush=True)
            paths.append({"path": path, "name": p["kernel"], "launches": launches[p["kernel"]],
                          "devices": [str(d) for d in mesh.devices], "B": B,
                          "placement": solver.placement, "bit_identical": True,
                          "max_abs_err_vs_float64": err, "solve_ms": solve_ms,
                          "unsharded_solve_ms": direct_ms})

    # a service stream with every flush split over the two-block mesh
    label, mesh = list(meshes.items())[-1]
    tenants = {name: p["mat"] for name, p in progs.items()}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as disk:
        seed_cache = ProgramCache(disk_dir=disk, compile_fn=lambda m: progs[m.name]["prog"])
        for m in tenants.values():
            seed_cache.get(m)
        clock = ManualClock()
        svc = api.make_service(tenants, disk_dir=disk, backend="cuda", mesh=mesh,
                               clock=clock, timer=time.perf_counter, max_batch=16)
        stream = _request_stream(np.random.default_rng(SEED + 19), tenants, SHARD_REQUESTS)
        path = f"service over {label}: {SHARD_REQUESTS} requests"
        tickets, launches = _drive(wrappers, path, lambda: _play(svc, clock, stream))
        launches_by_path[path] = launches
        st = svc.stats
        assert all(t.done and not t.failed for t, _, _ in tickets)
        assert len(svc.incidents) == 0, svc.incidents.to_list()
        want = dict(none)
        for f in st.flushes:
            want[progs[f.matrix_id]["kernel"]] += mesh.size
        assert launches == want, (launches, want)
        for name, p in progs.items():
            single = api.make_solver(svc.cache.get(tenants[name]), backend="cuda")
            for t, nm, b in tickets:
                if nm != name:
                    continue
                x = t.result()
                for j in range(b.shape[1]):
                    assert np.array_equal(x[:, j], single(b[:, j]).cpu().numpy()), \
                        f"sharded service column of {name} differs from its direct solve"
        solve_s = sum(f.service_s for f in st.flushes)
        print(f"{path}: {st.completed_columns} columns in {st.flush_count()} flushes, "
              f"launches {launches} ({mesh.size} a flush), every column bit-identical "
              f"to its direct solve; {st.completed_columns / solve_s:.1f} columns/s over "
              f"{solve_s * 1e3:.2f} ms of solve time (stagings included)", flush=True)
        paths.append({"path": path, "requests": SHARD_REQUESTS,
                      "columns": st.completed_columns, "flushes": st.flush_count(),
                      "launches": launches, "bit_identical": True,
                      "columns_per_s": st.completed_columns / solve_s, "solve_s": solve_s})
    return paths, launches_by_path


# -- steps 20-24: the other five families served at full width -----------------
FAMILIES = (  # arch, prompt tokens, (scan, attention) launches per prefill and decode step
    ("smollm-360m", 1000, (0, 32), (0, 0)),
    ("granite-moe-1b-a400m", 1000, (0, 24), (0, 0)),
    ("rwkv6-1.6b", 1000, (24, 0), (0, 0)),
    ("whisper-base", 448, (0, 18), (0, 6)),       # 448: the decoder's context
    ("llama-3.2-vision-11b", 1000, (0, 40), (0, 0)),
)
FAMILY_REQUESTS, FAMILY_DECODE = 8, 32
# what steps 12-14, 20-24 and 25 served and trained on no mesh, for steps 27-28
UNSHARDED: dict = {}


def _seeded_extra(cfg, requests):
    """Seeded normal frontend inputs (the server's stub feeds zeros, which
    would hide a fault in cross-attention)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    if cfg.family == "vlm":
        return {"vision": torch.randn((requests, cfg.vision_tokens, cfg.vision_dim),
                                      generator=g, device="cuda")}
    if cfg.family == "encdec":
        return {"frames": torch.randn((requests, cfg.enc_frames, cfg.d_model),
                                      generator=g, device="cuda")}
    return {}


def _kernel_check(name, args, kw, heads):
    """One tapped launch's real inputs: the kernel against its plain twin,
    its time (CUDA events), the twin's (one run), the card's bound and,
    for attention, scaled_dot_product_attention on the same tensors."""
    import torch

    from repro_torch.kernels.flash_attention import kernel as attn_kernel
    from repro_torch.kernels.ssd_scan import kernel as scan_kernel

    if name == "chunked_scan_cuda":
        launch = lambda: scan_kernel.chunked_scan_cuda(*args, **kw)
        plain = lambda: scan_kernel.chunked_scan_plain(*args, **kw)
    else:
        launch = lambda: attn_kernel.flash_attention_cuda(*args, **kw)
        plain = lambda: attn_kernel.flash_attention_plain(*args, **kw)
    got = launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if name == "flash_attention_cuda":
        got, want = (got,), (want,)
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    scale = max(w.float().abs().max().item() for w in want)
    launch()
    ms = _event_ms(launch, 10)
    entry = {"name": name, "route": "cuda", "max_abs_err": err, "max_abs_plain": scale,
             "ms": ms, "plain_ms": plain_ms, "replaces": REPLACES[name]}
    if name == "chunked_scan_cuda":
        q, k, v, w, s0 = args
        assert err <= SCAN_REL * scale, (err, scale)
        bh, seq, kdim = q.shape
        vdim = v.shape[2]
        t = scan_kernel.TILE
        rows = [min(t, seq - t0) for t0 in range(0, seq, t)]
        pairs = sum(r * (r + 1) // 2 if kw["inclusive"] else r * (r - 1) // 2 for r in rows)
        nbytes = 4 * (3 * bh * seq * kdim + 2 * bh * seq * vdim + 2 * bh * kdim * vdim)
        flops = bh * (2 * pairs * (kdim + vdim) + 4 * seq * kdim * vdim)
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
        entry.update(source=SOURCES["ssd_scan"], library_ms=None,
                     shape=[bh, seq, kdim, vdim], inclusive=kw["inclusive"])
    else:
        qf, kf, vf = args
        bf16 = qf.dtype == torch.bfloat16
        assert err <= (ATTN_REL if bf16 else 2e-5) * max(scale, 1.0), (err, scale)
        bh, lq, d = qf.shape
        lk = kf.shape[1]
        q4, k4, v4 = (a.reshape(bh // heads, heads, -1, d) for a in (qf, kf, vf))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=kw["causal"], scale=kw["scale"])
        lib_err = (sdpa().reshape(bh, lq, d).float() - want[0].float()).abs().max().item()
        assert lib_err <= ATTN_REL * max(scale, 1.0), lib_err
        library_ms = _event_ms(sdpa, 10)
        pairs = lq * (lq + 1) // 2 if kw["causal"] else lq * lk
        nbytes = qf.element_size() * bh * d * (2 * lq + 2 * lk)
        flops = 4 * bh * d * pairs
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / (BF16_FLOPS_PER_S if bf16 else FP32_FLOPS_PER_S) * 1e3
        entry.update(source=SOURCES["flash_attention"], library_ms=library_ms,
                     library_max_abs_err=lib_err, shape=[bh, lq, lk, d],
                     causal=kw["causal"], dtype=str(qf.dtype).split(".")[-1])
    entry.update(bound_ms=max(t_bytes, t_ops),
                 bound_by="bytes" if t_bytes >= t_ops else "operations")
    return entry


def family_phase(arch, prompt, want_prefill, want_decode):
    """One model served at full width and depth (steps 20-24): kernels
    against the plain path (bf16 within twice the rounding floor, f32 at
    PATH_REL_L2_F32), the launch counts of serve.run's prefill and decode,
    finite logits and tokens inside the vocabulary, tokens/s over
    SERVE_RUNS runs, and the first launch of every attention shape (or the
    first scan launch) held against its twin and timed.  Returns the
    paths' entries and {path: {kernel: launches}}."""
    import dataclasses

    import torch

    from repro_torch.kernels.flash_attention import kernel as attn_kernel
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.ssd_scan import kernel as scan_kernel
    from repro_torch.kernels.ssd_scan import ops as scan_ops
    from repro_torch.kernels.ssd_scan.ref import scan_ref
    from repro_torch.launch import serve
    from repro_torch.models import decode_step, init_params, prefill

    argv = ["--arch", arch, "--requests", str(FAMILY_REQUESTS), "--prefill-len",
            str(prompt), "--decode-steps", str(FAMILY_DECODE)]
    args = serve.parse_args(argv)
    cfg = serve.get_config(arch)
    extra = _seeded_extra(cfg, FAMILY_REQUESTS)
    t0 = time.perf_counter()
    srv = serve.setup(args, extra=extra)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in srv.model.parameters())
    print(f"{arch} ({cfg.family}): {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}, {cfg.dtype}, {n_params / 1e9:.3f} B parameters, set up in "
          f"{time.perf_counter() - t0:.2f} s; {FAMILY_REQUESTS} x {prompt} prompt tokens"
          + (f", seeded normal {list(extra)}" if extra else ""), flush=True)

    # -- kernels vs plain path, bf16; keep the first launch of every shape ----
    taps = {}

    def tap(name, fn):
        def tapped(*a, **kw):
            key = (name, *(tuple(t.shape) for t in a[:2]), kw.get("causal"),
                   kw.get("inclusive"), a[0].dtype)
            if key not in taps:
                taps[key] = ([t.clone() for t in a], dict(kw))
            return fn(*a, **kw)
        return tapped

    scan_ops.chunked_scan_cuda = tap("chunked_scan_cuda", scan_kernel.chunked_scan_cuda)
    attn_ops.flash_attention_cuda = tap("flash_attention_cuda",
                                        attn_kernel.flash_attention_cuda)
    try:
        logits_k, cache = prefill(srv.model, srv.tokens, cfg, srv.flags, srv.extra,
                                  pad_to=srv.max_seq)
        assert logits_k.shape == (FAMILY_REQUESTS, 1, cfg.vocab)
        assert torch.isfinite(logits_k).all(), f"{arch}: prefill logits"
        tok = logits_k[:, -1].argmax(-1, keepdim=True)
        logits_d, cache = decode_step(srv.model, tok, cache, cfg, srv.flags)
        assert torch.isfinite(logits_d).all(), f"{arch}: decode logits"
    finally:
        scan_ops.chunked_scan_cuda = scan_kernel.chunked_scan_cuda
        attn_ops.flash_attention_cuda = attn_kernel.flash_attention_cuda
    del cache
    plain_flags = dataclasses.replace(srv.flags, use_kernels=False)
    run_plain = lambda m, c: prefill(m, srv.tokens, c, plain_flags, srv.extra)[0]
    logits_p = run_plain(srv.model, cfg)
    path_err = _rel_l2(logits_k[:, -1], logits_p[:, -1])
    # the bf16 rounding floor: the plain path again with its kernel-bearing
    # op summed in another exact order (attention: the kernel's twin; the
    # scan: the sequential recurrence)
    exact_attn, exact_scan = attn_ops.attention_ref, scan_ops.chunked_scan_plain
    attn_ops.attention_ref = attn_kernel.flash_attention_plain
    scan_ops.chunked_scan_plain = scan_ref
    try:
        logits_f = run_plain(srv.model, cfg)
    finally:
        attn_ops.attention_ref, scan_ops.chunked_scan_plain = exact_attn, exact_scan
    floor = _rel_l2(logits_f[:, -1], logits_p[:, -1])
    print(f"{arch} bf16 prefill, relative L2 of the last position's logits: kernels vs "
          f"plain path {path_err:.3e}; rounding floor {floor:.3e}", flush=True)
    assert path_err <= 2 * floor, (arch, path_err, floor)
    del logits_p, logits_f

    # -- the main path: serve.run (counts set to 0 just before, read after) --
    wrappers = {"chunked_scan_cuda": scan_kernel.chunked_scan_cuda,
                "flash_attention_cuda": attn_kernel.flash_attention_cuda}
    for w in wrappers.values():
        w.launches = 0
    result = serve.run(srv)
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"{arch} serve: { {k: v for k, v in result.items() if k != 'tokens'} }",
          flush=True)
    pre = dict(zip(wrappers, want_prefill))
    dec = {k: n * FAMILY_DECODE for k, n in zip(wrappers, want_decode)}
    assert result["launches"] == {"prefill": pre, "decode": dec}, (arch, result["launches"])
    assert launches == {k: pre[k] + dec[k] for k in wrappers}, (arch, launches)
    assert all(0 <= t < cfg.vocab for t in result["sample_output"]), result
    runs = [result] + [serve.run(srv) for _ in range(SERVE_RUNS - 1)]
    rates = {key: [r[key] for r in runs]
             for key in ("prefill_tokens_per_s", "decode_tokens_per_s")}
    print(f"{arch} serve, {SERVE_RUNS} runs: prefill tokens/s "
          f"{rates['prefill_tokens_per_s']}, decode tokens/s "
          f"{rates['decode_tokens_per_s']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    tokens, kernel_flags = srv.tokens, srv.flags
    UNSHARDED[arch] = {"tokens": result["tokens"], "logits": logits_k[:, -1].cpu(),
                       "floor": floor, "rates": rates}
    del srv, logits_k
    torch.cuda.empty_cache()

    # -- the same check in f32 (the same seed's weights, unrounded) ----------
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    model32 = init_params(torch.Generator(device="cuda").manual_seed(serve.SEED), cfg32,
                          device="cuda")
    l32k = prefill(model32, tokens, cfg32, kernel_flags, extra)[0]
    l32p = prefill(model32, tokens, cfg32, plain_flags, extra)[0]
    path_err32 = _rel_l2(l32k[:, -1], l32p[:, -1])
    print(f"{arch} f32 prefill, full depth: relative L2 of the last position's logits, "
          f"kernels vs plain path {path_err32:.3e} (limit {PATH_REL_L2_F32})", flush=True)
    assert path_err32 <= PATH_REL_L2_F32, (arch, path_err32)
    del model32, l32k, l32p
    torch.cuda.empty_cache()

    # -- each tapped launch against its twin, timed ---------------------------
    path = f"{arch} serve"
    entries = []
    for key, (a, kw) in taps.items():
        e = _kernel_check(key[0], a, kw, cfg.n_heads)
        e.update(path=path, launches=launches[key[0]], prefill_launches=pre[key[0]],
                 decode_launches_per_step=dec[key[0]] // FAMILY_DECODE,
                 prefill_tokens_per_s=result["prefill_tokens_per_s"],
                 decode_tokens_per_s=result["decode_tokens_per_s"],
                 prefill_tokens_per_s_runs=rates["prefill_tokens_per_s"],
                 decode_tokens_per_s_runs=rates["decode_tokens_per_s"],
                 path_rel_l2_bf16=path_err, path_rel_l2_floor_bf16=floor,
                 path_rel_l2_f32=path_err32, params_b=n_params / 1e9)
        entries.append(e)
        print(f"{e['name']} on {arch} {e['shape']}"
              + (f" causal={e['causal']} {e['dtype']}" if "causal" in e else
                 f" inclusive={e['inclusive']}")
              + f": {e['ms']:.4f} ms, plain {e['plain_ms']:.2f} ms, library "
              f"{e['library_ms'] if e['library_ms'] is None else round(e['library_ms'], 4)}"
              f" ms, bound {e['bound_ms']:.4f} ms ({e['bound_by']}), max abs err vs plain "
              f"{e['max_abs_err']:.3e} (max |plain| {e['max_abs_plain']:.3e})", flush=True)
    return entries, {path: launches}


def families_phase():
    """Steps 20-24: every family the port serves beside hybrid."""
    import torch

    paths, launches_by_path = [], {}
    torch.cuda.reset_peak_memory_stats()
    for step, (arch, prompt, pre, dec) in enumerate(FAMILIES, start=20):
        t0 = time.perf_counter()
        entries, launches = family_phase(arch, prompt, pre, dec)
        paths += entries
        launches_by_path.update(launches)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(f"step {step} ({arch}) took {time.perf_counter() - t0:.1f} s", flush=True)
    return paths, launches_by_path


# -- steps 25-26: training on the card ------------------------------------------
TRAIN_LR, TRAIN_WARMUP = 3e-3, 20           # launch/train.py's defaults
TRAIN_ARGV = ["--arch", "smollm-360m", "--batch", "8", "--seq", "256", "--lr",
              str(TRAIN_LR), "--ckpt-every", "10", "--log-every", "10", "--device", "cuda"]
TRAIN_STEPS, TRAIN_RESTART_STEPS, TRAIN_WARM = 30, 36, 3
MEMO_STEPS, MEMO_DROP = 10, 1.0
GRAD_LAYERS, GRAD_BATCH, GRAD_SEQ = 2, 2, 64
GRAD_LOSS_REL, GRAD_LEAF_REL, ADAMW_PARAM_REL = 1e-5, 1e-4, 1e-5
FAMILY_TRAIN = (  # arch, the fewest layers (groups) that keep its structure
    ("granite-moe-1b-a400m", {"n_layers": 2}),
    ("rwkv6-1.6b", {"n_layers": 2}),
    ("zamba2-2.7b", {"n_layers": 6}),                    # one group: 6 Mamba2 + shared
    ("whisper-base", {"n_layers": 2, "enc_layers": 2}),
    ("llama-3.2-vision-11b", {"n_layers": 5}),           # one group: 4 self + 1 cross
)
FAMILY_TRAIN_BATCH, FAMILY_TRAIN_SEQ = 2, 256


def _all_wrappers():
    from repro_torch.kernels.flash_attention import kernel as attn_kernel
    from repro_torch.kernels.sptrsv import kernel
    from repro_torch.kernels.ssd_scan import kernel as scan_kernel

    return {"sptrsv_cuda": kernel.sptrsv_cuda,
            "sptrsv_cuda_blocked": kernel.sptrsv_cuda_blocked,
            "chunked_scan_cuda": scan_kernel.chunked_scan_cuda,
            "flash_attention_cuda": attn_kernel.flash_attention_cuda}


def _adamw_param_check(got, want, m_got, m_want, lr):
    """Per leaf relative L2 of the parameters after one AdamW step, leaving
    out the entries whose gradient the two runs do not resolve: the new
    moments differ by more than 10%.  There AdamW's lr * m / sqrt(v) turns
    rounding into an update of up to lr of either sign, so those entries
    are held to 2.01 * lr elementwise (|m_hat / sqrt(v_hat)| <= 1 at step
    1) and must have near-zero moments (at most 1e-4 of the leaf's
    largest).  Arguments: {parameter name: host tensor}.  Returns (worst
    relative L2, entries left out)."""
    worst, left_out = 0.0, 0
    for key, w in want.items():
        g, mw = got[key].float(), m_want[key]
        loose = (m_got[key] - mw).abs() > 0.1 * mw.abs()
        assert (mw[loose].abs() <= 1e-4 * mw.abs().max()).all(), key
        err = ((g[~loose] - w[~loose]).norm() / w[~loose].norm()).item()
        assert err <= ADAMW_PARAM_REL, (key, err)
        assert ((g[loose] - w[loose]).abs() <= 2.01 * lr).all(), key
        worst, left_out = max(worst, err), left_out + int(loose.sum())
    return worst, left_out


def _train_restart(ckpt_dir):
    """Step 25: smollm-360m trained at full width and depth through
    launch/train.main, then restarted from its checkpoint."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = TRAIN_ARGV + ["--ckpt-dir", ckpt_dir]
    wrappers = _all_wrappers()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    r1 = train.main(argv + ["--steps", str(TRAIN_STEPS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = float(np.median(r1["step_ms"][TRAIN_WARM:]))
    batch, seq = int(argv[argv.index("--batch") + 1]), int(argv[argv.index("--seq") + 1])
    ckpt_gib = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(ckpt_dir)
                   for f in fs) / 2**30
    print(f"step 25, smollm-360m training (B={batch}, S={seq}, bf16 compute over f32 "
          f"master weights, {TRAIN_STEPS} steps, remat, AdamW, checkpoints every 10): "
          f"loss step 1 {r1['first_loss']:.4f}, step {TRAIN_STEPS} {r1['last_loss']:.4f}; "
          f"median step {step_ms:.2f} ms after {TRAIN_WARM} (first {r1['step_ms'][0]:.1f} "
          f"ms), {batch * seq / step_ms * 1e3:.0f} tokens/s, peak {peak:.2f} GiB, "
          f"{wall:.1f} s in all, checkpoints on disk {ckpt_gib:.2f} GiB; launches "
          f"{launches}", flush=True)
    assert r1["steps"] == TRAIN_STEPS and np.isfinite(r1["step_ms"]).all()
    # no check that loss 30 < loss 1: at lr 3e-3 and warmup 20 the
    # reference's own trainer raises the loss over these 30 batches too, at
    # full width cut to 2 layers on the CPU (10.989 -> 11.164; the port
    # 11.130; scripts/train_curves.py, PERF.md Findings).  30 batches hold
    # 61,440 tokens against the chain's 1.57 M transitions (8 tables x
    # 49,152 tokens x 4 successors), so few repeat and there is little to
    # learn past ln(vocab) = 10.80; the reference was not run at all 32
    # layers.  _memorize shows the step learns.
    assert np.isfinite(r1["first_loss"]) and np.isfinite(r1["last_loss"])
    assert not any(launches.values()), launches    # the reference trains on plain paths
    assert latest_step(ckpt_dir) == TRAIN_STEPS

    t0 = time.perf_counter()
    r2 = train.main(argv + ["--steps", str(TRAIN_RESTART_STEPS)])
    restart_s = time.perf_counter() - t0
    print(f"step 25 restart with --steps {TRAIN_RESTART_STEPS}: resumed at "
          f"{TRAIN_STEPS}, took {r2['steps']} steps, loss {r2['first_loss']:.4f} -> "
          f"{r2['last_loss']:.4f}, {restart_s:.1f} s", flush=True)
    assert r2["steps"] == TRAIN_RESTART_STEPS - TRAIN_STEPS, r2
    assert np.isfinite(r2["last_loss"])
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    memo = _memorize(TRAIN_ARGV + ["--steps", str(TRAIN_STEPS)])
    return {"path": "smollm-360m train", "batch": batch, "seq": seq, "memorize": memo,
            "steps": TRAIN_STEPS, "loss_first": r1["first_loss"], "losses": r1["losses"],
            "loss_last": r1["last_loss"], "step_ms_median": step_ms,
            "step_ms": r1["step_ms"], "tokens_per_s": batch * seq / step_ms * 1e3,
            "peak_gib": peak, "checkpoint_gib": ckpt_gib, "launches": launches,
            "restart_steps": r2["steps"], "restart_s": restart_s}


def _memorize(argv):
    """The train step learns: MEMO_STEPS steps of train.setup's trainer
    (launch/train.py's model, lr and warmup, from its flags ``argv``) on one
    fixed batch of its data lower that batch's loss by more than MEMO_DROP
    (a factor e of perplexity)."""
    import numpy as np
    import torch

    from repro_torch.launch import train

    tr = train.setup(train.parse_args(argv))
    fixed = tr.batch(0)
    losses = [float(tr.train_step(tr.model, tr.opt_state, fixed)["loss"])
              for _ in range(MEMO_STEPS)]
    print(f"step 25, {MEMO_STEPS} steps on one fixed batch (lr {TRAIN_LR}, warmup "
          f"{TRAIN_WARMUP}): loss " + " ".join(f"{x:.3f}" for x in losses), flush=True)
    assert np.isfinite(losses).all() and losses[-1] < losses[0] - MEMO_DROP, losses
    del tr
    torch.cuda.empty_cache()
    return losses


def _grad_check():
    """Step 26a: smollm-360m at full width, f32, GRAD_LAYERS layers: loss,
    every gradient leaf and one AdamW step on the card against the CPU on
    the same weights."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import RuntimeFlags, init_params, train_forward
    from repro_torch.optim import adamw_init

    host = lambda named: {n: t.detach().cpu() for n, t in named.items()}
    cfg = dataclasses.replace(get_config("smollm-360m"), n_layers=GRAD_LAYERS,
                              dtype="float32")
    cpu = init_params(torch.Generator().manual_seed(SEED), cfg, device="cpu")
    gpu = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(SEED)
    tokens, labels = (torch.from_numpy(rng.integers(0, cfg.vocab, (GRAD_BATCH, GRAD_SEQ)))
                      for _ in range(2))
    flags = RuntimeFlags(use_kernels=False, remat=True)
    out = {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        dev = next(model.parameters()).device
        model.requires_grad_(True)
        loss, _ = train_forward(model, tokens.to(dev), labels.to(dev), cfg, flags)
        loss.backward()
        out[name] = (loss.item(), host({n: p.grad for n, p in model.named_parameters()}))
        model.zero_grad(set_to_none=True)
    loss_rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    want, got = out["cpu"][1], out["cuda"][1]
    grad_rel = {k: ((got[k] - w).norm() / w.norm()).item() for k, w in want.items()}
    assert loss_rel <= GRAD_LOSS_REL, loss_rel
    assert max(grad_rel.values()) <= GRAD_LEAF_REL, grad_rel

    step = make_train_step(cfg, flags, lr=TRAIN_LR, warmup=TRAIN_WARMUP, total=TRAIN_STEPS)
    opts, mets = {}, {}
    for name, model in (("cpu", cpu), ("cuda", gpu)):
        dev = next(model.parameters()).device
        opts[name] = adamw_init(model)
        mets[name] = step(model, opts[name], {"tokens": tokens.to(dev),
                                              "labels": labels.to(dev)})
    param_rel, left_out = _adamw_param_check(
        host(dict(gpu.named_parameters())), host(dict(cpu.named_parameters())),
        host(opts["cuda"]["m"]), opts["cpu"]["m"], mets["cpu"]["lr"])
    print(f"step 26, the gradient on the card vs the CPU (smollm-360m full width, f32, "
          f"{GRAD_LAYERS} layers, B={GRAD_BATCH}, S={GRAD_SEQ}, same weights): loss "
          f"{out['cpu'][0]:.6f}, relative difference {loss_rel:.2e} (limit "
          f"{GRAD_LOSS_REL}); worst gradient leaf relative L2 {max(grad_rel.values()):.2e} "
          f"({max(grad_rel, key=grad_rel.get)}, limit {GRAD_LEAF_REL}) over {len(want)} "
          f"leaves; one AdamW step: grad norm {float(mets['cuda']['grad_norm']):.5f} vs "
          f"{float(mets['cpu']['grad_norm']):.5f}, worst parameter leaf relative L2 "
          f"{param_rel:.2e} (limit {ADAMW_PARAM_REL}; {left_out} entries whose moments "
          f"differ by over 10%, held to 2 lr instead)", flush=True)
    del cpu, gpu
    return {"path": "smollm-360m gradient cuda vs cpu", "loss_rel": loss_rel,
            "grad_leaf_rel_l2_max": max(grad_rel.values()), "adamw_param_rel_l2_max":
            param_rel, "adamw_entries_unresolved": left_out}


def _family_train_step(arch, cut):
    """Step 26b: one train_step of ``arch`` at full width, bf16 compute over
    f32 master weights, at the fewest layers (groups) that keep its
    structure."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import RuntimeFlags, init_params
    from repro_torch.optim import adamw_init

    cfg = dataclasses.replace(get_config(arch), **cut)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(torch.Generator(device="cuda").manual_seed(SEED), cfg,
                        device="cuda", param_dtype=torch.float32)
    opt = adamw_init(model)
    rng = np.random.default_rng(SEED)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (FAMILY_TRAIN_BATCH,
                                                               FAMILY_TRAIN_SEQ))).cuda()
             for k in ("tokens", "labels")}
    batch.update(_seeded_extra(cfg, FAMILY_TRAIN_BATCH))
    wrappers = _all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    step = make_train_step(cfg, RuntimeFlags(use_kernels=False, remat=True), lr=TRAIN_LR,
                           warmup=TRAIN_WARMUP, total=TRAIN_STEPS)
    t0 = time.perf_counter()
    met = step(model, opt, batch)
    loss, gnorm, aux = (float(met[k]) for k in ("loss", "grad_norm", "aux"))
    ms = (time.perf_counter() - t0) * 1e3
    launches = {k: w.launches for k, w in wrappers.items()}
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"step 26 {arch} ({cfg.family}, {cut}, {n_params / 1e9:.3f} B parameters, "
          f"B={FAMILY_TRAIN_BATCH}, S={FAMILY_TRAIN_SEQ}): loss {loss:.4f}, aux {aux:.4f}, "
          f"grad norm {gnorm:.4f}, first step {ms:.0f} ms, peak {peak:.2f} GiB, launches "
          f"{launches}", flush=True)
    assert np.isfinite(loss) and np.isfinite(gnorm) and gnorm > 0, (arch, met)
    assert cfg.family != "moe" or aux > 0, (arch, aux)
    assert not any(launches.values()), launches
    del model, opt
    return {"path": f"{arch} train step", "family": cfg.family, "cut": cut,
            "params_b": n_params / 1e9, "loss": loss, "aux": aux, "grad_norm": gnorm,
            "first_step_ms": ms, "peak_gib": peak, "launches": launches}


def train_phase():
    """Steps 25-26.  Returns the training records and {path: {kernel:
    launches}} (all zero: training runs the plain paths, as the
    reference's does)."""
    import torch

    records = [_train_restart(os.path.join(ROOT, "build", "train_ckpt"))]
    UNSHARDED["train_losses"] = records[0]["losses"]
    UNSHARDED["train_step_ms"] = records[0]["step_ms"]
    records.append(_grad_check())
    for arch, cut in FAMILY_TRAIN:
        t0 = time.perf_counter()
        records.append(_family_train_step(arch, cut))
        torch.cuda.empty_cache()
        print(f"step 26 ({arch}) took {time.perf_counter() - t0:.1f} s", flush=True)
    return records, {r["path"]: r["launches"] for r in records if "launches" in r}


# -- steps 27-29: the device mesh -------------------------------------------------
# Zamba2 (steps 12-14) and the five families of steps 20-24
MESH_FAMILIES = (("zamba2-2.7b", 1000, (54, 9), (0, 0)),) + FAMILIES
MESH_TRAIN_STEPS, MESH_RESTART_STEPS, MESH_LOSS_REL = 5, 7, 1e-5
DRYRUN_CELL = ("granite-8b", "train_4k", "pod")
DRYRUN_TIMEOUT_S = 300
# launch/hlo_analysis.py on a fake world of 4: a replicated product counts its
# full 2*m*k*n per device, a column-sharded one a quarter, a row-sharded one a
# quarter plus one all-reduce of its [m, n] f32 result
COUNT_CHECK = """
import sys, torch
sys.path.insert(0, "src")
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch import dryrun, hlo_analysis
from torch.distributed.device_mesh import init_device_mesh
dryrun.fake_world(4)
mesh = init_device_mesh("cpu", (1, 4), mesh_dim_names=("data", "model"))
m, k, n = 64, 32, 48
put = lambda shape, p: distribute_tensor(torch.empty(shape, device="meta"), mesh,
                                         [Replicate(), p], src_data_rank=None)
x = put((m, k), Replicate())
count = lambda w, red=False: hlo_analysis.analyze_step(
    lambda: (x @ w).redistribute(mesh, [Replicate(), Replicate()]) if red else x @ w)
rep, col, row = count(put((k, n), Replicate())), count(put((k, n), Shard(1))), \
    count(put((k, n), Shard(0)), red=True)
assert rep["dot_flops"] == 2 * m * k * n, rep
assert col["dot_flops"] == 2 * m * k * n / 4 and col.collective_bytes == 0, col
assert row["dot_flops"] == 2 * m * k * n / 4, row
assert row["coll/all-reduce"] == m * n * 4, row
print("count check", rep["dot_flops"], col["dot_flops"], row["dot_flops"],
      row["coll/all-reduce"])
"""


def _mesh_serve(mesh, arch, prompt, want_prefill, want_decode, smi):
    """Step 27 for one model: launch/serve.py on ``mesh`` (make_local_mesh():
    the card's world of one, mesh (1, 1), NCCL) against steps 12-14 or
    20-24 on no mesh: the same greedy tokens, the prefill's last logits
    within those steps' bf16 limit (twice the rounding floor), the same
    launches per phase."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import full_tensor
    from repro_torch.launch import serve
    from repro_torch.models import prefill

    want = UNSHARDED[arch]
    args = serve.parse_args(["--arch", arch, "--requests", str(FAMILY_REQUESTS),
                             "--prefill-len", str(prompt), "--decode-steps",
                             str(FAMILY_DECODE)])
    cfg = serve.get_config(arch)
    srv = serve.setup(args, extra=_seeded_extra(cfg, FAMILY_REQUESTS), mesh=mesh)
    assert all(isinstance(p, DTensor) for p in srv.model.parameters())
    logits, _ = prefill(srv.model, srv.tokens, cfg, srv.flags, srv.extra,
                        pad_to=srv.max_seq)
    assert isinstance(logits, DTensor)
    err = _rel_l2(full_tensor(logits)[:, -1].cpu(), want["logits"])
    print(f"step 27 {arch} on the mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
          f"(NCCL, world of one): prefill's last logits vs no mesh, relative "
          f"L2 {err:.3e} (limit 2 x floor {2 * want['floor']:.3e})", flush=True)
    assert err <= 2 * want["floor"], (arch, err, want["floor"])
    del logits
    wrappers = {k: w for k, w in _all_wrappers().items() if k in ("chunked_scan_cuda",
                                                                  "flash_attention_cuda")}
    for w in wrappers.values():
        w.launches = 0
    result = serve.run(srv)
    launches = {k: w.launches for k, w in wrappers.items()}
    pre = dict(zip(wrappers, want_prefill))
    dec = {k: n * FAMILY_DECODE for k, n in zip(wrappers, want_decode)}
    assert result["launches"] == {"prefill": pre, "decode": dec}, (arch, result["launches"])
    assert launches == {k: pre[k] + dec[k] for k in wrappers}, (arch, launches)
    assert result["tokens"] == want["tokens"], f"{arch}: greedy tokens differ on the mesh"
    runs = [result] + [serve.run(srv) for _ in range(SERVE_RUNS - 1)]
    rates = {key: [r[key] for r in runs]
             for key in ("prefill_tokens_per_s", "decode_tokens_per_s")}
    print(f"step 27 {arch} serve on the mesh: {FAMILY_REQUESTS} x {FAMILY_DECODE} greedy "
          f"tokens equal those on no mesh; launches {result['launches']}; {SERVE_RUNS} runs "
          f"({smi}): prefill tokens/s {rates['prefill_tokens_per_s']} (no mesh "
          f"{want['rates']['prefill_tokens_per_s']}), decode tokens/s "
          f"{rates['decode_tokens_per_s']} (no mesh {want['rates']['decode_tokens_per_s']})",
          flush=True)
    del srv
    torch.cuda.empty_cache()
    return {"path": f"{arch} serve on the mesh", "mesh": [1, 1], "rel_l2_vs_no_mesh": err,
            "launches": launches, "prefill_tokens_per_s_runs": rates["prefill_tokens_per_s"],
            "decode_tokens_per_s_runs": rates["decode_tokens_per_s"],
            "no_mesh_rates": want["rates"]}


def _mesh_train(mesh, ckpt_dir, smi):
    """Step 28: launch/train.py on ``mesh`` (smollm-360m at full
    width and depth, step 25's arguments) for MESH_TRAIN_STEPS steps: the
    losses equal step 25's; the checkpoint's layout (host_0.npz, meta.json,
    COMMITTED), then a restart restores it and continues on step 25's
    trajectory."""
    import shutil

    import numpy as np
    import torch

    from repro_torch.launch import train

    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = TRAIN_ARGV + ["--ckpt-dir", ckpt_dir, "--ckpt-every", str(MESH_TRAIN_STEPS)]
    want = UNSHARDED["train_losses"]
    wrappers = _all_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    r1 = train.main(argv + ["--steps", str(MESH_TRAIN_STEPS)], mesh=mesh)
    launches = {k: w.launches for k, w in wrappers.items()}
    rel = [abs(a - b) / abs(b) for a, b in zip(r1["losses"], want)]
    step_ms = float(np.median(r1["step_ms"][1:]))
    print(f"step 28 smollm-360m training on the mesh (1, 1) ({smi}): losses "
          + " ".join(f"{x:.5f}" for x in r1["losses"]) + f"; step 25 (no mesh) "
          + " ".join(f"{x:.5f}" for x in want[:MESH_TRAIN_STEPS])
          + f"; worst relative difference {max(rel):.2e} (limit {MESH_LOSS_REL}); median "
          f"step {step_ms:.2f} ms after the first (step 25: "
          f"{float(np.median(UNSHARDED['train_step_ms'][TRAIN_WARM:])):.2f} ms), peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    assert r1["steps"] == MESH_TRAIN_STEPS and max(rel) <= MESH_LOSS_REL, (rel, r1)
    assert not any(launches.values()), launches
    step_dir = os.path.join(ckpt_dir, f"step_{MESH_TRAIN_STEPS:08d}")
    files = sorted(os.listdir(step_dir))
    assert files == ["COMMITTED", "host_0.npz", "meta.json"], files
    r2 = train.main(argv + ["--steps", str(MESH_RESTART_STEPS)], mesh=mesh)
    rel2 = [abs(a - b) / abs(b) for a, b in
            zip(r2["losses"], want[MESH_TRAIN_STEPS:MESH_RESTART_STEPS])]
    print(f"step 28 checkpoint {files} at step {MESH_TRAIN_STEPS}; restart with --steps "
          f"{MESH_RESTART_STEPS} took {r2['steps']} steps, losses "
          + " ".join(f"{x:.5f}" for x in r2["losses"])
          + f", worst relative difference to step 25's {max(rel2):.2e}", flush=True)
    assert r2["steps"] == MESH_RESTART_STEPS - MESH_TRAIN_STEPS, r2
    assert max(rel2) <= MESH_LOSS_REL, rel2
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"path": "smollm-360m train on the mesh", "losses": r1["losses"],
            "loss_rel_max": max(rel), "restart_loss_rel_max": max(rel2),
            "step_ms": r1["step_ms"], "checkpoint_files": files, "launches": launches}


def _dryrun(smi):
    """Step 29 (host only): launch/dryrun.py for DRYRUN_CELL on a fake
    process group of 256 ranks, in a process of its own; the per-device
    arguments must fit the card's memory."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import roofline

    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    check = subprocess.run([sys.executable, "-c", COUNT_CHECK], capture_output=True,
                           text=True, cwd=ROOT, env=env, timeout=DRYRUN_TIMEOUT_S)
    assert check.returncode == 0, check.stderr[-3000:]
    print(f"step 29 {check.stdout.strip()}", flush=True)
    arch, shape, mesh = DRYRUN_CELL
    out_dir = os.path.join(ROOT, "build", "dryrun")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                          "--shape", shape, "--mesh", mesh, "--out", out_dir],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=DRYRUN_TIMEOUT_S)
    cell_s = time.perf_counter() - t0
    assert run.returncode == 0, run.stderr[-3000:]
    with open(os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")) as f:
        rec = json.load(f)
    row = roofline.analyze_record(rec)
    mem = rec["memory_analysis"]
    card = torch.cuda.get_device_properties(0).total_memory
    gib = lambda b: b / 2**30
    print(f"step 29 dry run {arch} x {shape} x {mesh} ({rec['devices']} fake ranks, meta "
          f"tensors, {cell_s:.1f} s in all: arguments built in {rec['lower_s']} s, step "
          f"traced in {rec['compile_s']} s): per-device arguments "
          f"{gib(mem['argument_size_in_bytes']):.3f} GiB, outputs "
          f"{gib(mem['output_size_in_bytes']):.3f} GiB, against the card's "
          f"{gib(card):.2f} GiB ({smi}); largest single collective result "
          f"{gib(rec['hlo']['largest_collective_bytes']):.3f} GiB a device (a temporary the "
          f"arguments leave out); per-device dot_flops {rec['hlo']['dot_flops']:.4e}, "
          f"hbm_bytes {rec['hlo']['hbm_bytes']:.4e}, collective bytes "
          f"{rec['collective_bytes']:.4e} "
          f"({ {k: v for k, v in rec['hlo'].items() if k.startswith('coll/') and v} }); "
          f"roofline (H100 datasheet peaks): compute {row['compute_s']:.4e} s, memory "
          f"{row['memory_s']:.4e} s, collective {row['collective_s']:.4e} s, dominant "
          f"{row['dominant']}, useful/counted {row['useful_ratio']:.3f}, roofline fraction "
          f"{row['roofline_fraction']:.4f}", flush=True)
    assert mem["argument_size_in_bytes"] < card, (mem, card)
    assert rec["hlo"]["dot_flops"] > 0 and rec["devices"] == 256
    return {"path": f"dry run {arch} x {shape} x {mesh}", "record": rec, "roofline": row,
            "cell_s": cell_s, "card_bytes": card}


def mesh_phase(smi):
    """Steps 27-29.  Returns the records and {path: {kernel: launches}}."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    records = []
    try:
        mesh = make_local_mesh()
        assert tuple(mesh.shape) == (1, 1) and dist.get_backend() == "nccl", mesh
        for step_arch in MESH_FAMILIES:
            t0 = time.perf_counter()
            records.append(_mesh_serve(mesh, *step_arch, smi))
            print(f"step 27 ({step_arch[0]}) took {time.perf_counter() - t0:.1f} s",
                  flush=True)
        t0 = time.perf_counter()
        records.append(_mesh_train(mesh, os.path.join(ROOT, "build", "mesh_ckpt"), smi))
        print(f"step 28 took {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    records.append(_dryrun(smi))
    return records, {r["path"]: r["launches"] for r in records if "launches" in r}


# -- steps 30-34: the user entry points outside src/ ----------------------------
LINT_ARGV = ["--matrix", "ckt_rajat04", "--schedule", "paper", "--frontier"]
TRAIN_LM_CHECKPOINTS = [100, 200, 300]


def _load_entry(relpath):
    """An example or script of the repository, imported from its path."""
    import importlib.util

    path = os.path.join(ROOT, relpath)
    spec = importlib.util.spec_from_file_location(os.path.basename(path)[:-3], path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _drive_all(what, fn, launches_by_path):
    """`_drive` over all four kernels, its launches recorded under ``what``."""
    out, launches_by_path[what] = _drive(_all_wrappers(), what, fn)
    return out, launches_by_path[what]


def _sptrsv_path_entry(path, prog, mat, bmat, placement, x_ref):
    """The SpTRSV launch a ``placement`` solver of ``bmat``'s width makes on
    ``prog``: held against its plain version on the same staged inputs
    (RTOL), timed (CUDA events), beside the card's bound and cuSPARSE on
    the same triangle, whose x is held against ``x_ref``."""
    import torch

    from repro_torch.kernels.sptrsv import ops

    nb = bmat.shape[1]
    core = ops.build_solver_cols(prog, nb, placement=placement, device="cuda")
    kname, launch, plain, bp, _ = _staged_launch(prog, core, bmat)
    xk = launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    xp = plain()
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = _close(xk[:prog.n].cpu().numpy(), xp[:prog.n].cpu().numpy(),
                 f"{kname} on {path} vs its plain version")
    launch()
    ms = _event_ms(launch, 10)
    xl, library_ms = _library_solve(mat.rowptr, mat.colidx, mat.values,
                                    bp[:prog.n].contiguous(), upper=False)
    _close(xl.cpu().numpy(), x_ref, f"{path} library solve vs serial_solve")
    bound_ms, bound_by = _sptrsv_bound_ms(prog, nb)
    print(f"{kname} on {path}: {ms:.4f} ms, plain {plain_ms:.1f} ms, library "
          f"{library_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}), max abs err vs "
          f"plain {err:.3e}, {prog.cycles} emitted cycles, B={nb}", flush=True)
    return {"path": path, "name": kname, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[kname], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "n": prog.n, "nnz": prog.stats.nnz, "B": nb,
            "emitted_cycles": prog.cycles, "placement": core.placement,
            "x_in_smem": core.x_in_smem}


def _quickstart(launches_by_path):
    """Step 30: examples/torch_quickstart.py on the card."""
    import numpy as np

    from repro_torch.core import api

    qs = _load_entry("examples/torch_quickstart.py")
    out, launches = _drive_all("torch_quickstart", lambda: qs.main([]), launches_by_path)
    blk = out["blocked"]
    print(f"step 30, torch_quickstart: step 6 placement {blk['placement']}, window "
          f"{blk['window']} rows, stride {blk['stride']}, {blk['num_blocks']} blocks, "
          f"launches {blk['launches']}, max abs err {blk['max_err']:.3e} (max |x_ref| "
          f"{blk['max_ref']:.3e}); step 7 cycles {out['cycles']}", flush=True)
    assert blk["placement"] == "blocked", blk
    assert blk["launches"] == {"sptrsv_cuda": 0, "sptrsv_cuda_blocked": 1}, blk
    assert blk["max_err"] <= RTOL * blk["max_ref"], blk
    assert launches["sptrsv_cuda_blocked"] >= 1 and launches["sptrsv_cuda"] >= 1, launches
    assert not launches["chunked_scan_cuda"] and not launches["flash_attention_cuda"]
    assert out["cycles"]["medium"] < min(out["cycles"]["coarse"], out["cycles"]["fine"])
    # step 6's launch at its shapes, against its plain version, timed
    band = api.matrix("band_cz")
    bb = np.random.default_rng(SEED).standard_normal((band.n, 8))
    x_ref = np.stack([api.reference_solve(band, bb[:, j]) for j in range(8)], axis=1)
    entry = _sptrsv_path_entry("torch_quickstart step 6 (band_cz, blocked)",
                               api.compile(band), band, bb, "blocked", x_ref)
    entry.update(launches=blk["launches"]["sptrsv_cuda_blocked"],
                 window=blk["window"], stride=blk["stride"], num_blocks=blk["num_blocks"])
    return {"path": "torch_quickstart", "cycles": out["cycles"], "blocked": blk}, [entry]


def _ssm(launches_by_path):
    """Step 31: examples/torch_ssm_as_sptrsv.py at the reference's sizes."""
    import torch

    from repro_torch.core import api
    from repro_torch.kernels.ssd_scan import kernel as scan_kernel
    from repro_torch.kernels.ssd_scan import ops as scan_ops

    ssm = _load_entry("examples/torch_ssm_as_sptrsv.py")
    calls = []
    scan_ops.chunked_scan_cuda = _tap(calls, scan_kernel.chunked_scan_cuda)
    try:
        out, launches = _drive_all("torch_ssm_as_sptrsv", lambda: ssm.main([]),
                                   launches_by_path)
    finally:
        scan_ops.chunked_scan_cuda = scan_kernel.chunked_scan_cuda
    assert all(out["checks"].values()), out["checks"]
    # medium ran once to warm up and 3 times timed; nothing else launches
    assert launches == {"sptrsv_cuda": 0, "sptrsv_cuda_blocked": 0,
                        "chunked_scan_cuda": 4, "flash_attention_cuda": 0}, launches
    inputs = out["inputs"]
    _, one = _drive_all("torch_ssm_as_sptrsv medium, one call",
                        lambda: ssm.medium(*inputs), {})
    assert one["chunked_scan_cuda"] == 1, one
    y = ssm.medium(*inputs)
    y_plain, _ = scan_ops.linear_recurrence(*inputs, use_kernels=False)
    err_path = (y - y_plain).abs().max().item()
    scale_path = y_plain.abs().max().item()
    assert err_path <= SCAN_REL * scale_path, (err_path, scale_path)
    b, seq, h, kdim = inputs[0].shape
    e = _kernel_check("chunked_scan_cuda", *calls[0], h)
    e.update(path="torch_ssm_as_sptrsv medium", launches=launches["chunked_scan_cuda"],
             launches_per_call=one["chunked_scan_cuda"], granularity_ms=out["ms"],
             medium_vs_plain_path_max_abs_err=err_path)
    print(f"step 31, torch_ssm_as_sptrsv [B={b}, L={seq}, H={h}, K={kdim}, "
          f"V={inputs[2].shape[3]}]: coarse {out['ms']['coarse']:.2f} ms, medium "
          f"{out['ms']['medium']:.3f} ms, fine {out['ms']['fine']:.2f} ms a call; "
          f"chunked_scan_cuda {e['shape']}: {e['ms']:.4f} ms, bound {e['bound_ms']:.4f} ms "
          f"({e['bound_by']}), plain {e['plain_ms']:.2f} ms, {one['chunked_scan_cuda']} "
          f"launch a call, max abs err vs plain {e['max_abs_err']:.3e} (max |plain| "
          f"{e['max_abs_plain']:.3e}); medium vs the plain path {err_path:.3e}; checks "
          f"{out['checks']}", flush=True)
    # the bidiagonal program through the resident kernel
    prog, mat, U, H_ref = out["prog"], out["mat"], out["U"], out["H_ref"]
    solver = api.make_solver(prog, batch=U.shape[1], backend="cuda")
    assert solver.placement == "resident", solver.placement
    x, sl = _drive_all("torch_ssm_as_sptrsv bidiagonal solve", lambda: solver(U),
                       launches_by_path)
    assert sl == {"sptrsv_cuda": 1, "sptrsv_cuda_blocked": 0, "chunked_scan_cuda": 0,
                  "flash_attention_cuda": 0}, sl
    err = _close(x.cpu().numpy(), H_ref, "bidiagonal solve vs serial_solve")
    s = _sptrsv_path_entry("torch_ssm_as_sptrsv bidiagonal (n=512)", prog, mat, U,
                           "resident", H_ref)
    s.update(launches=sl["sptrsv_cuda"], max_abs_err_vs_serial=err)
    record = {"path": "torch_ssm_as_sptrsv", "ms": out["ms"], "checks": out["checks"]}
    del out, inputs, y, y_plain
    torch.cuda.empty_cache()
    return record, [e, s]


def _serve_batch(launches_by_path):
    """Step 32: examples/torch_serve_batch.py (granite-moe-1b-a400m reduced)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as attn_kernel
    from repro_torch.kernels.flash_attention import ops as attn_ops

    sb = _load_entry("examples/torch_serve_batch.py")
    cfg = get_config("granite-moe-1b-a400m").reduced()
    calls = []
    attn_ops.flash_attention_cuda = _tap(calls, attn_kernel.flash_attention_cuda)
    try:
        out, launches = _drive_all("torch_serve_batch", lambda: sb.main([]),
                                   launches_by_path)
    finally:
        attn_ops.flash_attention_cuda = attn_kernel.flash_attention_cuda
    zero = {"chunked_scan_cuda": 0, "flash_attention_cuda": 0}
    assert out["decode_tokens_per_s"] > 0 and out["device"].startswith("cuda"), out
    assert out["launches"] == {"prefill": dict(zero, flash_attention_cuda=cfg.n_layers),
                               "decode": zero}, out["launches"]
    assert launches["flash_attention_cuda"] == cfg.n_layers, launches
    warm = sb.main([])
    e = _kernel_check("flash_attention_cuda", *calls[0], cfg.n_heads)
    e.update(path="torch_serve_batch (granite-moe-1b-a400m reduced) prefill",
             launches=launches["flash_attention_cuda"],
             prefill_tokens_per_s=out["prefill_tokens_per_s"],
             decode_tokens_per_s=out["decode_tokens_per_s"],
             warm_prefill_tokens_per_s=warm["prefill_tokens_per_s"],
             warm_decode_tokens_per_s=warm["decode_tokens_per_s"])
    print(f"step 32, torch_serve_batch: prefill {out['prefill_tokens_per_s']:.1f} tok/s, "
          f"decode {out['decode_tokens_per_s']:.1f} tok/s (a second run: "
          f"{warm['prefill_tokens_per_s']:.1f}, {warm['decode_tokens_per_s']:.1f}), "
          f"launches {out['launches']}; "
          f"flash_attention_cuda {e['shape']} {e['dtype']}: {e['ms']:.4f} ms, "
          f"scaled_dot_product_attention {e['library_ms']:.4f} ms, bound "
          f"{e['bound_ms']:.6f} ms, max abs err vs plain {e['max_abs_err']:.3e}",
          flush=True)
    return {"path": "torch_serve_batch", "prefill_tokens_per_s": out["prefill_tokens_per_s"],
            "decode_tokens_per_s": out["decode_tokens_per_s"],
            "warm_prefill_tokens_per_s": warm["prefill_tokens_per_s"],
            "warm_decode_tokens_per_s": warm["decode_tokens_per_s"],
            "launches": out["launches"]}, [e]


def _train_lm(launches_by_path):
    """Step 33: examples/torch_train_lm.py, lm-100m at full width and depth,
    the reference example's 300 steps."""
    import shutil

    import numpy as np
    import torch

    tl = _load_entry("examples/torch_train_lm.py")
    ckpt_dir = os.path.join(ROOT, "build", "train_lm_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r, launches = _drive_all("torch_train_lm", lambda: tl.main(["--ckpt-dir", ckpt_dir]),
                             launches_by_path)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    committed = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                       if os.path.exists(os.path.join(ckpt_dir, d, "COMMITTED")))
    step_ms = float(np.median(r["step_ms"][TRAIN_WARM:]))
    tokens = 4 * 256
    print(f"step 33, torch_train_lm (lm-100m, B=4, S=256, lr 1e-3, 300 steps): loss "
          f"step 1 {r['first_loss']:.4f}, step {r['steps']} {r['last_loss']:.4f}; median "
          f"step {step_ms:.2f} ms after {TRAIN_WARM}, {tokens / step_ms * 1e3:.0f} tokens/s, "
          f"peak {peak:.2f} GiB, {wall:.1f} s in all; committed checkpoints {committed}; "
          f"launches {launches}", flush=True)
    # tl.main has already asserted the example's own check, last loss below
    # the first.  Over these 300 fresh batches the loss of either package
    # stays within ~0.1 of its start, near ln(32768) = 10.40, far from the
    # docstring's ln 4 (lm-100m cut to 2 layers on the CPU,
    # scripts/train_curves.py; PERF.md, PR 20), so the check holds by a
    # margin of a few hundredths.
    assert r["steps"] == 300 and np.isfinite(r["losses"]).all(), r["steps"]
    assert committed == TRAIN_LM_CHECKPOINTS, committed
    assert not any(launches.values()), launches
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"path": "torch_train_lm", "loss_first": r["first_loss"],
            "loss_last": r["last_loss"], "losses": r["losses"], "steps": r["steps"],
            "step_ms_median": step_ms, "tokens_per_s": tokens / step_ms * 1e3,
            "peak_gib": peak, "checkpoints": committed, "wall_s": wall}


def _lint(launches_by_path):
    """Step 34: scripts/torch_lint_program.py, host only."""
    import contextlib
    import io

    lint = _load_entry("scripts/torch_lint_program.py")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, launches = _drive_all("torch_lint_program", lambda: lint.main(LINT_ARGV),
                                  launches_by_path)
    out = buf.getvalue()
    print(f"step 34, torch_lint_program {' '.join(LINT_ARGV)}: rc {rc}, codes "
          f"{sorted(set(c for c in out.split() if c.startswith('SPT')))}; launches "
          f"{launches}", flush=True)
    assert rc == 0 and "SPT208" in out, (rc, out)
    assert not any(launches.values()), launches
    return {"path": "torch_lint_program", "rc": rc, "spt208": True}


def examples_phase():
    """Steps 30-34.  Returns the records, the paths' kernel entries and
    {path: {kernel: launches}}."""
    records, paths, launches_by_path = [], [], {}
    for step, fn in enumerate((_quickstart, _ssm, _serve_batch), start=30):
        t0 = time.perf_counter()
        record, entries = fn(launches_by_path)
        records.append(record)
        paths += entries
        print(f"step {step} took {time.perf_counter() - t0:.1f} s", flush=True)
    for step, fn in ((33, _train_lm), (34, _lint)):
        t0 = time.perf_counter()
        records.append(fn(launches_by_path))
        print(f"step {step} took {time.perf_counter() - t0:.1f} s", flush=True)
    return records, paths, launches_by_path


CONFORMANCE_TIMEOUT_S = 480
# step 35, run from the repository's root in a process of its own: pytest on
# the cuda tests of tests/test_torch_cuda.py, then one JSON line with the
# outcomes, every kernel's launches in that process and its worst error
# against its twin (the test file's WORST)
CONFORMANCE = """
import json, sys
sys.modules["jax"] = None  # the card's machine has no jax: nothing here may need it
import pytest


class Outcomes:
    def __init__(self):
        self.n = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.failed:
            self.n["failed"] += 1
        elif report.skipped:
            self.n["skipped"] += 1
        elif report.when == "call":
            self.n["passed"] += 1


outcomes = Outcomes()
rc = pytest.main(["-q", "-m", "cuda", "-p", "no:cacheprovider",
                  "tests/test_torch_cuda.py"], plugins=[outcomes])
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.sptrsv.kernel import sptrsv_cuda, sptrsv_cuda_blocked
from repro_torch.kernels.ssd_scan.kernel import chunked_scan_cuda
wrappers = (sptrsv_cuda, sptrsv_cuda_blocked, chunked_scan_cuda, flash_attention_cuda)
tests = sys.modules.get("test_torch_cuda")
print(json.dumps({"rc": int(rc), **outcomes.n,
                  "launches": {w.__name__: w.launches for w in wrappers},
                  "worst": getattr(tests, "WORST", None),
                  "reference_modules": sorted(
                      m for m in sys.modules if m.split(".")[0] == "repro")}))
"""


def conformance_phase():
    """Step 35: `CONFORMANCE` in a subprocess.  Every test must pass and none
    may skip; a failure, a skip or the time limit raises.  Returns the
    record: passed, seconds, launches and worst error per kernel."""
    log = os.path.join(ROOT, "build", "conformance.log")
    os.makedirs(os.path.dirname(log), exist_ok=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", CONFORMANCE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=CONFORMANCE_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    with open(log, "w") as f:
        f.write(out.stdout + out.stderr)
    tail = "\n".join((out.stdout + out.stderr).splitlines()[-40:])
    assert out.returncode == 0, f"step 35's process exited {out.returncode}:\n{tail}"
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    assert summary["rc"] == 0 and summary["failed"] == 0, f"step 35 failed:\n{tail}"
    assert summary["skipped"] == 0, \
        f"step 35: {summary['skipped']} tests skipped (the card was not seen):\n{tail}"
    assert summary["passed"] > 0, f"step 35 ran no test:\n{tail}"
    assert not summary["reference_modules"], summary["reference_modules"]
    print(f"step 35, conformance (tests/test_torch_cuda.py -m cuda): "
          f"{summary['passed']} passed, 0 failed, 0 skipped in {seconds:.1f} s; "
          f"launches {json.dumps(summary['launches'])}; worst |kernel - twin| / "
          f"max|twin| {json.dumps(summary['worst'])}", flush=True)
    return {"passed": summary["passed"], "seconds": seconds,
            "launches": summary["launches"], "worst": summary["worst"]}


if __name__ == "__main__":
    sys.exit(main())
