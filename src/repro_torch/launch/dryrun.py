"""Multi-pod dry run: trace every (arch x shape x mesh) cell on the meta
device, per device, with no card.  Ports `repro/launch/dryrun.py`.

The reference lowers and compiles each cell for 256 or 512 fake devices.
Here one process plays rank 0 of a FAKE process group of 256 (pod) or 512
(multipod) ranks, in which collectives move nothing.  For each cell it
  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod),
  2. builds the step (train / prefill / decode) with `steps.build_cell`:
     meta DTensor arguments placed by the sharding rules, each with its
     per-device local shape,
  3. runs the step once on those meta tensors under
     `hlo_analysis.analyze_step` (per-device products, bytes and
     collectives from the dispatch trace; ``cost_analysis`` repeats its
     products and bytes under XLA's names, ``lower_s`` is the time to build
     the placed arguments and ``compile_s`` the traced step's),
  4. writes build/dryrun/<arch>__<shape>__<mesh>.json for
     `launch/roofline.py`.

``memory_analysis`` holds the per-device ``argument_size_in_bytes`` (the
local bytes of every tensor argument) and ``output_size_in_bytes`` (the
local bytes of the step's results, and of the parameters and moments a
train step updates in place), both exact from the local shapes.  The
temporaries' peak is not measured (meta tensors allocate nothing), so
``temp_size_in_bytes`` is absent and ``memory_analysis_note`` says so.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all          # every cell, a subprocess each
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ASSIGNED_ARCHS, get_config, list_archs
from repro_torch.distributed.sharding import dp_axes
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_production_mesh
from repro_torch.launch.shapes import SHAPES, cell_skipped
from repro_torch.launch.steps import build_cell
from repro_torch.models import RuntimeFlags

__all__ = ["run_cell", "fake_world", "main", "RESULTS_DIR"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                           "dryrun")
TEMP_NOTE = ("temp_size_in_bytes not measured: the step runs on meta tensors, "
             "which allocate nothing; hlo.largest_collective_bytes, one tensor the "
             "step holds at once, bounds it from below")


def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake process group of ``size`` ranks
    (no communication); an initialised group of that size is kept."""
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks "
                               f"exists; the dry run needs {size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             remat: bool = True, *, cfg=None, shape=None, mesh=None) -> dict:
    """One cell's record.  ``cfg``, ``shape`` and ``mesh`` replace the
    arch's config, the named shape and the production mesh (a reduced
    cell on a small fake world, as the tests run it)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    skip = cell_skipped(cfg, shape)
    record = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
    }
    if skip:
        record["skipped"] = skip
        return record

    if mesh is None:
        multi = mesh_kind == "multipod"
        fake_world(int(torch.tensor(PRODUCTION_SHAPES[multi][0]).prod()))
        mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    flags = RuntimeFlags(use_kernels=False, remat=(remat and shape.kind == "train"),
                         mesh=mesh, dp=dp_axes(mesh))
    t0 = time.perf_counter()
    fn, args, _, _ = build_cell(cfg, shape, mesh, flags)
    t1 = time.perf_counter()
    out = []
    hlo = hlo_analysis.analyze_step(lambda: out.append(fn(*args)))
    t2 = time.perf_counter()

    updated = args[:2] if shape.kind == "train" else ()   # params, AdamW state
    mem_rec = {
        "argument_size_in_bytes": hlo_analysis.tensor_bytes(args),
        "output_size_in_bytes": hlo_analysis.tensor_bytes((out, updated)),
    }
    print(f"[{arch} x {shape_name} x {mesh_kind}] memory_analysis:", mem_rec)
    record.update({
        "lower_s": round(t1 - t0, 2),        # building the placed meta arguments
        "compile_s": round(t2 - t1, 2),      # the traced step
        "memory_analysis": mem_rec,
        "memory_analysis_note": TEMP_NOTE,
        "cost_analysis": {"flops": float(hlo["dot_flops"]),
                          "bytes accessed": float(hlo["hbm_bytes"])},
        "hlo": {k: float(v) for k, v in hlo.items()},
        "collective_bytes": float(hlo.collective_bytes),
        "devices": int(mesh.size()),
    })
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{arch}__{shape_name}__{mesh_kind}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    return record


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["pod", "multipod"], default="pod")
    ap.add_argument("--all", action="store_true",
                    help="run every cell in a subprocess each")
    ap.add_argument("--meshes", default="pod,multipod")
    ap.add_argument("--out", default=os.path.normpath(RESULTS_DIR))
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        failures = []
        for arch in ASSIGNED_ARCHS:
            for shape_name in SHAPES:
                for mesh_kind in args.meshes.split(","):
                    path = os.path.join(
                        args.out, f"{arch}__{shape_name}__{mesh_kind}.json"
                    )
                    if args.skip_existing and os.path.exists(path):
                        print("skip existing", path)
                        continue
                    cfg = get_config(arch)
                    if cell_skipped(cfg, SHAPES[shape_name]):
                        os.makedirs(args.out, exist_ok=True)
                        with open(path, "w") as f:
                            json.dump(run_cell(arch, shape_name, mesh_kind,
                                               args.out), f, indent=1)
                        continue
                    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                           "--arch", arch, "--shape", shape_name,
                           "--mesh", mesh_kind, "--out", args.out]
                    print(">>", " ".join(cmd), flush=True)
                    r = subprocess.run(cmd)
                    if r.returncode != 0:
                        failures.append((arch, shape_name, mesh_kind))
        if failures:
            print("FAILED cells:", failures)
            sys.exit(1)
        print("all cells OK")
        return

    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all)")
    rec = run_cell(args.arch, args.shape, args.mesh, args.out,
                   remat=not args.no_remat)
    print(json.dumps({k: v for k, v in rec.items() if k != "hlo"}, indent=1))


if __name__ == "__main__":
    main()
