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

``memory_analysis`` holds the per-device keys of the reference's
``compiled.memory_analysis()``: ``argument_size_in_bytes`` (the local
bytes of every tensor argument), ``output_size_in_bytes`` (the local
bytes of the step's results, and of the parameters and moments a train
step updates in place), ``alias_size_in_bytes`` (those updated in place:
outputs that are arguments, as XLA's donated buffers; 0 for prefill and
decode, whose outputs the reference does not donate) and
``temp_size_in_bytes`` (the most bytes the step's own tensors hold at
once, less those of its results: XLA's temporaries, outputs apart),
measured by `hlo_analysis.analyze_step` from the storages the traced ops
make and free; meta storages have their real sizes, so it is exact for
what the step's tensors hold.  The fit line prints the device's peak,
``argument + output - alias + temp`` (`device_peak_bytes`), against the
H100's 80 GB.

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

__all__ = ["run_cell", "fake_world", "memory_analysis", "device_peak_bytes", "main",
           "RESULTS_DIR", "H100_BYTES"]

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                           "dryrun")
H100_BYTES = 80e9    # the H100 SXM5's HBM3, datasheet


def memory_analysis(args, hlo: hlo_analysis.HloSummary, updated=()) -> dict:
    """The reference's ``memory_analysis`` keys, per device, for a step
    traced by `hlo_analysis.analyze_step` on ``args``; ``updated``: the
    state it updates in place (a train step's parameters and moments)."""
    return {
        "argument_size_in_bytes": hlo_analysis.tensor_bytes(args),
        "output_size_in_bytes": hlo_analysis.tensor_bytes((hlo.result, updated)),
        "temp_size_in_bytes": hlo.peak_bytes - hlo.result_bytes,
        "alias_size_in_bytes": hlo_analysis.tensor_bytes(updated),
    }


def device_peak_bytes(mem: dict) -> int:
    """The step's peak on the device: the arguments, the outputs that are
    not arguments, and the temporaries."""
    return (mem["argument_size_in_bytes"] + mem["output_size_in_bytes"]
            - mem["alias_size_in_bytes"] + mem["temp_size_in_bytes"])


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
    hlo = hlo_analysis.analyze_step(fn, *args)
    t2 = time.perf_counter()

    updated = args[:2] if shape.kind == "train" else ()   # params, AdamW state
    mem_rec = memory_analysis(args, hlo, updated)
    peak = device_peak_bytes(mem_rec)
    print(f"[{arch} x {shape_name} x {mesh_kind}] memory_analysis:", mem_rec)
    print(f"[{arch} x {shape_name} x {mesh_kind}] fits: argument + output - alias + temp "
          f"= {peak / 1e9:.3f} GB a device {'<' if peak < H100_BYTES else '>='} the "
          f"H100's {H100_BYTES / 1e9:.0f} GB")
    record.update({
        "lower_s": round(t1 - t0, 2),        # building the placed meta arguments
        "compile_s": round(t2 - t1, 2),      # the traced step
        "memory_analysis": mem_rec,
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
