"""The port's mesh path on 4 gloo ranks of the CPU, against the unsharded port.

    PYTHONPATH=src python scripts/mesh_gloo_check.py

Runs the rank programs of `tests/torch_mesh_workers.py` on a (2, 2)
("data", "model") mesh, 4 spawned processes per case: prefill and 4 greedy
decode steps of every served family with ``use_kernels=True`` (the
kernels' plain versions under `local_map`), and one train step (loss and
every gradient leaf) of smollm-360m, rwkv6-1.6b and zamba2-2.7b, all on
reduced configs in f32.  Each is held to the unsharded port as
`tests/test_torch_mesh.py` holds it (logits and caches within 1e-5 of
the largest value, loss within 1e-5 relative, each gradient leaf within
1e-5 relative L2), but without JAX, so it runs wherever torch does: the
point is to check DTensor's view rules on the installed torch (2.11
refuses views that later versions accept).  Prints one line per case and
a JSON summary; exits 1 if a case fails.  Writes under ``build/mesh_gloo``.
"""

from __future__ import annotations

import json
import multiprocessing as mp
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch_mesh_workers as workers  # noqa: E402

WORLD, JOIN_S, REL = 4, 300, 1e-5
SERVE = ("smollm-360m", "granite-moe-1b-a400m", "rwkv6-1.6b", "zamba2-2.7b",
         "whisper-base", "llama-3.2-vision-11b")
TRAIN = ("smollm-360m", "rwkv6-1.6b", "zamba2-2.7b")
LR, WARMUP, TOTAL = 3e-3, 2, 10


def _spawn(out: str, case: str, *args) -> dict:
    """Rank 0's results of ``case`` on 4 ranks."""
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=workers.run, args=(r, WORLD, out, case, args))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = [open(os.path.join(out, f"error{r}.txt")).read() for r in range(WORLD)
              if os.path.exists(os.path.join(out, f"error{r}.txt"))]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"{case} {args}: " + ("\n".join(errors)[-3000:] or
                                                 "a rank did not finish"))
    with np.load(os.path.join(out, "rank0.npz")) as f:
        return dict(f)


def _serve_err(res: dict) -> float:
    """Worst |mesh - plain| over max|plain| of every logit and cache tensor."""
    names = {k.rsplit("_", 1)[0] for k in res}
    return max(float(np.abs(res[f"{n}_mesh"] - res[f"{n}_plain"]).max())
               / float(np.abs(res[f"{n}_plain"]).max()) for n in names)


def _train_err(res: dict) -> dict:
    loss = abs(float(res["loss_mesh"]) - float(res["loss_plain"])) / abs(
        float(res["loss_plain"]))
    grads = [k.split("/", 1)[1] for k in res if k.startswith("grad_plain/")]
    l2 = lambda n: float(np.linalg.norm(res[f"grad_mesh/{n}"] - res[f"grad_plain/{n}"])
                         / np.linalg.norm(res[f"grad_plain/{n}"]))
    return {"loss_rel": loss, "grad_rel_l2": max(l2(n) for n in grads),
            "grad_leaves": len(grads)}


def main() -> int:
    import torch

    out = os.path.join(ROOT, "build", "mesh_gloo")
    summary, ok = {"torch": torch.__version__}, True
    for arch in SERVE:
        t0 = time.perf_counter()
        err = _serve_err(_spawn(out, "serve", arch))
        good = err <= REL
        ok &= good
        summary[f"serve {arch}"] = err
        print(f"serve {arch}: mesh vs unsharded, worst error over max |value| "
              f"{err:.3e} (limit {REL}) {'ok' if good else 'FAIL'}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    for arch in TRAIN:
        t0 = time.perf_counter()
        errs = _train_err(_spawn(out, "train", LR, WARMUP, TOTAL, arch))
        good = errs["loss_rel"] <= REL and errs["grad_rel_l2"] <= REL
        ok &= good
        summary[f"train {arch}"] = errs
        print(f"train {arch}: loss relative difference {errs['loss_rel']:.3e}, worst "
              f"gradient leaf relative L2 {errs['grad_rel_l2']:.3e} over "
              f"{errs['grad_leaves']} leaves (limit {REL}) {'ok' if good else 'FAIL'}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    shutil.rmtree(out, ignore_errors=True)
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
