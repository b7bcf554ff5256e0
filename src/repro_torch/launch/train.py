"""Training launcher: the end-to-end loop with checkpoint/restart + fault
tolerance.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \\
        --steps 6 --batch 2 --seq 32

Ports `repro/launch/train.py`: the same flags and defaults (plus
``--device``), the same loop and the same returned dict,
which also lists each step's loss (``losses``) and milliseconds
(``step_ms``, the step and reading its loss).
It runs on the CUDA device unless ``--device`` names another.  Weights
are random, drawn from a seeded `torch.Generator`, and kept in float32
(master weights, as the reference keeps them; the compute dtype is the
config's).  The step is the reference's: the plain paths
(``use_kernels=False``) under autograd with per-layer remat, as the
reference trains with ``use_pallas=False, remat=True``.  The vlm and
encdec frontends take the reference's all-zero stubs.

Fault-tolerance wiring, as in the reference:
  * CheckpointManager saves asynchronously every --ckpt-every steps, in the
    reference's layout (`convert.train_state_tree`);
  * on startup the latest COMMITTED checkpoint is restored and the
    step-indexed data pipeline resumes exactly where it left off;
  * HeartbeatMonitor + StragglerPolicy watch simulated host heartbeats
    (single-host here); a detected failure triggers plan_remesh() and a
    restore-restart cycle (`--inject-failure` demonstrates it).

`setup` builds the trainer (config, seeded weights, AdamW state, the
train step, the step-indexed batches) from the flags, for `main` and for
whatever else drives the same step (``launch/profile.py --train``).

As the reference, `main` trains through a device mesh, as
`mesh.launch_mesh` chooses it: `mesh.make_production_mesh()` with
``--production-mesh`` (a process group of 256 ranks), else
`mesh.make_local_mesh(--model-axis)` over the ranks of the process group
(under ``torchrun``: NCCL on the cards, gloo with ``--device cpu``).  The
weights and AdamW's moments are DTensors placed by
`sharding.param_placements`, the batches by `sharding.batch_placements`.
Checkpoints take the reference's multi-host layout with one host per rank.
A world of one trains plain tensors, since every dim of its mesh has size
1; `main` and `setup` take a caller's mesh (``mesh=``), a (1, 1) mesh
included.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, list_archs
from repro_torch.data import SyntheticLMDataset
from repro_torch.distributed import HeartbeatMonitor, StragglerPolicy, plan_remesh
from repro_torch.distributed.sharding import (
    batch_placements,
    distribute_params,
    dp_axes,
    place,
)
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import launch_mesh
from repro_torch.launch.serve import stub_extra
from repro_torch.launch.steps import make_train_step
from repro_torch.models import RuntimeFlags, init_params
from repro_torch.models.convert import load_train_state, train_state_tree
from repro_torch.optim import adamw_init

__all__ = ["parse_args", "setup", "main", "Trainer"]

SEED = 0
WARMUP = 20


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="smollm-360m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-test-sized config")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--inject-failure", type=int, default=0,
                    help="simulate a host failure at this step (demo/test)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Trainer:
    cfg: object
    device: torch.device
    model: torch.nn.Module      # f32 master weights
    opt_state: dict             # adamw_init(model)
    train_step: object          # train_step(model, opt_state, batch) -> metrics
    dataset: SyntheticLMDataset
    extra: dict                 # the vlm / encdec frontends' stub inputs
    mesh: object = None         # DeviceMesh | None

    def batch(self, step: int) -> dict:
        """Global batch ``step`` of the dataset on the device, with ``extra``;
        on a mesh each tensor placed by `sharding.batch_placements`."""
        batch = {k: torch.from_numpy(v).to(self.device).long()
                 for k, v in self.dataset.batch(step).items()}
        batch.update(self.extra)
        if self.mesh is not None:
            batch = {k: place(v, self.mesh, batch_placements(self.mesh, v.shape[0], v.ndim))
                     for k, v in batch.items()}
        return batch


def setup(args: argparse.Namespace, cfg=None, mesh=None) -> Trainer:
    """Config (``cfg``, default the flags'), seeded f32 master weights (on
    ``mesh``, a `DeviceMesh`, placed by `sharding.param_placements`; None
    for plain tensors), AdamW state, the train step (the reference's flags,
    lr schedule over ``--steps``) and the data."""
    if mesh is None and (args.production_mesh or args.model_axis != 1):
        raise ValueError("--production-mesh and --model-axis need a mesh: pass "
                         "the one `mesh.launch_mesh` gives for these flags")
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
    dev = resolve_device(args.device)
    flags = RuntimeFlags(use_kernels=False, remat=True, mesh=mesh,
                         dp=dp_axes(mesh) if mesh is not None else ("data",))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = init_params(gen, cfg, device=dev, param_dtype=torch.float32)
    if mesh is not None:
        distribute_params(model, mesh)
    return Trainer(
        cfg=cfg, device=dev, model=model, opt_state=adamw_init(model),
        train_step=make_train_step(cfg, flags, lr=args.lr, warmup=WARMUP,
                                   total=args.steps),
        dataset=SyntheticLMDataset(cfg.vocab, args.seq, args.batch),
        extra=stub_extra(cfg, args.batch, dev), mesh=mesh)


def main(argv=None, mesh=None) -> dict:
    """Train with the flags ``argv`` on ``mesh`` (a `DeviceMesh` whose
    process group the caller owns), or by default on the mesh
    `mesh.launch_mesh` gives for the flags."""
    args = parse_args(argv)
    if mesh is not None:
        return _train(args, mesh)
    with launch_mesh(args.model_axis, args.device, production=args.production_mesh) as m:
        return _train(args, m)


def _train(args: argparse.Namespace, mesh) -> dict:
    tr = setup(args, mesh=mesh)
    model, opt_state, dev = tr.model, tr.opt_state, tr.device
    start_step = 0

    rank, world = ((dist.get_rank(), dist.get_world_size()) if tr.mesh is not None
                   else (0, 1))
    ckpt = (CheckpointManager(args.ckpt_dir, host_id=rank, num_hosts=world)
            if args.ckpt_dir else None)
    if ckpt is not None:
        (restored, step) = ckpt.restore(train_state_tree(model, opt_state, "meta"))
        if step is not None:
            load_train_state(model, opt_state, restored)
            start_step = step
            print(f"restored checkpoint at step {step}")

    monitor = HeartbeatMonitor(hosts=[0], timeout_s=300.0)
    stragglers = StragglerPolicy()
    if tr.mesh is not None:
        devices = world
    else:
        devices = torch.cuda.device_count() if dev.type == "cuda" else 1

    losses, step_ms = [], []
    step = start_step
    while step < args.steps:
        batch = tr.batch(step)
        t0 = time.perf_counter()
        metrics = tr.train_step(model, opt_state, batch)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        step_ms.append(dt * 1e3)
        monitor.beat(0)
        stragglers.record_step({0: dt})

        if args.inject_failure and step == args.inject_failure:
            print(f"[FT] injected failure at step {step}")
            plan = plan_remesh(
                healthy_chips=max(1, devices - 1),
                model_axis=args.model_axis, chips_per_pod=devices,
                per_replica_batch=args.batch,
            )
            print(f"[FT] re-mesh plan: {plan}")
            if ckpt is not None:
                ckpt.wait()
                (restored, rstep) = ckpt.restore(
                    train_state_tree(model, opt_state, "meta"))
                if rstep is not None:
                    load_train_state(model, opt_state, restored)
                    step = rstep
                    print(f"[FT] rolled back to step {rstep}")
                    args.inject_failure = 0
                    continue
            args.inject_failure = 0

        step += 1
        if step % args.log_every == 0:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"ppl {float(metrics['ppl']):.1f} {dt*1e3:.0f} ms")
        if ckpt is not None and step % args.ckpt_every == 0:
            ckpt.save_async(step, train_state_tree(model, opt_state),
                            meta={"loss": loss})

    if ckpt is not None:
        ckpt.wait()
    result = {"first_loss": losses[0], "last_loss": losses[-1],
              "steps": len(losses), "step_ms": step_ms, "losses": losses}
    print(result)
    return result


if __name__ == "__main__":
    main()
