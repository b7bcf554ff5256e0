#!/usr/bin/env python
"""Loss curves of the two packages' trainers, side by side on the CPU.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_curves.py --reduced
    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/train_curves.py \\
        --layers 2 --dtype bfloat16 --batch 8 --seq 256 --steps 30

Takes `launch/train.py`'s flags (``--arch``, ``--batch``, ``--seq``,
``--steps``, ``--lr``, ``--reduced``) and cuts the config with ``--layers``
and ``--dtype``.  The port's trainer (`repro_torch.launch.train.setup`:
seeded f32 master weights, remat, AdamW, warmup 20) and the reference's
jitted `make_train_step` (its trainer's flags, on no mesh) start from the
same weights, the port's carried across with `tree_from_named`, and take
the same batches of `SyntheticLMDataset`.  Each package follows its own
trajectory: nothing is copied between them after the start.  Prints each
step's loss and grad norm in both packages with the loss's relative
difference, then one JSON line with both curves.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import RuntimeFlags as JFlags
from repro.optim import adamw_init as jadamw_init
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models.convert import tree_from_named

REFERENCE_WARMUP = 20      # repro/launch/train.py: make_train_step(..., warmup=20)


def curves(argv=None) -> dict:
    """Both packages' per-step loss and grad norm; ``argv`` as the module's
    command line."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=0, help="cut depth (0: the config's)")
    ap.add_argument("--dtype", default="", help="compute dtype (default: the config's)")
    own, rest = ap.parse_known_args(argv)
    args = train.parse_args(rest + ["--device", "cpu"])
    cut = {"n_layers": own.layers} if own.layers else {}
    if own.dtype:
        cut["dtype"] = own.dtype

    def config(get):
        cfg = get(args.arch)
        return dataclasses.replace(cfg.reduced() if args.reduced else cfg, **cut)

    tr = train.setup(args, cfg=config(get_config))
    jcfg = config(jget_config)
    jflags = JFlags(use_pallas=False, interpret=False, remat=True, mesh=None)
    jstep = jax.jit(jmake_train_step(jcfg, jflags, lr=args.lr, warmup=REFERENCE_WARMUP,
                                     total=args.steps))
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                           tree_from_named(dict(tr.model.named_parameters())))
    jopt = jadamw_init(jparams)
    out = {"config": {"arch": args.arch, "reduced": args.reduced, **cut,
                      "batch": args.batch, "seq": args.seq, "lr": args.lr,
                      "warmup": train.WARMUP},
           "port": {"loss": [], "grad_norm": []}, "reference": {"loss": [], "grad_norm": []}}
    print(f"{'step':>4} {'port loss':>10} {'ref loss':>10} {'rel diff':>9} "
          f"{'port gnorm':>10} {'ref gnorm':>10}", flush=True)
    for s in range(args.steps):
        batch = tr.batch(s)
        met = tr.train_step(tr.model, tr.opt_state, batch)
        jbatch = {k: v.numpy().astype(np.int32 if k in ("tokens", "labels") else np.float32)
                  for k, v in batch.items()}
        jparams, jopt, jmet = jstep(jparams, jopt, jbatch)
        for side, m in (("port", met), ("reference", jmet)):
            out[side]["loss"].append(float(m["loss"]))
            out[side]["grad_norm"].append(float(m["grad_norm"]))
        lp, lr_ = out["port"]["loss"][-1], out["reference"]["loss"][-1]
        print(f"{s + 1:4d} {lp:10.5f} {lr_:10.5f} {abs(lp - lr_) / abs(lr_):9.2e} "
              f"{out['port']['grad_norm'][-1]:10.5f} "
              f"{out['reference']['grad_norm'][-1]:10.5f}", flush=True)
    return out


if __name__ == "__main__":
    print(json.dumps(curves(sys.argv[1:])))
