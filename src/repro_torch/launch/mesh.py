"""Mesh construction.  Ports `repro/launch/mesh.py`.

FUNCTIONS, not module-level constants, so importing this module touches no
device or process-group state.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` over the ranks of
the default process group, with the reference's axis names.  Launch more
than one rank with ``torchrun``; `make_local_mesh` also starts a world of
one by itself when no process group exists (one card, or the CPU), and
the caller then owns that group.  The launchers take their mesh from
`launch_mesh`, which starts and ends the group itself and runs a world of
one on plain tensors.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.common import resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "launch_mesh", "PRODUCTION_SHAPES"]

PRODUCTION_SHAPES = {
    False: ((16, 16), ("data", "model")),
    True: ((2, 16, 16), ("pod", "data", "model")),
}
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def _launched() -> bool:
    """Whether ``torchrun`` (or another launcher) set this process's rank."""
    return all(k in os.environ for k in _TORCHRUN_ENV)


def _world() -> int:
    """The ranks a mesh would span: the process group's, else torchrun's,
    else one."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if _launched() else 1


def _check_model_axis(model_axis: int, n: int):
    if model_axis < 1 or n % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide {n} "
                         f"rank{'s' if n != 1 else ''}")


def _start_group(dev: torch.device):
    """The default process group: the ranks of ``torchrun`` (its
    environment), else a world of one in this process; ``nccl`` on the card
    (each rank on its ``LOCAL_RANK``'s card), ``gloo`` on the CPU."""
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)) if _launched()
                              else dev.index or 0)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if _launched():      # torchrun: the ranks meet at its rendezvous
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _mesh(device_type: str, shape: tuple, names: tuple):
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 0
    if world != int(np.prod(shape)):
        raise ValueError(f"a {shape} mesh needs {int(np.prod(shape))} ranks, the "
                         f"process group has {world} (start them with torchrun)")
    if device_type == "cuda" and dist.get_backend() != "nccl":
        raise ValueError(f"a mesh on the card needs an nccl process group, this one "
                         f"is {dist.get_backend()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 devices per pod; 2 pods when multi_pod (512 devices in all).
    Needs an initialised process group of exactly that many ranks."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    return _mesh(device_type, shape, names)


def make_local_mesh(model_axis: int = 1, device=None):
    """``("data", "model")`` mesh of shape ``(world // model_axis,
    model_axis)`` over the ranks of the process group.  With none
    initialised, starts one (`_start_group`: torchrun's ranks, else a world
    of one; ``nccl`` for ``device`` None, the CUDA device, ``gloo`` for
    ``device="cpu"``), which the caller ends with
    ``dist.destroy_process_group()``."""
    dev = resolve_device(device)
    _check_model_axis(model_axis, _world())
    if not dist.is_initialized():
        _start_group(dev)
    n = dist.get_world_size()
    return _mesh(dev.type, (n // model_axis, model_axis), ("data", "model"))


@contextlib.contextmanager
def launch_mesh(model_axis: int = 1, device=None, *, production: bool = False):
    """The mesh a launcher runs on, for the length of the ``with`` block.

    ``production``: `make_production_mesh` (256 ranks).  Otherwise a world
    of one with ``model_axis`` 1 yields None, plain tensors: every dim of
    its (1, 1) mesh has size 1, so the placements change nothing, and
    DTensor's per-op dispatch would cost the host 3-6x (PERF.md, PR 19).
    Any other world yields `make_local_mesh(model_axis)` over the process
    group.  A group this call starts (torchrun's ranks) ends with the
    block; a group the caller started is left to it."""
    dev = resolve_device(device)
    if not production:
        _check_model_axis(model_axis, _world())
        if _world() == 1:
            yield None
            return
    started = not dist.is_initialized()
    try:
        if started:
            _start_group(dev)
        yield (make_production_mesh(device_type=dev.type) if production
               else make_local_mesh(model_axis, dev))
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
