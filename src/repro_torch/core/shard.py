"""Multi-device batched SpTRSV: split the RHS columns over a set of devices.

Ports `repro/core/shard.py`.  The compiled VLIW instruction stream depends
only on L, so the B columns of a batched solve are embarrassingly
parallel: each device runs the identical instruction-stream pass over its
own block of right-hand sides.  This module places `solve_batch`'s work on
a `BatchMesh`, a tuple of torch devices:

  * every device stages its own replica of the instruction stream (the
    per-device executor of the chosen backend, from the executor cache);
  * the RHS matrix ``b[n, B]`` is split over B, device i taking column
    block i (`rhs_blocks`), and each device solves its ``[n, B/ndev]``
    block — no collective ever runs, the only cross-device traffic is the
    placement of the blocks and the gather of the results onto the mesh's
    first device.

One process drives every device (no ``torch.distributed``): CUDA launches
are asynchronous, so the blocks on distinct cards run at once.  A device
may appear more than once in a mesh; its blocks then run one after the
other on it (one launch each), which is how a one-card machine exercises
the split.

Batch widths are padded to ``ndev * pad_batch(ceil(B / ndev))`` so every
device carries the same lane-friendly block; the sharded solvers are
cached per (program identity, padded per-device width, mesh, backend,
knobs), and the per-device executors come from the executor cache, so
repeated solves — including nearby batch sizes on the same mesh — never
restage (`executor.trace_count` observability).

    from repro_torch.core import api, shard
    mesh = shard.batch_mesh()                  # every CUDA device
    x = api.solve_batch(prog, b, mesh=mesh)    # b[n, B], B over devices
    solver = api.make_solver(prog, batch=B, mesh=mesh, backend="cuda")
"""

from __future__ import annotations

import dataclasses
import weakref

import torch

from .executor import (
    batched_entry,
    make_cuda_executor,
    make_torch_executor,
    pad_batch,
    validate_backend,
)
from .program import Program

__all__ = ["BatchMesh", "batch_mesh", "make_sharded_solver", "mesh_device",
           "rhs_blocks", "sharded_widths"]

# prog -> {(per-device width, mesh, backend, knobs) -> sharded solve core}
_SHARD_CACHE: "weakref.WeakKeyDictionary[Program, dict]" = weakref.WeakKeyDictionary()


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """The devices a batched solve splits its columns over, in block order.

    Hashable (a cache key); a device may repeat.  ``size`` is the number of
    column blocks, as the reference mesh's ``size``.
    """

    devices: tuple[torch.device, ...]

    def __post_init__(self):
        devs = tuple(torch.device(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)

    @property
    def size(self) -> int:
        return len(self.devices)


def batch_mesh(num_devices: int | None = None, *, devices=None) -> BatchMesh:
    """A mesh over the first ``num_devices`` CUDA devices (default all), or
    over the explicit ``devices`` (names or `torch.device`s, repeats
    allowed).  Raises without a CUDA device unless ``devices`` is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass devices=('cpu', ...) to "
                "split the columns over CPU entries")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if num_devices is not None:
            devices = devices[:num_devices]
    elif num_devices is not None:
        raise ValueError("pass num_devices= or devices=, not both")
    return BatchMesh(tuple(devices))


def mesh_device(mesh, device=None) -> torch.device:
    """The device a solve on ``mesh`` answers on, its first; raises
    `TypeError` for anything but a `BatchMesh` and `ValueError` for a
    ``device`` beside it (the mesh names the devices)."""
    if not isinstance(mesh, BatchMesh):
        raise TypeError(f"mesh= takes a shard.BatchMesh (shard.batch_mesh()), "
                        f"got {type(mesh).__name__}")
    if device is not None:
        raise ValueError("mesh= names the devices; pass no device=")
    return mesh.devices[0]


def sharded_widths(batch: int, mesh: BatchMesh) -> tuple[int, int]:
    """(per-device padded width, global padded width) for a batch size."""
    ndev = mesh.size
    w_local = pad_batch(-(-batch // ndev))
    return w_local, w_local * ndev


def rhs_blocks(width: int, mesh: BatchMesh) -> list[slice]:
    """The column block of each mesh entry for a global padded ``width``:
    rows replicated, the columns split evenly in mesh order (the port's
    counterpart of the reference's ``rhs_sharding``)."""
    w_local = width // mesh.size
    return [slice(i * w_local, (i + 1) * w_local) for i in range(mesh.size)]


def _build_sharded_executor(prog: Program, w_local: int, mesh: BatchMesh,
                            backend: str, backend_opts: dict):
    """`solve(b[n, w_local * ndev]) -> x` split over the mesh.

    Each mesh entry runs the per-device executor of ``backend`` at the
    per-device width (``"torch"``: `make_torch_executor`; ``"cuda"``:
    `make_cuda_executor` with its placement knobs); entries that name one
    device share one staged executor.  The result lands on the mesh's
    first device.
    """
    make = make_cuda_executor if backend == "cuda" else make_torch_executor
    execs = [make(prog, batch=w_local, device=dev, **backend_opts)
             for dev in mesh.devices]
    blocks = rhs_blocks(w_local * mesh.size, mesh)
    out_dev = mesh.devices[0]

    def solve_cols(b: torch.Tensor) -> torch.Tensor:
        # every block is launched before any result is gathered, so the
        # blocks on distinct devices run at once
        parts = [fn(b[:, cols]) for fn, cols in zip(execs, blocks)]
        return torch.cat([x.to(out_dev) for x in parts], dim=1)

    solve_cols.placement = getattr(execs[0], "placement", None)
    return solve_cols


def _cached_sharded_executor(prog: Program, w_local: int, mesh: BatchMesh,
                             backend: str, backend_opts: dict):
    per_prog = _SHARD_CACHE.get(prog)
    if per_prog is None:
        per_prog = {}
        _SHARD_CACHE[prog] = per_prog
    key = (w_local, mesh, backend, tuple(sorted(backend_opts.items())))
    fn = per_prog.get(key)
    if fn is None:
        fn = _build_sharded_executor(prog, w_local, mesh, backend, backend_opts)
        per_prog[key] = fn
    return fn


def make_sharded_solver(prog: Program, batch: int, mesh: BatchMesh,
                        backend: str = "torch", **backend_opts):
    """Cached `solver(b[n, batch]) -> x[n, batch]` split over ``mesh``.

    Pads the batch axis to ``ndev * pad_batch(ceil(batch / ndev))``, gives
    device i column block i and runs the per-device executor there.
    Reuses one sharded solver per (program, per-device width, mesh,
    backend knobs).  ``backend="cuda"`` runs the Hopper kernels per device
    (knobs as in `executor.make_cuda_executor`).  The mesh names the
    devices, so ``device=`` is refused.  The closure returns a tensor on
    the mesh's first device; its ``placement`` attribute is the cuda
    backend's regime (None for torch).
    """
    out_dev = mesh_device(mesh, backend_opts.get("device"))
    if batch < 0:
        raise ValueError(f"batch must be non-negative, got {batch}")
    validate_backend(backend, backend_opts)
    w_local, width = sharded_widths(max(batch, 1), mesh)
    core = _cached_sharded_executor(prog, w_local, mesh, backend, backend_opts)
    entry = batched_entry(core, prog.n, batch, width, out_dev)
    entry.placement = core.placement
    return entry
