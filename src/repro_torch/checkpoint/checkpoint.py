"""Atomic, async checkpointing with restart/resume semantics.

Ports `repro/checkpoint/checkpoint.py` with its layout, so the files of the
two packages are interchangeable:

    <dir>/step_<n>/host_<h>.npz  + meta.json  + <dir>/step_<n>/COMMITTED

  * a step directory is valid iff the COMMITTED marker exists (one host:
    atomic rename of a tmp dir; several: host 0 writes it after a barrier
    that every host reaches once its file is written), so crash-safe
    partial writes are ignored on restore;
  * a host is a rank of the process group (``host_id`` = rank,
    ``num_hosts`` = world size).  Each host writes the whole tree it is
    given: a DTensor leaf is gathered to its global value first
    (`convert.train_state_tree`), as the reference's ``np.asarray`` gathers
    a sharded array; restore reads the host's own file, and
    `convert.load_train_state` keeps each rank's shard;
  * `CheckpointManager` snapshots the tree to the host, saves it on a
    background thread (training never blocks on I/O), keeps the newest
    `keep` checkpoints, and `latest_step` drives restart-after-failure.
    A save that fails raises from the next `wait` (or `save_async`); the
    reference's thread drops the error.

A tree is nested dicts, lists and tuples whose leaves are tensors (any
device), numpy arrays or scalars.  Leaves are stored under their path
joined by ``/`` (dict keys, sequence indices), as the reference joins
pytree paths.  A bfloat16 leaf is stored as the reference stores one:
its raw 16 bits as a 2-byte void (``V2``).  Restore reads such a leaf
back bit for bit as ``torch.bfloat16`` (the reference's restore cannot
cast a ``V2`` leaf and raises; ROADMAP Queue 3).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "CheckpointManager"]


def _host_file(host_id: int) -> str:
    return f"host_{host_id}.npz"


def _items(node):
    if isinstance(node, dict):
        return sorted(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _flatten(tree, path=()):
    """``(key, leaf)`` in the reference's order (dict keys sorted)."""
    items = _items(tree)
    if items is None:
        yield "/".join(str(p) for p in path), tree
        return
    for key, child in items:
        yield from _flatten(child, path + (key,))


def _map(fn, tree, path=()):
    """``tree`` with every leaf replaced by ``fn(key, leaf)``."""
    items = _items(tree)
    if items is None:
        return fn("/".join(str(p) for p in path), tree)
    out = [(key, _map(fn, child, path + (key,))) for key, child in items]
    if isinstance(tree, dict):
        return dict(out)
    return type(tree)(value for _, value in out)


def _to_numpy(leaf) -> np.ndarray:
    """A host array of ``leaf``: a copy of a device tensor, a view of a host
    one (as ``np.asarray`` in the reference); bfloat16 as raw ``V2`` bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):   # raw bfloat16 bits
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(
    directory: str,
    step: int,
    tree,
    host_id: int = 0,
    num_hosts: int = 1,
    meta: dict | None = None,
) -> str:
    """Write this host's `tree` for `step`, atomically.

    One host writes ``host_0.npz`` into a tmp dir renamed into place.  With
    several, every host writes ``host_<host_id>.npz`` into the step dir,
    host 0 the meta, and host 0 the COMMITTED marker after a barrier of the
    default process group (every host must call this).
    """
    flat = {key: _to_numpy(leaf) for key, leaf in _flatten(tree)}
    final = os.path.join(directory, f"step_{step:08d}")
    if num_hosts == 1:
        tmp = final + f".tmp{host_id}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, _host_file(host_id)), **flat)
        if meta is not None:
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump({"step": step, **meta}, f)
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)  # atomic publish
    else:
        os.makedirs(final, exist_ok=True)
        np.savez(os.path.join(final, _host_file(host_id)), **flat)
        if meta is not None and host_id == 0:
            with open(os.path.join(final, "meta.json"), "w") as f:
                json.dump({"step": step, **meta}, f)
        dist.barrier()   # every host's file is written
    # the commit marker comes last, written by host 0
    if host_id == 0:
        with open(os.path.join(final, "COMMITTED"), "w") as f:
            f.write(str(step))
    return final


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if name.startswith("step_") and os.path.exists(
            os.path.join(full, "COMMITTED")
        ):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def restore_checkpoint(
    directory: str,
    example_tree,
    step: int | None = None,
    host_id: int = 0,
):
    """Restore into the structure of `example_tree`; returns (tree, step).

    Leaves take the example's shape (checked) and dtype: a tensor example
    (any device, ``meta`` included) gives a host tensor, anything else a
    numpy array.  `step=None` restores the newest COMMITTED checkpoint;
    returns (example_tree, None) when nothing is available (fresh start).
    """
    step = step if step is not None else latest_step(directory)
    if step is None:
        return example_tree, None
    path = os.path.join(directory, f"step_{step:08d}", _host_file(host_id))
    data = np.load(path)

    def load(key, leaf):
        arr = data[key]
        if arr.shape != tuple(np.shape(leaf)):
            raise ValueError(f"{path}: {key} has shape {arr.shape}, the example "
                             f"{tuple(np.shape(leaf))}")
        t = _from_numpy(arr)
        if isinstance(leaf, torch.Tensor):
            return t.to(leaf.dtype)
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy().astype(np.asarray(leaf).dtype)

    return _map(load, example_tree), step


class CheckpointManager:
    """Async save + retention, non-blocking for the train loop.  With
    several hosts a save runs in the caller's thread: its barrier is a
    collective of the process group, which the train loop's thread also
    uses."""

    def __init__(self, directory: str, keep: int = 3, host_id: int = 0,
                 num_hosts: int = 1):
        self.directory = directory
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, tree, meta: dict | None = None) -> None:
        """Save ``tree`` on a background thread.  Device tensors are copied
        to the host first; host tensors and arrays are saved as they are,
        so the caller must not change them until `wait` (the train loop
        passes a `convert.train_state_tree`, a fresh copy)."""
        self.wait()  # at most one in-flight save
        host_tree = _map(lambda _, leaf: _to_numpy(leaf), tree)  # snapshot off-device

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree, host_id=self.host_id,
                                num_hosts=self.num_hosts, meta=meta)
                if self.host_id == 0:
                    self._gc()
            except Exception as e:  # raised again by wait(), in the caller's thread
                self._error = e

        if self.num_hosts > 1:
            work()
            self.wait()
            return
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the save in flight is written; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    def latest_step(self) -> int | None:
        return latest_step(self.directory)

    def restore(self, example_tree, step: int | None = None):
        return restore_checkpoint(self.directory, example_tree, step, self.host_id)

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_")[1])
            for n in os.listdir(self.directory)
            if n.startswith("step_") and "." not in n
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(
                os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True
            )
