"""Atomic, async checkpointing with restart/resume semantics.

Ports `repro/checkpoint/checkpoint.py` with its layout, so the files of the
two packages are interchangeable:

    <dir>/step_<n>/host_0.npz  + meta.json  + <dir>/step_<n>/COMMITTED

  * a step directory is valid iff the COMMITTED marker exists (atomic rename
    of a tmp dir -> crash-safe partial writes are ignored on restore);
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

__all__ = ["save_checkpoint", "latest_step", "restore_checkpoint",
           "CheckpointManager"]

_HOST_FILE = "host_0.npz"   # the reference's file for host 0 of 1


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
    meta: dict | None = None,
) -> str:
    """Write `tree` for `step`, atomically.

    One process writes the whole tree as ``host_0.npz``, the file name of
    the reference's single-host layout.
    """
    flat = {key: _to_numpy(leaf) for key, leaf in _flatten(tree)}
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp0"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, _HOST_FILE), **flat)
    if meta is not None:
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **meta}, f)
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)  # atomic publish
    # the commit marker comes last, after the atomic rename above
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
    path = os.path.join(directory, f"step_{step:08d}", _HOST_FILE)
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
    """Async save + retention, non-blocking for the train loop."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
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
                save_checkpoint(self.directory, step, host_tree, meta)
                self._gc()
            except Exception as e:  # raised again by wait(), in the caller's thread
                self._error = e

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
        return restore_checkpoint(self.directory, example_tree, step)

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
