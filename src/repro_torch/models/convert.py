"""Carry parameters between the JAX package's tree layout and the port's
modules.

The reference keeps a model as a parameter pytree: nested dicts whose
leaves are arrays, with the ``lax.scan`` stacking kept (``layers``
``[L, ...]``, ``enc_layers`` ``[E, ...]``, vlm ``groups.self`` ``[G, P,
...]`` and ``groups.cross`` ``[G, ...]``, hybrid ``groups.mamba`` ``[G, P,
...]``).  The port names one tensor per layer (``layers.3.attn.wq.w``).

  * `params_from_jax`: the reference's tree -> the port's model of the
    config's family holding the same values, each tensor in the dtype the
    port stores it in.
  * `named_from_tree` / `tree_from_named`: the same mapping for any
    per-parameter dict (the model's parameters or gradients, AdamW's ``m``
    and ``v``), both ways; `tree_from_named` stacks per-layer tensors into
    copies on one device.
  * `train_state_tree` / `load_train_state`: a model and its AdamW state as
    the reference's training state ``{"params", "opt": {"m", "v",
    "step"}}``, the tree its checkpoints hold.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import full_tensor, place
from repro_torch.kernels.common import resolve_device

from .model import MODELS, LM

__all__ = ["params_from_jax", "named_from_tree", "tree_from_named",
           "train_state_tree", "load_train_state", "reference_name"]

# stacked prefix of the reference's names -> the port's name pattern, one
# ``{}`` per stacked axis
_STACKED = {
    "layers.": "layers.{}.",
    "enc_layers.": "enc_layers.{}.",
    "groups.self.": "groups.{}.self.{}.",
    "groups.cross.": "groups.{}.cross.",
    "groups.mamba.": "groups.{}.mamba.{}.",
}
# the port's names back to the reference's: (regex, stacked prefix)
_UNSTACK = [(re.compile("^" + re.escape(pattern).replace(r"\{\}", r"(\d+)") + "(.+)$"),
             prefix) for prefix, pattern in _STACKED.items()]


def reference_name(name: str) -> tuple[str, int]:
    """A port parameter name -> ``(the reference's stacked name, the number
    of stacked leading axes it drops)``: ``layers.3.attn.wq.w`` ->
    ``("layers.attn.wq.w", 1)``."""
    for rx, prefix in _UNSTACK:
        m = rx.match(name)
        if m:
            return prefix + m.groups()[-1], len(m.groups()) - 1
    return name, 0


def _flatten(node, path=()):
    if isinstance(node, dict):
        for key, child in node.items():
            yield from _flatten(child, path + (key,))
    else:
        yield ".".join(path), node


def named_from_tree(tree) -> dict:
    """The reference's nested tree -> ``{port name: leaf}``, stacked leaves
    indexed per layer (views of numpy arrays or tensors alike)."""
    named = {}
    for name, arr in _flatten(tree):
        prefix = next((p for p in _STACKED if name.startswith(p)), None)
        if prefix is None:
            named[name] = arr
            continue
        pattern, rest = _STACKED[prefix], name[len(prefix):]
        for idx in np.ndindex(tuple(arr.shape[:pattern.count("{}")])):
            named[pattern.format(*idx) + rest] = arr[idx]
    return named


@torch.no_grad()
def tree_from_named(named: dict, device=None) -> dict:
    """``{port name: tensor}`` -> the reference's nested tree, per-layer
    tensors stacked under the scan's leading axes.  Every leaf is a new
    tensor on ``device`` (None: each tensor's own), detached and sharing no
    memory with ``named``, so the tree is a snapshot.  A DTensor leaf is
    gathered to its global value (a collective: every rank calls this)."""
    flat, stacked = {}, {}
    for name, t in named.items():
        t = _gathered(t, device)
        for rx, prefix in _UNSTACK:
            m = rx.match(name)
            if m:
                *idx, rest = m.groups()
                stacked.setdefault(prefix + rest, {})[tuple(map(int, idx))] = t
                break
        else:
            flat[name] = t.detach().to(device or t.device, copy=True)
    for name, parts in stacked.items():
        lead = tuple(max(i[d] for i in parts) + 1 for d in range(len(next(iter(parts)))))
        first = next(iter(parts.values()))
        if len(parts) != int(np.prod(lead)):
            raise ValueError(f"{name}: {len(parts)} layers do not fill {lead}")
        out = torch.empty(lead + tuple(first.shape), dtype=first.dtype,
                          device=device or first.device)
        for idx, t in parts.items():
            out[idx].copy_(t)
        flat[name] = out
    tree: dict = {}
    for name in sorted(flat):
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = flat[name]
    return tree


def _gathered(t, device):
    """A DTensor's global value (its shape alone for ``device="meta"``);
    any other tensor as it is."""
    if isinstance(t, DTensor) and device is not None and torch.device(device).type == "meta":
        return torch.empty(t.shape, dtype=t.dtype, device="meta")
    return full_tensor(t)


def params_from_jax(tree, cfg, *, device=None) -> LM:
    """The reference's parameter pytree -> the family's `LM` on ``device``."""
    dev = resolve_device(device)
    model = MODELS[cfg.family](cfg, device="meta")
    want = dict(model.named_parameters())
    state = named_from_tree(_nested_f32(tree))
    if state.keys() != want.keys():
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(want.keys() - state.keys())}, unexpected "
                         f"{sorted(state.keys() - want.keys())}")
    for name, arr in state.items():
        if tuple(arr.shape) != tuple(want[name].shape):
            raise ValueError(f"{name}: shape {arr.shape}, the config gives "
                             f"{tuple(want[name].shape)}")
        state[name] = torch.from_numpy(np.array(arr)).to(
            device=dev, dtype=want[name].dtype)
    model.load_state_dict(state, assign=True)
    return model


def _nested_f32(node):
    if isinstance(node, dict):
        return {key: _nested_f32(child) for key, child in node.items()}
    return np.asarray(node, dtype=np.float32)


def train_state_tree(model: LM, opt_state: dict, device="cpu") -> dict:
    """The reference's training state of ``model`` and its AdamW state:
    ``{"params": tree, "opt": {"m": tree, "v": tree, "step": int32}}``,
    copies on ``device`` (``"meta"``: shapes and dtypes only, a restore's
    example)."""
    return {"params": tree_from_named(dict(model.named_parameters()), device),
            "opt": {"m": tree_from_named(opt_state["m"], device),
                    "v": tree_from_named(opt_state["v"], device),
                    "step": torch.tensor(opt_state["step"], dtype=torch.int32,
                                         device=device)}}


@torch.no_grad()
def load_train_state(model: LM, opt_state: dict, tree: dict) -> None:
    """Copy a `train_state_tree` (restored from a checkpoint) into ``model``
    and ``opt_state`` in place; a DTensor keeps its own shard of the
    restored global value."""
    targets = [(dict(model.named_parameters()), tree["params"]),
               (opt_state["m"], tree["opt"]["m"]), (opt_state["v"], tree["opt"]["v"])]
    for dest, src in targets:
        named = named_from_tree(src)
        if named.keys() != dest.keys():
            raise ValueError(f"state names differ: missing "
                             f"{sorted(dest.keys() - named.keys())}, unexpected "
                             f"{sorted(named.keys() - dest.keys())}")
        for name, t in named.items():
            if not isinstance(t, torch.Tensor):
                t = torch.from_numpy(np.array(t))
            d = dest[name]
            if isinstance(d, DTensor):   # this rank's shard of the global value
                d = d.to_local()
                t = place(t.to(d.device), dest[name].device_mesh,
                          dest[name].placements).to_local()
            d.copy_(t)
    opt_state["step"] = int(tree["opt"]["step"])
