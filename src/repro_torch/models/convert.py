"""Carry the JAX package's model parameters into the port's modules.

`params_from_jax` takes the reference's parameter pytree (nested dicts
whose leaves are arrays: numpy, or anything ``np.asarray`` accepts), with
the ``lax.scan`` stacking kept (``groups`` leaves are ``[G, P, ...]``), and
returns the port's `HybridLM` holding the same values: stacked leaves are
split per layer, and each tensor takes the dtype the port stores it in
(the compute dtype for weights the reference casts at use, f32 for the
rest).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

from .model import HybridLM

__all__ = ["params_from_jax"]

_STACKED = "groups.mamba."


def _flatten(node, path=()):
    if isinstance(node, dict):
        for key, child in node.items():
            yield from _flatten(child, path + (key,))
    else:
        yield ".".join(path), node


def params_from_jax(tree, cfg, *, device=None) -> HybridLM:
    """The reference's parameter pytree -> `HybridLM` on ``device``."""
    dev = resolve_device(device)
    model = HybridLM(cfg, device="meta")
    want = dict(model.named_parameters())
    state = {}
    for name, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        if name.startswith(_STACKED):
            rest = name[len(_STACKED):]
            for g in range(arr.shape[0]):
                for i in range(arr.shape[1]):
                    state[f"groups.{g}.mamba.{i}.{rest}"] = arr[g, i]
        else:
            state[name] = arr
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
