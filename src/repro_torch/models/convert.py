"""Carry the JAX package's model parameters into the port's modules.

`params_from_jax` takes the reference's parameter pytree (nested dicts
whose leaves are arrays: numpy, or anything ``np.asarray`` accepts), with
the ``lax.scan`` stacking kept, and returns the port's model of the
config's family holding the same values: stacked leaves are split per
layer (``layers`` ``[L, ...]``, ``enc_layers`` ``[E, ...]``,
vlm ``groups.self`` ``[G, P, ...]`` and ``groups.cross`` ``[G, ...]``,
hybrid ``groups.mamba`` ``[G, P, ...]``), and each tensor takes the dtype
the port stores it in (the compute dtype for weights the reference casts
at use, f32 for the rest).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

from .model import MODELS, LM

__all__ = ["params_from_jax"]

# stacked prefix of the reference's names -> the port's name pattern, one
# ``{}`` per stacked axis
_STACKED = {
    "layers.": "layers.{}.",
    "enc_layers.": "enc_layers.{}.",
    "groups.self.": "groups.{}.self.{}.",
    "groups.cross.": "groups.{}.cross.",
    "groups.mamba.": "groups.{}.mamba.{}.",
}


def _flatten(node, path=()):
    if isinstance(node, dict):
        for key, child in node.items():
            yield from _flatten(child, path + (key,))
    else:
        yield ".".join(path), node


def params_from_jax(tree, cfg, *, device=None) -> LM:
    """The reference's parameter pytree -> the family's `LM` on ``device``."""
    dev = resolve_device(device)
    model = MODELS[cfg.family](cfg, device="meta")
    want = dict(model.named_parameters())
    state = {}
    for name, leaf in _flatten(tree):
        arr = np.asarray(leaf, dtype=np.float32)
        prefix = next((p for p in _STACKED if name.startswith(p)), None)
        if prefix is None:
            state[name] = arr
            continue
        pattern, rest = _STACKED[prefix], name[len(prefix):]
        for idx in np.ndindex(arr.shape[:pattern.count("{}")]):
            state[pattern.format(*idx) + rest] = arr[idx]
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
