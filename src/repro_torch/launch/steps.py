"""Step factories shared by `train.py` and the servers.  Ports
`repro/launch/steps.py` on one device: the reference's shardings,
`abstract_params` and `build_cell` wait for the multi-device slice
(ROADMAP Queue 1, item 4).

A train step updates the model and its AdamW state in place and returns
the metrics, where the reference's jitted step returns new parameters and
state beside them.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.models import RuntimeFlags, decode_step, prefill, train_forward
from repro_torch.optim import adamw_update, clip_by_global_norm, cosine_warmup

__all__ = ["extra_specs", "make_train_step", "make_prefill_step", "make_decode_step",
           "SPANS"]

# the train step's phases, as profiler spans
SPANS = ("train_step.forward", "train_step.backward", "train_step.clip",
         "train_step.adamw")


def extra_specs(cfg, batch: int) -> dict[str, torch.Tensor]:
    """Stubbed modality-frontend inputs (precomputed embeddings) as shapes:
    f32 tensors on the ``meta`` device."""
    if cfg.family == "vlm":
        return {"vision": torch.empty((batch, cfg.vision_tokens, cfg.vision_dim),
                                      device="meta")}
    if cfg.family == "encdec":
        return {"frames": torch.empty((batch, cfg.enc_frames, cfg.d_model),
                                      device="meta")}
    return {}


def make_train_step(cfg, flags: RuntimeFlags, *, lr: float = 3e-4,
                    warmup: int = 100, total: int = 10000, clip_norm: float = 1.0):
    """``train_step(model, opt_state, batch) -> metrics``, the reference's
    order: loss and gradients, clip by global norm, the cosine schedule at
    the step before AdamW increments it, AdamW.  ``batch``: ``tokens``,
    ``labels`` ``[B, S]`` and the frontends' inputs, tensors on the model's
    device.  Metrics: ``loss``, ``nll``, ``aux``, ``ppl``, ``grad_norm``
    (0-d tensors) and ``lr`` (float).  The step switches the model's
    parameters to ``requires_grad`` and leaves no gradient behind.  Its
    phases are profiler spans (`SPANS`, read by `launch/profile.py`)."""

    def train_step(model, opt_state, batch):
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        with record_function(SPANS[0]):
            loss, metrics = train_forward(model, batch["tokens"], batch["labels"], cfg,
                                          flags, extra)
        with record_function(SPANS[1]):
            loss.backward()
        with record_function(SPANS[2]):
            gnorm = clip_by_global_norm([p.grad for p in model.parameters()], clip_norm)
        step_lr = cosine_warmup(opt_state["step"], lr, warmup, total)
        with record_function(SPANS[3]):
            adamw_update(model, opt_state, step_lr)
        model.zero_grad(set_to_none=True)
        out = dict(metrics)
        out.update({"loss": loss.detach(), "grad_norm": gnorm, "lr": step_lr})
        return out

    return train_step


def make_prefill_step(cfg, flags: RuntimeFlags, pad_to: int | None = None):
    def prefill_step(model, batch):
        extra = {k: v for k, v in batch.items() if k != "tokens"}
        return prefill(model, batch["tokens"], cfg, flags, extra, pad_to=pad_to)

    return prefill_step


def make_decode_step(cfg, flags: RuntimeFlags):
    def serve_step(model, token, cache):
        return decode_step(model, token, cache, cfg, flags)

    return serve_step
