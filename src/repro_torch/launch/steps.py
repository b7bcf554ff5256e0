"""Step factories shared by `train.py`, the servers and `dryrun.py`.  Ports
`repro/launch/steps.py`.

Builds ``(step_fn, example_inputs, in_placements, out_placements)`` per
(arch x shape x mesh) cell; the inputs are DTensors on the ``meta`` device
(no allocation), each with its per-device local shape, so the same factory
serves the real launchers and the dry run.

A train step updates the model and its AdamW state in place and returns
the metrics (plain tensors, the global values), where the reference's
jitted step returns new parameters and state beside them.
"""

from __future__ import annotations

import torch

from repro_torch.distributed.sharding import (
    batch_placements,
    batch_spec,
    cache_placements,
    distribute_params,
    full_tensor,
    param_placements,
    place,
    place_cache,
    placements,
    reduce_grads,
)
from repro_torch.models import (
    RuntimeFlags,
    decode_step,
    init_cache,
    init_params,
    prefill,
    train_forward,
)
from repro_torch.optim import adamw_init, adamw_update, clip_by_global_norm, cosine_warmup
from repro_torch.spans import span

from .shapes import ShapeSpec

__all__ = ["abstract_params", "abstract_opt_state", "extra_specs", "make_train_step",
           "make_prefill_step", "make_decode_step", "build_cell", "SPANS"]

# the train step's phases, as profiler spans
SPANS = ("train_step.forward", "train_step.backward", "train_step.clip",
         "train_step.adamw")


def abstract_params(cfg, mesh=None):
    """The model on the ``meta`` device, f32 parameters as the reference
    stores them; nothing is allocated.  On a mesh each parameter is a meta
    DTensor placed by `param_placements` (its local shape per device)."""
    model = init_params(None, cfg, device="meta", param_dtype=torch.float32)
    return model if mesh is None else distribute_params(model, mesh)


def abstract_opt_state(model) -> dict:
    """AdamW's state of ``model``: f32 moments placed as the parameters."""
    return adamw_init(model)


def _extra_shardings(mesh, cfg, batch: int) -> dict:
    """Placements of the frontends' inputs: batch over dp when it divides."""
    spec = batch_spec(mesh, batch, 3)
    return {k: placements(mesh, spec) for k in extra_specs(cfg, batch)}


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
    the step before AdamW increments it, AdamW.  On a mesh each gradient is
reduced once, to its parameter's placements (`sharding.reduce_grads`),
before the clip reads it.  ``batch``: ``tokens``,
    ``labels`` ``[B, S]`` and the frontends' inputs, tensors on the model's
    device.  Metrics: ``loss``, ``nll``, ``aux``, ``ppl``, ``grad_norm``
    (0-d tensors) and ``lr`` (float).  The step switches the model's
    parameters to ``requires_grad`` and leaves no gradient behind.  Its
    phases are profiler spans (`SPANS`, read by `launch/profile.py`)."""

    def train_step(model, opt_state, batch):
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
        with span(SPANS[0]):
            loss, metrics = train_forward(model, batch["tokens"], batch["labels"], cfg,
                                          flags, extra)
        with span(SPANS[1]):
            loss.backward()
            reduce_grads(model)    # each gradient once, to its parameter's placements
        with span(SPANS[2]):
            gnorm = clip_by_global_norm([p.grad for p in model.parameters()], clip_norm)
        step_lr = cosine_warmup(opt_state["step"], lr, warmup, total)
        with span(SPANS[3]):
            adamw_update(model, opt_state, step_lr)
        model.zero_grad(set_to_none=True)
        out = dict(metrics)
        out.update({"loss": loss.detach(), "grad_norm": gnorm})
        out = {k: full_tensor(v) for k, v in out.items()}
        out["lr"] = step_lr
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


def build_cell(cfg, shape: ShapeSpec, mesh, flags: RuntimeFlags):
    """Returns ``(fn, args, in_placements, out_placements)`` for one cell:
    the step and its meta DTensor arguments, with the placements of each
    (the reference's ``in_shardings``; the out placements are those of the
    state a train step updates in place, None elsewhere)."""
    model = abstract_params(cfg, mesh)
    p_plc = param_placements(mesh, model)
    b, s = shape.global_batch, shape.seq_len
    tok_plc = batch_placements(mesh, b)
    tokens = lambda n: place(torch.empty((b, n), dtype=torch.long, device="meta"), mesh,
                             tok_plc)
    x_plc = _extra_shardings(mesh, cfg, b)
    extra = {k: place(v, mesh, x_plc[k]) for k, v in extra_specs(cfg, b).items()}

    if shape.kind == "train":
        opt = abstract_opt_state(model)
        o_plc = {"m": p_plc, "v": p_plc, "step": None}
        batch = {"tokens": tokens(s), "labels": tokens(s), **extra}
        b_plc = {"tokens": tok_plc, "labels": tok_plc, **x_plc}
        fn = make_train_step(cfg, flags)
        return fn, (model, opt, batch), (p_plc, o_plc, b_plc), (p_plc, o_plc, None)

    if shape.kind == "prefill":
        batch = {"tokens": tokens(s), **extra}
        fn = make_prefill_step(cfg, flags, pad_to=s)
        return fn, (model, batch), (p_plc, {"tokens": tok_plc, **x_plc}), None

    # decode: one new token against a seq_len-deep cache
    cache = init_cache(cfg, b, s, device="meta")
    c_plc = cache_placements(mesh, cfg, cache, b)
    fn = make_decode_step(cfg, flags)
    return (fn, (model, tokens(1), place_cache(cache, mesh, cfg, b)),
            (p_plc, tok_plc, c_plc), None)
