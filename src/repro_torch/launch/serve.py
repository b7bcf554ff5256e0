"""Serving launcher: batched prefill, then step-synced greedy decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --requests 8 --prefill-len 1000 --decode-steps 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-base \\
        --reduced --device cpu

Ports `repro/launch/serve.py`: the same flags (plus ``--device``), the same
default model (smollm-360m) and the same returned dict.  Every family
serves: the vlm and encdec frontends are the reference's stubs, all-zero
``vision`` / ``frames`` inputs (`stub_extra`); `setup` also takes the
caller's own.  Weights are random, drawn from a seeded `torch.Generator`
at the reference's scales, and the prompts from a seeded numpy generator.
The server runs on the CUDA device with the hand-written kernels
(``use_kernels=True``) unless ``--device`` names another device; on the
CPU the kernels' wrappers take their plain twins.  The result also counts
each kernel's launches in prefill and in decode.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.kernels.common import resolve_device
from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
from repro_torch.kernels.ssd_scan.kernel import chunked_scan_cuda
from repro_torch.models import RuntimeFlags, decode_step, init_params, prefill

__all__ = ["parse_args", "setup", "run", "main", "stub_extra", "Server", "KERNELS"]

SEED = 0
KERNELS = {"chunked_scan_cuda": chunked_scan_cuda,
           "flash_attention_cuda": flash_attention_cuda}


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prefill-len", type=int, default=64)
    ap.add_argument("--decode-steps", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Server:
    cfg: object
    flags: RuntimeFlags
    model: torch.nn.Module
    tokens: torch.Tensor        # [requests, prefill_len] prompts
    max_seq: int
    decode_steps: int
    extra: dict                 # the vlm / encdec frontends' inputs


def stub_extra(cfg, requests: int, device) -> dict:
    """The reference's stubbed frontend inputs: all-zero patch embeddings
    (vlm) or frame embeddings (encdec), f32."""
    if cfg.family == "vlm":
        return {"vision": torch.zeros((requests, cfg.vision_tokens, cfg.vision_dim),
                                      device=device)}
    if cfg.family == "encdec":
        return {"frames": torch.zeros((requests, cfg.enc_frames, cfg.d_model),
                                      device=device)}
    return {}


def setup(args: argparse.Namespace, extra: dict | None = None) -> Server:
    """Config, seeded weights, prompts and the frontends' inputs (``extra``,
    default `stub_extra`) on the device."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    model = init_params(gen, cfg, device=dev)
    rng = np.random.default_rng(SEED)
    tokens = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.requests, args.prefill_len))).to(dev)
    if extra is None:
        extra = stub_extra(cfg, args.requests, dev)
    return Server(cfg=cfg, flags=RuntimeFlags(use_kernels=True), model=model,
                  tokens=tokens,
                  max_seq=args.max_seq or (args.prefill_len + args.decode_steps),
                  decode_steps=args.decode_steps,
                  extra={k: v.to(dev) for k, v in extra.items()})


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def _delta(before: dict[str, int]) -> dict[str, int]:
    return {name: n - before[name] for name, n in _launches().items()}


def run(srv: Server) -> dict:
    """Prefill the prompts, then decode greedily; returns the result dict."""
    cfg, flags, model = srv.cfg, srv.flags, srv.model
    dev = srv.tokens.device
    requests, prefill_len = srv.tokens.shape

    before = _launches()
    t0 = time.perf_counter()
    logits, cache = prefill(model, srv.tokens, cfg, flags, srv.extra,
                            pad_to=srv.max_seq)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    prefill_launches = _delta(before)

    out_tokens = []
    before = _launches()
    t0 = time.perf_counter()
    for _ in range(srv.decode_steps):
        out_tokens.append(tok[:, 0].cpu().numpy())
        logits, cache = decode_step(model, tok, cache, cfg, flags)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
    _sync(dev)
    t_decode = time.perf_counter() - t0

    gen = np.stack(out_tokens, axis=1)
    return {
        "requests": requests,
        "prefill_tokens_per_s": requests * prefill_len / t_prefill,
        "decode_tokens_per_s": requests * srv.decode_steps / t_decode,
        "sample_output": gen[0][:8].tolist(),
        "launches": {"prefill": prefill_launches, "decode": _delta(before)},
        "device": str(dev),
    }


def main(argv=None) -> dict:
    result = run(setup(parse_args(argv)))
    print(result)
    return result


if __name__ == "__main__":
    main()
